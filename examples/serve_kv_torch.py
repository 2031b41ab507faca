"""Serving example on the PyTorch port: batched generation + the durable
request registry (crash-safe completion tracking via a SOFT DurableMap on
the bucket backend, i.e. the ``hash_probe`` lookup / ``recovery_scan``
recovery kernels on the GPU).

Run:  PYTHONPATH=src python examples/serve_kv_torch.py [--device cpu]
"""
import argparse

from repro_torch.launch import serve as S


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU)")
    dev = ap.parse_args(argv).device
    return S.main(["--arch", "qwen3-32b-smoke", "--requests", "8",
                   "--prompt-len", "32", "--gen", "16", "--crash",
                   "--backend", "bucket", "--device", dev])


if __name__ == "__main__":
    raise SystemExit(main())
