"""End-to-end training driver example on the PyTorch port: train a small
LM with SOFT durable checkpointing and a simulated mid-run crash, then
resume from the last committed checkpoint.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] \
          [--device cpu]
"""
import argparse
import shutil
import tempfile

from repro_torch.launch import train as T


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--arch", default="qwen3-32b-smoke")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    common = ["--arch", args.arch, "--steps", str(args.steps),
              "--ckpt", ckpt, "--save-every", "20", "--device", args.device]
    try:
        print("=== phase 1: train until a simulated power failure ===")
        rc = T.main(common + ["--crash-at", str(args.steps // 2)])
        assert rc == 1
        print("\n=== phase 2: restart -- recovery scan finds the last "
              "committed step, data pipeline reseeks, training resumes ===")
        rc = T.main(common)
        assert rc == 0
    finally:
        shutil.rmtree(ckpt)
    print("\ncrash/restart training round-trip complete.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
