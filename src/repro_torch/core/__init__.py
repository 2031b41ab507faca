"""Durable lock-free sets (link-free / SOFT / log-free) in PyTorch.

Public surface: ``SetSpec`` + ``DurableMap`` (see repro_torch.core.engine).
"""
from repro_torch.core.nvm import (FREE, INVALID, PAYLOAD, VALID, DELETED,
                                  EMPTY, TOMB, hash32, crash_persisted_stage)
from repro_torch.core.durable_set import SetState, MODES, crash
from repro_torch.core.engine import (SetSpec, DurableMap, IndexBackend,
                                     BACKENDS, register_backend, get_backend,
                                     apply_batch, OP_CONTAINS, OP_INSERT,
                                     OP_REMOVE, OP_NOP)
from repro_torch.core.convert import state_from_numpy, state_to_numpy
