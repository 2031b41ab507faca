"""Durable lock-free sets (link-free / SOFT / log-free) in PyTorch.

Public surface: ``SetSpec`` + ``DurableMap`` (see repro_torch.core.engine),
``ShardedDurableMap`` (repro_torch.core.shard), ``ElasticShardedMap``
(online S -> 2S split and 2S -> S merge, repro_torch.core.resize),
``DurableQueue`` + ``QueueSpec`` (repro_torch.core.queue) and the
sequential oracles ``OracleSet`` / ``OracleQueue``
(repro_torch.core.oracle).  ``DurableSet`` and the string-index functional
wrappers are kept as the JAX package keeps them, a deprecation shim.
"""
from repro_torch.core.nvm import (FREE, INVALID, PAYLOAD, VALID, DELETED,
                                  EMPTY, TOMB, hash32, crash_persisted_stage)
from repro_torch.core.durable_set import (SetState, make_state, insert_batch,
                                          remove_batch, contains_batch, crash,
                                          recover, crash_and_recover, MODES)
from repro_torch.core.engine import (SetSpec, DurableMap, DurableSet,
                                     IndexBackend, BACKENDS, register_backend,
                                     get_backend, apply_batch, OP_CONTAINS,
                                     OP_INSERT, OP_REMOVE, OP_NOP)
from repro_torch.core.convert import state_from_numpy, state_to_numpy
from repro_torch.core.shard import (ShardSpec, ShardedDurableMap, shard_of,
                                   np_shard_of)
from repro_torch.core.router import (PLACEMENTS, adaptive_lane_budget,
                                    budget_candidates, np_storage_rows)
from repro_torch.core.queue import DurableQueue, QueueSpec, QueueState
from repro_torch.core.resize import (ElasticShardedMap, MigrationFrontier,
                                     ResizeCapacityError, split_planes,
                                     merge_planes, reshard_planes)
from repro_torch.core.oracle import OracleSet, OracleQueue
