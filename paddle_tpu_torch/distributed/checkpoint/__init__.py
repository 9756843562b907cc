"""Checkpoint save/load on one process or over ranks (port of
``paddle_tpu/distributed/checkpoint/``): an owned host snapshot, an async
writer thread with a crash-safe publish, restore by ``copy_`` into the
existing tensors, and the rolling, preemption-aware CheckpointManager.
Over ranks each rank writes its regions of whole leaves and reads its
slice of them under the target layout (``distributed.layout``).
"""
from .manager import CheckpointManager, Preempted
from .save_load import (AsyncSaveHandle, load_manifest, load_sharding_meta,
                        load_state_dict, save_state_dict,
                        wait_all_async_saves)
