"""PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper (H100).

Imports torch and never JAX or anything of ``paddle_tpu``. Public entry
points run on the card unless the caller names the CPU; on the CPU each
hand-written kernel is replaced by its plain PyTorch version. Kernels
(``csrc/*.cu``) are built with nvcc on first use (``_build.py``).
"""
from . import envs, observability  # noqa: F401
from .inference import (Admission, AdmissionController, BlockPool,
                        BlockPoolError, EngineJournal, FleetRouter,
                        InferenceEngine,
                        JournalCompatError, PoisonError, PrefixCache,
                        Request, ServeConfig, pad_table, read_journal)
from .models.llama import (LlamaConfig, generate, init_llama_params,
                           init_paged_kv_pool, init_paged_kv_scales,
                           llama_7b, llama_paged_verify_step, llama_tiny,
                           make_draft_model, params_from_numpy)

__all__ = ["envs", "observability", "Admission", "AdmissionController",
           "BlockPool", "BlockPoolError", "EngineJournal", "FleetRouter",
           "InferenceEngine",
           "JournalCompatError", "PoisonError", "PrefixCache", "Request",
           "ServeConfig", "pad_table", "read_journal", "LlamaConfig", "generate",
           "init_llama_params", "init_paged_kv_pool",
           "init_paged_kv_scales", "llama_7b",
           "llama_paged_verify_step", "llama_tiny", "make_draft_model",
           "params_from_numpy"]
