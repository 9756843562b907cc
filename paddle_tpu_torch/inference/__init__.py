"""Paged continuous-batching serving on the card (port of
``paddle_tpu/inference``'s serving engine)."""
from .engine import (Admission, AdmissionController, InferenceEngine,
                     PoisonError, Request, ServeConfig)
from .fleet import FleetRouter
from .journal import EngineJournal, JournalCompatError, read_journal
from .kv_cache import BlockPool, BlockPoolError, PrefixCache, pad_table

__all__ = ["BlockPool", "BlockPoolError", "PrefixCache", "pad_table",
           "InferenceEngine", "Request", "ServeConfig", "Admission",
           "AdmissionController", "PoisonError", "EngineJournal",
           "JournalCompatError", "read_journal", "FleetRouter"]
