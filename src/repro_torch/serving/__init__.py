"""repro_torch.serving — PyTorch serving substrate with MFS-scheduled
transfers.

    PagedStore / PrefixIndex   — paged KV + content-addressed prefix reuse
    ServingEngine              — prefill / suffix-prefill (B=1)
    DecodeBatch                — slotted continuous-batching decode, one
                                 batched step with per-slot lengths
    DisaggServer               — P/D-disaggregated orchestrator over the
                                 shared MsFlow runtime (§5)
"""
from .paged_kv import (PagedStore, PrefixIndex, PrefixEntry, cache_bytes,
                       cache_has_state, is_token_leaf_path)
from .engine import ServingEngine, DecodeBatch
from .disagg import DisaggServer, DisaggConfig, ServeRequest, ServeResult

__all__ = [
    "PagedStore", "PrefixIndex", "PrefixEntry", "cache_bytes",
    "cache_has_state", "is_token_leaf_path",
    "ServingEngine", "DecodeBatch",
    "DisaggServer", "DisaggConfig", "ServeRequest", "ServeResult",
]
