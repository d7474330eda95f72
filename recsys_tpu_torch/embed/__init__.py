"""Embedding lookups: replicated and row-sharded (the counterpart of
``recsys_tpu/embed``)."""

from recsys_tpu_torch.embed.table import (
    lookup_replicated,
    make_sharded_lookup_a2a,
    make_sharded_lookup_psum,
)

__all__ = ["lookup_replicated", "make_sharded_lookup_psum", "make_sharded_lookup_a2a"]
