"""Named profiler ranges at the program's layer boundaries.

:func:`span` opens a function-scope range of ``torch.profiler``. The
profiler links each device kernel to the innermost function-scope range
open on the thread that launched it, so a kernel launched through ctypes
inside a span (the port's CUDA kernels) is put down to that span as an
aten kernel is. A ``record_function`` annotation is a user-scope range,
which such kernels never link to.

The train step's spans nest in time, the autograd thread's inside the
caller's ``train.backward``:

* ``train.step``: one step of ``Trainer._step_core`` (dense or sparse),
  on every path that calls it: the epoch, the chunk and the streaming loop;
* ``train.forward``: ``MultiTaskModel.loss`` (and the sparse step's gather
  of its virtual rows, and ``lookup_overflow`` where it is counted);
* ``loss.retrieval``: the retrieval softmax's forward, on every route;
* ``train.backward``: autograd over the step's leaves;
* ``loss.retrieval_bwd``: ``FlashSoftmaxCE.backward`` (the flash route's
  kernels and label terms; the other routes' backward is
  ``train.backward``'s own);
* ``train.exchange``: the step's collectives under a mesh (the gradients'
  all-reduce and gathers, the cache's gather, the metrics' mean);
* ``train.update``: the optimizer (the sparse step's combine, clip, dense
  optimizer and touched-rows update);
* ``train.cache_update``: the CBNS cache's FIFO, when the cache is on;
* DLRM-DCNv2's step (``Trainer._step_core_dlrm``): ``embed.bag`` around
  the bags' pooled forward (inside ``train.forward``), ``dlrm.cross``
  around the low-rank cross layers' forward, and ``embed.bag_bwd`` around
  the bags' backward with the rows' combine and row-wise Adagrad (inside
  ``train.update``, beside the dense leaves' Adagrad);
* HSTU's step (``Trainer._step_core_seq``): ``hstu.attn`` around each
  block's attention forward (kernel row 11 and its operands' bf16 copy,
  inside ``train.forward``), ``loss.sampled`` around the sampled
  softmax's forward (row 13's logits and the sort of its entries), and
  ``hstu.attn_bwd`` around each block's attention backward (row 12, on
  the autograd thread inside ``train.backward``). The step's metrics
  count its events and causal pairs on the device.
* MLA-MoE's step (``Trainer._step_core_seq``): ``mla.attn`` around
  each layer's attention forward (RoPE, the operands' assembly and kernel
  row 14, inside ``train.forward``), ``moe.route`` around each MoE layer's
  router, top-k, sort, offsets and balance loss, ``moe.experts`` around
  the routed experts' forward (the dispatch's gather, row 16's products,
  SwiGLU and the combine), ``loss.sampled`` as HSTU's, and on the
  autograd thread ``mla.attn_bwd`` (row 15) and ``moe.experts_bwd`` (the
  recomputed forward, row 16's four backward products, the transposes and
  the combine's backward). The step's metrics count on the device its
  events, causal pairs, the (token, expert) pairs on this card's experts
  summed over the MoE layers and the busiest held expert's tokens.

A span records nothing unless a profiler is running, and changes no
result. Names are fixed strings: no shape is formatted into them.
"""

from __future__ import annotations

import torch

_FAST = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def span(name: str):
    """A context manager: the range ``name`` while a profiler runs.

    Where this torch has no ``_RecordFunctionFast`` it falls back to
    ``torch.profiler.record_function``, a user-scope range to which the
    profiler links no kernel launched through ctypes."""
    if _FAST is not None:
        return _FAST(name)
    return torch.profiler.record_function(name)
