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
  ``train.update``, beside the dense leaves' Adagrad).

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
