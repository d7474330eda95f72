"""Replica-desync checks for the data-parallel trainer and the NaN switch
of ``TrainConfig.debug_nans`` (the counterpart of ``recsys_tpu/utils/debug.py``).

Every data-parallel rank holds the whole params and ends each step with
the same bits: the gradients come from one all-reduce, which hands every
rank the same sum, and every update after it is the same arithmetic on
the same inputs. A bad collective, a per-rank RNG leak or a rank-local
reduction in another order breaks that silently. These helpers make it
visible:

* :func:`per_device_checksums`: each rank checksums its own copy of a
  tree, and the checksums of every rank are gathered to every rank;
* :func:`assert_replicated`: raises ``RuntimeError`` when they differ.

Under row-sharded tables the shards are meant to differ from rank to
rank: the callers name them in ``skip`` and the checks cover the other
leaves, as the JAX package's ``per_device_checksums`` covers only the
leaves whose sharding is replicated.

Two checksums per rank, as in the JAX package: an fp32 magnitude sum
(sum |x| + sum x over every leaf, for the log; one flipped low bit
vanishes in it) and the detector, an XOR fold of every fp32 leaf's bit
pattern, which any changed bit changes.

**NaN checks** (:func:`enable_nan_checks`, the port's ``jax_debug_nans``):
a process-wide switch. While it is on, each kernel wrapper
(:func:`kernel_nan_check`) checks its outputs at its one launch point, on
the card and on the CPU's plain branch alike, and raises
``FloatingPointError("invalid value (nan) encountered in <kernel>")``; the
trainer checks each step's loss, gradients and updated params in one
reduction (the wrappers stay quiet inside :func:`deferred_nan_checks`) and,
on a NaN, re-runs the step under :func:`locate_nan`, which checks the
outputs of every aten op that computes (data movement passes NaNs on and is
not named) and of every kernel, and names the first. As in JAX, only NaN
is checked, not infinities.
"""

from __future__ import annotations

import contextlib
import functools
import re
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from recsys_tpu_torch.parallel.mesh import MeshContext


def _leaves(tree: Any, skip: Sequence[str] = ()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            if k not in skip:
                yield from _leaves(tree[k], skip)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, skip)
    elif isinstance(tree, torch.Tensor):
        yield tree.detach()


def _tree_checksum(tree: Any, skip: Sequence[str] = ()) -> float:
    """The fp32 magnitude checksum: sum |x| + sum x over every leaf."""
    total = torch.zeros((), dtype=torch.float32)
    for leaf in _leaves(tree, skip):
        x = leaf.float()
        total = total + (torch.sum(torch.abs(x)) + torch.sum(x)).cpu()
    return float(total)


def _tree_bit_checksum(tree: Any, skip: Sequence[str] = ()) -> int:
    """The XOR fold of every leaf's bit pattern as uint32 (floats as fp32)."""
    total = np.uint32(0)
    for leaf in _leaves(tree, skip):
        if leaf.is_floating_point():
            bits = leaf.float().cpu().numpy().view(np.uint32)
        else:
            bits = leaf.cpu().numpy().astype(np.uint32)
        total ^= np.bitwise_xor.reduce(bits.ravel(), initial=np.uint32(0))
    return int(total)


def per_device_checksums(tree: Any, ctx: MeshContext, skip: Sequence[str] = ()
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (magnitude checksums [world] fp64, bit checksums [world] int64),
    one per rank of the process group, in rank order, on every rank, over
    the leaves of ``tree`` whose key is not in ``skip`` (the row-sharded
    tables). A collective: every rank calls it with its own copy of
    ``tree``."""
    mine = torch.tensor([_tree_checksum(tree, skip), float(_tree_bit_checksum(tree, skip))],
                        dtype=torch.float64, device=ctx.device)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    out = torch.stack(parts).cpu().numpy()
    return out[:, 0], out[:, 1].astype(np.int64)


def assert_replicated(tree: Any, ctx: MeshContext, rtol: float = 1e-6,
                      skip: Sequence[str] = ()) -> np.ndarray:
    """Raise ``RuntimeError`` when the ranks' copies of ``tree`` (less the
    leaves named in ``skip``) are not bitwise equal (the XOR checksums
    differ), or, as a second check, when their magnitude checksums differ
    beyond ``rtol``. -> the magnitude checksums, for the log."""
    sums, bits = per_device_checksums(tree, ctx, skip)
    if np.any(bits != bits[0]):
        raise RuntimeError(
            f"replica desync detected: per-rank bit checksums "
            f"{[hex(int(b)) for b in bits]} differ: nominally replicated state is not "
            f"bitwise identical across the mesh's ranks (magnitude "
            f"checksums {sums.tolist()})")
    tol = rtol * max(abs(float(sums[0])), 1.0)
    if np.any(np.abs(sums - sums[0]) > tol):
        raise RuntimeError(
            f"replica desync detected: per-rank checksums {sums.tolist()} (tolerance "
            f"{tol:.3g}): nominally replicated state differs across the mesh's ranks")
    return sums


# ---- NaN checks (TrainConfig.debug_nans) -----------------------------------

_NAN_CHECKS = False
_DEFERRED = 0      # inside a train step that checks once, at its end
_IN_KERNEL = 0     # inside a kernel wrapper: its plain version is one op
_LOCATOR: Optional["_NanLocator"] = None
# aten ops that move values without computing any: a NaN passes through
# them and is named where it is computed (``empty``'s are uninitialised)
_MOVES = frozenset((
    "alias", "as_strided", "cat", "clone", "constant_pad_nd", "contiguous", "copy", "copy_",
    "detach", "embedding", "empty", "empty_like", "empty_strided", "expand", "flatten",
    "gather", "index", "index_put", "index_put_", "index_select", "lift_fresh", "narrow",
    "new_empty", "new_empty_strided", "permute", "repeat", "repeat_interleave", "reshape",
    "select", "slice", "split", "split_with_sizes", "squeeze", "stack", "t", "transpose",
    "unbind", "unsqueeze", "view", "_to_copy", "_unsafe_view"))


def enable_nan_checks() -> None:
    """Turn the process-wide NaN checks on (``jax_debug_nans``)."""
    global _NAN_CHECKS
    _NAN_CHECKS = True


def disable_nan_checks() -> None:
    """Turn them off again (the JAX package never does; tests do)."""
    global _NAN_CHECKS
    _NAN_CHECKS = False


def nan_checks_enabled() -> bool:
    return _NAN_CHECKS


def nan_message(what: str) -> str:
    return f"invalid value (nan) encountered in {what}"


def _has_nan(out) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()
               and bool(torch.isnan(t).any()) for t in tree_leaves(out))


def _found(what: str) -> None:
    """A NaN came out of ``what``: raise, or, under a collective
    :func:`locate_nan`, note it if it is the first."""
    node = torch._C._current_autograd_node()
    if node is not None:
        what = f"{what} (in the backward of {node.name()})"
    if _LOCATOR is not None and not _LOCATOR.raise_now:
        _LOCATOR.first = _LOCATOR.first or what
        return
    raise FloatingPointError(nan_message(what))


@contextlib.contextmanager
def deferred_nan_checks() -> Iterator[None]:
    """The kernel wrappers check nothing inside: the caller checks once."""
    global _DEFERRED
    _DEFERRED += 1
    try:
        yield
    finally:
        _DEFERRED -= 1


def kernel_nan_check(name: str) -> Callable:
    """Decorate a kernel wrapper: while the checks are on (and not
    deferred), a NaN among its floating outputs raises naming ``name``. Its
    body (the launch, or the plain version on the CPU) counts as one op to
    :func:`locate_nan`, so both branches name the same thing."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            global _IN_KERNEL
            if not _NAN_CHECKS or _DEFERRED:
                return fn(*args, **kwargs)
            _IN_KERNEL += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                _IN_KERNEL -= 1
            if _has_nan(out):
                _found(name)
            return out

        return run

    return wrap


class _NanLocator(TorchDispatchMode):
    """Checks the floating outputs of every aten op that computes."""

    def __init__(self, raise_now: bool):
        super().__init__()
        self.raise_now = raise_now
        self.first: Optional[str] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (not _IN_KERNEL and self.first is None and not func.is_view
                and func.overloadpacket.__name__ not in _MOVES and _has_nan(out)):
            _found(str(func))
        return out


def locate_nan(fn: Callable[[], Any], collective: bool = False) -> Optional[str]:
    """Run ``fn`` with every computing aten op's and every kernel's outputs
    checked. Without ``collective``: raise ``FloatingPointError`` at the
    first NaN, the backward under ``torch.autograd.detect_anomaly``, which
    names the ``autograd.Function`` whose gradient is NaN; -> None when
    ``fn`` made none. With it (``fn`` runs collectives that every rank must
    finish): run ``fn`` to its end and -> the name of the first, or None."""
    global _LOCATOR
    prev, _LOCATOR = _LOCATOR, _NanLocator(raise_now=not collective)
    anomaly = (contextlib.nullcontext() if collective
               else torch.autograd.detect_anomaly(check_nan=True))
    try:
        with _LOCATOR, anomaly:
            fn()
    except RuntimeError as e:  # anomaly mode's "Function 'X' returned nan values ..."
        m = re.search(r"Function '(\w+)' returned nan", str(e))
        if m is None:
            raise
        raise FloatingPointError(nan_message(m.group(1))) from e
    finally:
        first, _LOCATOR = _LOCATOR.first, prev
    return first
