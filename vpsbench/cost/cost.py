"""The work of the port's kernels, and the count of one call's work.

Formulas.  Each kernel's work is written here once, as a :class:`Work` of
the shapes (and, for the postprocess kernels, of the counts their data
gives): the bytes it must move (each input read once, each output written
once), the flops of its matrix products, of its bilinear sampling, and
its other operations.  ``chip_smoke.py`` takes its bounds from these, and
:func:`count` (``utils/profiler.cost_analysis``) counts them at the
kernels' branch points.

Counting.  :func:`count` runs a function eagerly under a dispatch-level
counter, the way XLA's cost analysis counts the HLOs of a compiled one:
the matrix products, convolutions and attention count the flops that
``torch.utils.flop_counter.FlopCounterMode``'s formulas give (2 M N K, as
XLA counts a dot; a convolution's taps that fall in its zero padding are
not counted, as XLA does not count them; the mode itself is not used: its
module tracker hooks every module call), every other aten op counts no
flop; each aten op that is not a view adds the bytes of its tensor
operands and results (XLA's per-HLO rule).  At a branch point, where the
kernel route and its plain version part (:func:`entry`,
:func:`entry_with_backward`), the count is the function's own work from
its formula, the same for either route, and nothing inside is counted:
the plain DCN's gathers and the plain postprocess's [H, W, K] stack are
the plain version's way, not the function's work.  The branch points are
the DCN of the semantic tower (``semantic_head.DCNBlock``, forward and
backward), the Retriever's slot-attention core (``slot_head``) and
``postprocess_frame`` (its fused kernels and its reference path compute
one function by different algorithms, so the count is taken around the
whole of it).  One count runs at a time in a process: the branch points
find it in a module variable, which the autograd engine's threads see
too.

Where it departs from the JAX package.  Its ``pl.CostEstimate``s count the
TPU kernels' own way: the DCN forward's flops include the one-hot matrix
products that gather its samples (``ksub // 3`` columns of 2 flops a
(pixel, tap, input channel); here, the four bilinear corners: 8) and its
bytes the padded halo windows; the backward adds three one-hot products;
slot attention counts the pixels padded to its tile.  Here the count is
of the function (native gathers need no one-hot product), so the port's
flops and bytes are lower where the TPU kernel's detour or padding adds
work.  The postprocess counts its inputs and outputs alone (XLA would
count each HLO of the JAX package's loops once).

Frozen copy of ``slotvps_tpu_torch/utils/cost.py`` at commit
86b90feb98325982c750f329cf213fa73d0ed5b3: the benchmark's
yardstick for flops and the kernels' least times.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten


@dataclasses.dataclass(frozen=True)
class Work:
    """One function's work.  ``bytes``: each input read once, each output
    written once.  ``products``: 2 flops a multiply-add of its matrix
    products (what a kernel runs on the tensor cores).  ``gathers``: 2
    flops a multiply-add of its bilinear samples and their scatter (the
    CUDA cores).  ``elementwise``: its other operations (compares,
    selects, sums, a softmax's max, subtract, exp and divide)."""

    bytes: float = 0
    products: float = 0
    gathers: float = 0
    elementwise: float = 0

    @property
    def flops(self) -> float:
        """What the count reports: the products, as XLA counts a dot."""
        return self.products + self.gathers

    @property
    def f32_ops(self) -> float:
        """The work on the CUDA cores' f32 pipes."""
        return self.gathers + self.elementwise


# ---------------------------------------------------------------------------
# formulas
# ---------------------------------------------------------------------------


def dcn_forward(b, h, w, cin, cout, x_size=4, off_size=None, w_size=None,
                out_size=None) -> Work:
    """Deformable conv forward, [B, H, W, Cin] -> [B, H, W, Cout], 3x3.

    x, the 18 offsets a pixel and the [9, Cin, Cout] weight read once, the
    output written once (sizes in bytes; each defaults to ``x_size``).
    Per pixel and tap, a sample of each input channel is the weighted sum
    of four corners (4 multiply-adds: 8 flops a (pixel, tap, input
    channel)), and the product of the 9 Cin samples with the weight is
    2 * 9 * Cin * Cout flops a pixel."""
    p = b * h * w
    off_size = off_size or x_size
    w_size = w_size or x_size
    out_size = out_size or x_size
    return Work(bytes=p * (cin * x_size + 18 * off_size + cout * out_size)
                + 9 * cin * cout * w_size,
                products=2 * 9 * cin * cout * p,
                gathers=8 * 9 * cin * p)


def dcn_backward(b, h, w, cin, cout, x_size=4, w_size=None, g_size=None,
                 off_size=4, grad_size=4) -> Work:
    """Deformable conv backward: dx, doffset and dW from x, the offsets,
    the weight and the output's gradient g.

    x, W and g read once (``x_size``, ``w_size``, ``g_size``), the offsets
    read and their gradient written (``off_size``), dx and dW written
    (``grad_size``).  The data product (the samples' gradient, g W^T) and
    the dW product (samples^T g) are each 2 * 9 * Cin * Cout flops a
    pixel; per (pixel, tap, input channel) the samples are taken again
    (8 flops), their gradient is scattered to the four corners of dx
    (8) and the offsets' gradient sums the corners' differences (8)."""
    p = b * h * w
    w_size = w_size or x_size
    g_size = g_size or x_size
    return Work(bytes=p * (cin * x_size + cout * g_size + 36 * off_size
                           + cin * grad_size)
                + 9 * cin * cout * (w_size + grad_size),
                products=4 * 9 * cin * cout * p,
                gathers=24 * 9 * cin * p)


def slot_attention(b, n_slots, n_pix, c, in_size, out_size=4) -> Work:
    """The Retriever's core, out[l] = sum_p softmax over l (q[l] . k[p])
    v[p]: q [B, L, C], k and v [B, P, C] read once, the f32 output
    [B, L, C] written once; q . k and p . v 2 * L * P * C flops each; the
    softmax over slots 5 operations a (slot, pixel), one an
    exponential."""
    return Work(bytes=in_size * b * (n_slots + 2 * n_pix) * c
                + out_size * b * n_slots * c,
                products=4 * b * n_slots * n_pix * c,
                elementwise=5 * b * n_slots * n_pix)


def _upsample_ops(h, w):
    """One slot's x4 upsample of an [h, w] plane, separable: 3 flops per
    row-phase value and 3 per column-phase value."""
    return 3 * 4 * h * w + 3 * 16 * h * w


def theta(k, h, w, n_valid) -> Work:
    """The per-pixel threshold on the logsumexp over valid slots, f32
    masks [K, h, w] at a x4 target: the valid slots' masks read and the
    [4h, 4w] f32 threshold written; per valid slot its upsample and a max,
    subtract, exp and add a full-res pixel, per pixel a log and two
    adds."""
    full = 16 * h * w
    return Work(bytes=4 * n_valid * h * w + k + 4 * full,
                elementwise=n_valid * (_upsample_ops(h, w) + 4 * full)
                + 3 * full)


def claim(k, h, w, n_things, n_kept_things) -> Work:
    """The greedy claim loop over the valid things: their masks and the
    threshold read, the int8 owner map written; per thing its upsample, a
    compare with the threshold, a count and the owner and class tests a
    pixel; per kept thing its claim (2 a pixel)."""
    full = 16 * h * w
    return Work(bytes=4 * n_things * h * w + 4 * full + full + 5 * k,
                elementwise=n_things * (_upsample_ops(h, w) + 5 * full)
                + n_kept_things * 2 * full)


def argmax(k, h, w, n_stuff, owned, tiles) -> Work:
    """The masked argmax with per-tile areas over the kept stuff slots and,
    under the ``owned`` full-res pixels a kept thing owns, that thing: the
    stuff masks, the owned pixels' thing values (one low-res value for 4
    pixels) and the owner map read, the int32 map and the [tiles, K]
    areas written; per stuff slot its upsample, a compare and a select a
    pixel; per owned pixel an upsample (~6), a compare and a select; per
    pixel the owner test, the 0.0 and -1e30 candidates and its count."""
    full = 16 * h * w
    return Work(bytes=4 * n_stuff * h * w + owned // 4 + full + 4 * full
                + 4 * tiles * k + 2 * k,
                elementwise=n_stuff * (_upsample_ops(h, w) + 2 * full)
                + 9 * owned + 4 * full)


def repair(k, h, w, n_stuff, owned, tiles, dirty_frac) -> Work:
    """One small-area iteration: :func:`argmax` on the dirty row tiles,
    the clean tiles' map copied through, the areas read and written."""
    full = 16 * h * w
    a = argmax(k, h, w, n_stuff, owned, tiles)
    return Work(bytes=dirty_frac * (4 * n_stuff * h * w + owned // 4 + full)
                + (1 - dirty_frac) * 4 * full + 4 * full + 8 * tiles * k
                + tiles + 2 * k,
                elementwise=dirty_frac * a.elementwise)


def sseg(h, w, c) -> Work:
    """The semantic map from quarter-res f32 logits [h, w, C]: the logits
    read once, the int64 [4h, 4w] map written; per full-res pixel and
    channel a column phase (3 flops) and a compare, per quarter-res value
    four row phases (3 flops each)."""
    full = 16 * h * w
    return Work(bytes=4 * c * h * w + 8 * full,
                elementwise=4 * c * full + 12 * c * h * w)


def io_bytes(args, out) -> Work:
    """A function's inputs read once and its outputs written once: the
    bytes of every tensor among ``args`` and ``out``."""
    return Work(bytes=sum(t.nbytes for t in tree_leaves((args, out))
                          if isinstance(t, torch.Tensor)))


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _taps(n_in, n_out, k, stride, pad, dil):
    """(output position, kernel tap) pairs of one axis whose input lies
    inside [0, n_in)."""
    return sum(1 for o in range(n_out) for t in range(k)
               if 0 <= o * stride - pad + t * dil < n_in)


def _conv_flops(x_shape, w_shape, bias, stride, padding, dilation,
                transposed, *args, out_shape=None, **kwargs) -> int:
    """2 flops a multiply-add of a convolution, taps in the padding not
    counted (XLA's rule); a transposed one as torch counts it."""
    from torch.utils.flop_counter import conv_flop_count

    if transposed:
        return conv_flop_count(x_shape, w_shape, out_shape, transposed=True)
    n = 2 * x_shape[0] * w_shape[0] * w_shape[1]
    for d in range(2, len(x_shape)):
        i = d - 2
        n *= _taps(x_shape[d], out_shape[d], w_shape[d], stride[i],
                   padding[i], dilation[i])
    return n


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, bias, stride,
                         padding, dilation, transposed, output_padding,
                         groups, output_mask, out_shape=None,
                         **kwargs) -> int:
    """The input's and the weight's gradients: each the forward's
    multiply-adds once more."""
    fwd = _conv_flops(x_shape, w_shape, None, stride, padding, dilation,
                      transposed, out_shape=grad_out_shape)
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


def _flop_formulas():
    """aten op -> flops of one call: ``torch.utils.flop_counter``'s
    formulas (those ``FlopCounterMode`` counts by), its convolutions by
    :func:`_conv_flops`."""
    from torch.utils.flop_counter import flop_registry, shape_wrapper

    return {**flop_registry,
            aten.convolution: shape_wrapper(_conv_flops),
            aten._convolution: shape_wrapper(_conv_flops),
            aten.convolution_backward: shape_wrapper(_conv_backward_flops)}


def _is_view(func) -> bool:
    """An op whose result aliases its input (``_unsafe_view`` does, though
    its schema says otherwise)."""
    if func.overloadpacket is aten._unsafe_view:
        return True
    returns = func._schema.returns
    return bool(returns) and returns[0].alias_info is not None \
        and not returns[0].alias_info.is_write


class Count:
    """The flops and bytes of what ran since :func:`count` began, and the
    work of each branch point crossed (``entries``: (name, Work))."""

    def __init__(self):
        self.formulas = _flop_formulas()
        self.op_flops = 0.0
        self.op_bytes = 0.0
        self.entries: List[Tuple[str, Work]] = []
        self.depth = 0

    @property
    def flops(self) -> float:
        return self.op_flops + sum(w.flops for _, w in self.entries)

    @property
    def bytes_accessed(self) -> float:
        return self.op_bytes + sum(w.bytes for _, w in self.entries)

    @contextlib.contextmanager
    def inside(self):
        """Nothing that runs in here is counted."""
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1


class _Counting(TorchDispatchMode):
    """Each aten op's flops (its formula, if it has one) and, unless it is
    a view, the bytes of its tensor operands and results."""

    def __init__(self, counter: Count):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # a composite op (conv2d, linear, matmul...) reaches the mode whole
        # where autograd is off (inference mode): count its parts, as with
        # autograd on, so the count does not depend on the grad mode
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        c = self.counter
        if c.depth == 0:
            formula = c.formulas.get(func.overloadpacket)
            if formula is not None:
                c.op_flops += formula(*args, **kwargs, out_val=out)
            if not _is_view(func):
                c.op_bytes += sum(
                    t.nbytes for t in tree_leaves((args, kwargs, out))
                    if isinstance(t, torch.Tensor))
        return out


_active: Optional[Count] = None


@contextlib.contextmanager
def count():
    """Count what runs inside: yields the :class:`Count`."""
    global _active
    if _active is not None:
        raise RuntimeError("cost.count does not nest")
    c = Count()
    _active = c
    try:
        with _Counting(c):
            yield c
    finally:
        _active = None


def _counting() -> Optional[Count]:
    """The count a branch point should add to, or None (no count, or
    inside another branch point)."""
    return _active if _active is not None and _active.depth == 0 else None


def entry(name: str, work_of: Callable[..., Work]):
    """Decorate a branch point: under :func:`count` the call adds
    ``work_of(*args, out=result, **kwargs)`` and nothing that runs inside
    it; otherwise it runs as it is."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            c = _counting()
            if c is None:
                return fn(*args, **kwargs)
            with c.inside():
                out = fn(*args, **kwargs)
            c.entries.append((name, work_of(*args, out=out, **kwargs)))
            return out
        return wrapped
    return deco


class _CountedOp(torch.autograd.Function):
    """A branch point with a gradient: the forward and, later, the backward
    each run uncounted and add their formula."""

    @staticmethod
    def forward(ctx, fn, name, bwd_work, *inputs):
        c = _active
        ctx.name, ctx.bwd = name, bwd_work
        with c.inside(), torch.enable_grad():
            ctx.leaves = [t.detach().requires_grad_(t.requires_grad)
                          for t in inputs]
            ctx.out = fn(*ctx.leaves)
        return ctx.out.detach()

    @staticmethod
    def backward(ctx, g):
        c = _counting()
        need = [t for t in ctx.leaves if t.requires_grad]
        with c.inside() if c else contextlib.nullcontext():
            got = iter(torch.autograd.grad(ctx.out, need, g))
        if c:
            c.entries.append((ctx.name + " backward", ctx.bwd))
        return (None, None, None,
                *(next(got) if t.requires_grad else None
                  for t in ctx.leaves))


def entry_with_backward(name: str, fn: Callable,
                        works_of: Callable[..., Tuple[Work, Work]],
                        *inputs):
    """``fn(*inputs)`` (one tensor out) as a branch point whose gradient is
    a branch point too: under :func:`count` the forward adds the first
    Work of ``works_of(*inputs)`` and the backward the second, and nothing
    that runs inside either; otherwise ``fn(*inputs)`` as it is."""
    c = _counting()
    if c is None:
        return fn(*inputs)
    fwd_work, bwd_work = works_of(*inputs)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in inputs)):
        with c.inside():
            out = fn(*inputs)
    else:
        out = _CountedOp.apply(fn, name, bwd_work, *inputs)
    c.entries.append((name, fwd_work))
    return out
