"""Hopper slot-attention kernel: library and wrapper.

``csrc/slot_attention.cu`` is built and loaded by :class:`KernelLibrary`
(``ops/cuda/build.py``).  :func:`slot_attention_hopper` has the signature
of its plain version, :func:`slotvps_tpu_torch.ops.slot_attention.
slot_attention`.  On CPU tensors it runs the plain version; on CUDA tensors
it launches the kernel or raises — there is no fallback.  Its contract on
the card: q [B, L, 256] with 1 <= L <= 128, k and v [B, P, 256], all bf16
(``sa_forward_bf16``, tensor cores) or all f32 (``sa_forward_f32``,
split-TF32 products on the tensor cores); it returns f32 [B, L, 256].
Other L or C raise: every named config has 100 slots and 256 channels
(the JAX kernel pads any L and C).  The launch geometry is
:func:`sa_grid` (bf16) and :func:`sa_f32_grid` (f32).
"""

from __future__ import annotations

import ctypes

import torch

from slotvps_tpu_torch.ops.cuda.build import KernelLibrary
from slotvps_tpu_torch.ops.slot_attention import slot_attention

MAX_SLOTS = 128
CHANNELS = 256
TILE_PIXELS = 64      # pixels per tile of pass 1 (TP of the source)


def sa_grid(b: int, n_pix: int, n_sm: int) -> tuple:
    """Pass 1's grid (G, 2, B): G runs of 64-pixel tiles, each taken by two
    blocks (one per half of the channels), so that G*2 blocks about fill a
    card of ``n_sm`` SMs for one image.  G is a function of P and the card
    only: the partial sums, and so the result, of an image are the same
    alone and in a batch."""
    n_tiles = -(-n_pix // TILE_PIXELS)
    return (min(n_tiles, max(1, n_sm // 2)), 2, b)


def sa_f32_grid(b: int, n_pix: int, n_sm: int) -> tuple:
    """The f32 pass 1's grid (G, 1, B): G runs of 64-pixel tiles, one block
    a run over all 256 channels (its scores computed once), G about one
    block an SM for one image.  Like :func:`sa_grid`, a function of P and
    the card only."""
    n_tiles = -(-n_pix // TILE_PIXELS)
    return (min(n_tiles, max(1, n_sm)), 1, b)


def _declare(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sa_forward_bf16.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.sa_forward_bf16.restype = i
    lib.sa_forward_f32.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.sa_forward_f32.restype = i
    lib.sa_smem_bytes.argtypes = [i]
    lib.sa_smem_bytes.restype = i
    lib.sa_f32_smem_bytes.argtypes = [i]
    lib.sa_f32_smem_bytes.restype = i
    lib.sa_error_string.argtypes = [i]
    lib.sa_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("slot_attention", _declare)
# the kernel entry of each input dtype
ENTRIES = {torch.bfloat16: "sa_forward_bf16", torch.float32: "sa_forward_f32"}


def f32_slots(n_slots: int) -> int:
    """The f32 kernel's padded slot count (NQ, a multiple of 8: its
    instances take L <= 64, <= 104 and <= 128)."""
    return 64 if n_slots <= 64 else 104 if n_slots <= 104 else 128


def f32_smem(nq: int) -> int:
    """Dynamic shared memory of the f32 pass 1 at NQ padded slots
    (``SaF32<NQ>``): the ring of q chunks (hi and lo parts of 32 channels,
    NQ rows) and k chunks (32 channels of a 64-pixel tile), 4, 3 or 2
    stages at NQ = 64, 104, 128; the v tile (64 pixels x 256 channels);
    p's two parts [NQ x 64]; the two warpgroups' row max and row sum; the
    barriers; 1024 bytes of alignment."""
    stages = {64: 4, 104: 3, 128: 2}[nq]
    stage = 2 * nq * 32 * 4 + TILE_PIXELS * 32 * 4
    body = (stages * stage + TILE_PIXELS * CHANNELS * 4
            + 2 * TILE_PIXELS * nq * 4 + 4 * TILE_PIXELS * 4)
    return 1024 + body + (2 * stages + 2) * 8


def f32_scratch_floats(b: int, n_slots: int, n_runs: int) -> int:
    """The f32 entry's scratch in floats: the partial sums [B, G, L, 256],
    then q's split image [B, 8 chunks, hi and lo, NQ, 32]."""
    return b * n_slots * CHANNELS * n_runs + b * 8 * 2 * f32_slots(
        n_slots) * 32


def slot_attention_hopper(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """out [B, L, C] f32 = sum_p softmax over the L slots (q . k_p) v_p.

    Each call on the card launches the kernel of q, k and v's dtype (bf16
    or f32; mixed dtypes raise), its two passes (partial sums over pixel
    runs, then their sum in a fixed order), and adds one to its count:
    ``slot_attention_hopper.launches`` for bf16, ``f32_launches`` for
    f32."""
    tensors = (q, k, v)
    if all(t.device.type == "cpu" for t in tensors):
        return slot_attention(q, k, v)
    if q.dtype not in ENTRIES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError("slot_attention_hopper takes q, k and v all bfloat16 "
                        "or all float32 on the card, got "
                        f"{[str(t.dtype) for t in tensors]}")
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("slot_attention_hopper: q, k and v must all lie on "
                         "one CUDA device (or all on the CPU)")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("slot_attention_hopper takes contiguous, 16-byte "
                         "aligned tensors")
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, n_slots, c = q.shape
    n_pix = k.shape[1]
    if k.shape[0] != b or k.shape[2] != c:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if c != CHANNELS or not 1 <= n_slots <= MAX_SLOTS or n_pix < 1:
        raise ValueError(f"slot_attention_hopper takes C = {CHANNELS}, "
                         f"1 <= L <= {MAX_SLOTS} and P >= 1; got C = {c}, "
                         f"L = {n_slots}, P = {n_pix}")

    lib = LIBRARY.load()
    grid = sa_f32_grid if q.dtype == torch.float32 else sa_grid
    n_runs = grid(
        b, n_pix,
        torch.cuda.get_device_properties(dev).multi_processor_count)[0]
    out = torch.empty((b, n_slots, c), dtype=torch.float32, device=dev)
    n_part = (f32_scratch_floats(b, n_slots, n_runs)
              if q.dtype == torch.float32 else b * n_runs * n_slots * c)
    part = torch.empty((n_part,), dtype=torch.float32, device=dev)
    entry = ENTRIES[q.dtype]
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), part.data_ptr(), b, n_slots,
                                 n_pix, n_runs,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           + lib.sa_error_string(rc).decode())
    if q.dtype == torch.float32:
        slot_attention_hopper.f32_launches += 1
    else:
        slot_attention_hopper.launches += 1
    return out


slot_attention_hopper.launches = 0
slot_attention_hopper.f32_launches = 0
