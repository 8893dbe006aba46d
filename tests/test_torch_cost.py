"""``utils/profiler.cost_analysis`` (``utils/cost.py``) on the CPU.

* Its flops equal the JAX package's ``cost_analysis`` (XLA's count of the
  compiled function) exactly for a bias-free linear, a batched einsum
  and a 3x3 convolution, with "SAME" padding (whose padded taps neither
  counts) and "VALID".
* One frame of the tiny model (``tiny_model_cfg`` with quarter-res
  semantic logits, 64x128; extract both frames, ``decode_pair``,
  ``postprocess_frame``: the JAX bench's frame step) counts the same flops
  and bytes on every route that runs on the CPU: the DCN on "jax",
  "pallas" and "pallas_f32", the Retriever on "jax" and "pallas", the
  postprocess on "jax", "fused" and "pallas" (on CPU tensors the kernel
  wrappers run their plain versions, which the branch points hide).  Its
  branch points give their formulas: 24 DCN calls (``cost.dcn_forward``
  of each level and tower block), 8 Retriever cores
  (``cost.slot_attention`` of each stage's level) and the postprocess's
  inputs and outputs.  Counting changes no output, and inference mode
  (where composite ops such as conv2d reach the counter whole) counts as
  much as no_grad.
* One train step of the compact model (32x32, one sample) counts the same
  on the three DCN routes, with 12 ``cost.dcn_backward`` entries.
* The formulas give the byte and operation counts ``chip_smoke.py``'s
  kernel bounds were computed from before they moved here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slotvps_tpu.utils import profiler as jprof
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.cli.dryrun_multichip import dryrun_batch, dryrun_config
from slotvps_tpu_torch.models import detector as tdet
from slotvps_tpu_torch.models.postprocess import postprocess_frame
from slotvps_tpu_torch.training.step import make_optimizer, train_step
from slotvps_tpu_torch.utils import cost
from slotvps_tpu_torch.utils import profiler as tprof
from tests.test_torch_models import tiny_model_cfg

H, W = 64, 128


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conv(pad):
    def jfn(x, k):
        return jax.lax.conv_general_dilated(
            x, k, (1, 1), pad, dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def tfn(x, k):
        return F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                        padding=1 if pad == "SAME" else 0)
    return jfn, tfn, ((2, 10, 12, 8), (3, 3, 8, 6))


PIECES = {
    "linear": (lambda x, w: x @ w, lambda x, w: F.linear(x, w.T),
               ((3, 5, 16), (16, 24))),
    "batched_einsum": (
        lambda a, b: jnp.einsum("bhqd,bhdk->bhqk", a, b),
        lambda a, b: torch.einsum("bhqd,bhdk->bhqk", a, b),
        ((2, 7, 9, 16), (2, 7, 16, 11))),
    "conv3x3_same": _conv("SAME"),
    "conv3x3_valid": _conv("VALID"),
}


@pytest.mark.parametrize("piece", sorted(PIECES))
def test_flops_equal_jax(rng, piece):
    jfn, tfn, shapes = PIECES[piece]
    args = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = jprof.cost_analysis(jfn, *map(jnp.asarray, args))["flops"]
    got = tprof.cost_analysis(tfn, *map(torch.from_numpy, args))
    assert got["flops"] == want
    assert got["bytes_accessed"] > 0


def _frame_cfg(dcn="jax", retriever="jax"):
    cfg = tiny_model_cfg(dcn_impl=dcn, config=tconfig)
    return dataclasses.replace(
        cfg, semantic_head=dataclasses.replace(cfg.semantic_head,
                                               fused_sseg=True),
        slot_head=dataclasses.replace(cfg.slot_head,
                                      retriever_impl=retriever))


@pytest.fixture(scope="module")
def frame():
    model = tdet.init_model(torch.Generator().manual_seed(0), _frame_cfg(),
                            device="cpu")
    g = torch.Generator().manual_seed(1)
    imgs = [torch.randn(1, H, W, 3, generator=g) for _ in range(2)]

    def step(cfg, impl):
        pcfg = dataclasses.replace(tconfig.PostprocessConfig(), impl=impl)
        with torch.no_grad():
            ref, cur = (tdet.extract_features(model, cfg, i) for i in imgs)
            o = tdet.decode_pair(model, cfg, ref, cur)
            return postprocess_frame(o.pred_logits[0], o.pred_masks[0],
                                     o.embeddings[0], o.fcn_output[0],
                                     (H, W), pcfg)

    def counted(dcn, retriever, impl, mode=torch.no_grad):
        with cost.count() as c, mode():
            out = step(_frame_cfg(dcn, retriever), impl)
        return c, out

    plain, plain_out = counted("jax", "jax", "jax")
    return dict(step=step, counted=counted, plain=plain, out=plain_out)


@pytest.mark.parametrize("dcn,retriever,impl,mode", [
    ("pallas", "jax", "jax", torch.no_grad),
    ("pallas_f32", "jax", "jax", torch.no_grad),
    ("jax", "pallas", "jax", torch.no_grad),
    ("jax", "jax", "fused", torch.no_grad),
    ("jax", "jax", "pallas", torch.no_grad),
    ("pallas", "pallas", "fused", torch.no_grad),
    ("pallas", "pallas", "fused", torch.inference_mode)])
def test_frame_count_is_the_same_on_every_route(frame, dcn, retriever,
                                                impl, mode):
    c, _ = frame["counted"](dcn, retriever, impl, mode)
    assert (c.flops, c.bytes_accessed) == (frame["plain"].flops,
                                           frame["plain"].bytes_accessed)
    assert c.entries == frame["plain"].entries


def test_frame_entries_are_their_formulas(frame):
    c, cfg = frame["plain"], _frame_cfg()
    levels = [(H // 2 ** (2 + i), W // 2 ** (2 + i)) for i in range(4)]
    tower = [(256, 256), (256, 128), (128, 128)]
    dcn = [cost.dcn_forward(1, h, w, cin, cout)
           for _ in range(2) for h, w in levels for cin, cout in tower]
    # stage s of the decoder attends level s (coarsest first), each of
    # the pair's frames in turn
    core = [cost.slot_attention(1, cfg.proposal_num, h * w,
                                cfg.slot_head.dh_dim, 4)
            for h, w in levels[::-1] for _ in range(2)]
    names = [n for n, _ in c.entries]
    assert names == ["dcn"] * 24 + ["slot_attention"] * 8 + ["postprocess"]
    assert [w for _, w in c.entries[:24]] == dcn
    assert sorted((w for _, w in c.entries[24:32]),
                  key=lambda w: w.bytes) == sorted(core,
                                                   key=lambda w: w.bytes)
    out = frame["out"]
    k, h, w = cfg.proposal_num, *levels[0]
    inputs = 4 * k * (cfg.slot_head.num_classes + h * w
                      + cfg.slot_head.dh_dim) \
        + 4 * h * w * cfg.semantic_head.num_classes
    assert c.entries[-1][1] == cost.Work(
        bytes=inputs + cost.io_bytes((), out).bytes)
    # counting changes nothing
    again = frame["step"](cfg, "jax")
    for a, b in zip(out, again):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def _train_count(impl):
    base = dryrun_config()
    cfg = dataclasses.replace(base, semantic_head=dataclasses.replace(
        base.semantic_head, dcn_impl=impl))
    model = tdet.init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    with cost.count() as c:
        train_step(model, make_optimizer(model), dryrun_batch(1), cfg,
                   fixed_match=True)
    return c


@pytest.fixture(scope="module")
def plain_train_count():
    return _train_count("jax")


@pytest.mark.parametrize("dcn", ["pallas", "pallas_f32"])
def test_train_step_count_is_the_same_on_every_dcn_route(plain_train_count,
                                                         dcn):
    c, ref = _train_count(dcn), plain_train_count
    assert (c.flops, c.bytes_accessed) == (ref.flops, ref.bytes_accessed)
    assert c.entries == ref.entries


def test_train_step_dcn_backward_entries_are_their_formula(
        plain_train_count):
    backward = [w for n, w in plain_train_count.entries
                if n == "dcn backward"]
    levels = [(32 // 2 ** (2 + i), 32 // 2 ** (2 + i)) for i in range(4)]
    want = [cost.dcn_backward(2, h, w, cin, cout)
            for h, w in levels
            for cin, cout in ((256, 256), (256, 128), (128, 128))]
    assert sorted(backward, key=lambda w: (w.products, w.bytes)) == sorted(
        want, key=lambda w: (w.products, w.bytes))


@pytest.mark.parametrize("size", [2, 4])
def test_formulas_keep_the_kernel_bounds(size):
    """The byte and operation counts ``chip_smoke.py``'s bounds read, as
    it wrote them before they came from ``utils/cost.py``."""
    for b, h, w in ((1, 256, 512), (2, 25, 50)):
        p = b * h * w
        for cin, cout in ((256, 256), (256, 128), (128, 128)):
            fwd = cost.dcn_forward(b, h, w, cin, cout, x_size=size)
            assert (fwd.bytes, fwd.products) == (
                size * (p * (cin + 18 + cout) + 9 * cin * cout),
                2 * 9 * cin * cout * p)
            bwd = cost.dcn_backward(b, h, w, cin, cout, x_size=size)
            assert (bwd.bytes, bwd.products, bwd.gathers) == (
                size * (p * (cin + cout) + 9 * cin * cout)
                + 4 * (p * (cin + 36) + 9 * cin * cout),
                4 * 9 * cin * cout * p, 24 * 9 * cin * p)
    for slots, n_pix in ((100, 131072), (1, 4133)):
        sa = cost.slot_attention(1, slots, n_pix, 256, size)
        assert (sa.bytes, 2 * sa.products, sa.elementwise) == (
            size * (slots + 2 * n_pix) * 256 + 4 * slots * 256,
            4 * 2 * slots * 256 * n_pix, 5 * slots * n_pix)
    k, h, w, t = 64, 256, 512, 32
    hw, full = h * w, 16 * h * w
    up = 3 * 4 * hw + 3 * full
    nv, nt, nkt, ns, owned, dirty = 40, 20, 9, 12, 5000, 0.25
    argmax_ops = ns * (up + 2 * full) + 9 * owned + 4 * full
    old = {
        "theta": (4 * nv * hw + k + 4 * full,
                  nv * (up + 4 * full) + 3 * full),
        "claim": (4 * nt * hw + 4 * full + full + 5 * k,
                  nt * (up + 5 * full) + nkt * 2 * full),
        "argmax": (4 * ns * hw + owned // 4 + full + 4 * full + 4 * t * k
                   + 2 * k, argmax_ops),
        "repair": (dirty * (4 * ns * hw + owned // 4 + full)
                   + (1 - dirty) * 4 * full + 4 * full + 8 * t * k + t
                   + 2 * k, dirty * argmax_ops),
        "sseg": (4 * 19 * hw + 8 * full, 4 * 19 * full + 12 * 19 * hw)}
    new = {"theta": cost.theta(k, h, w, nv),
           "claim": cost.claim(k, h, w, nt, nkt),
           "argmax": cost.argmax(k, h, w, ns, owned, t),
           "repair": cost.repair(k, h, w, ns, owned, t, dirty),
           "sseg": cost.sseg(h, w, 19)}
    for name, work in new.items():
        assert (work.bytes, work.f32_ops) == old[name], name
