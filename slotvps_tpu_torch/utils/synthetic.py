"""Synthetic multi-object scenes and the trained-regime overfit recipe
(counterpart of ``slotvps_tpu/utils/synthetic.py``).

A scene of colored things on a layered stuff background, rendered at any
resolution, its translating video, and a TrainBatch for one (frame, ref)
pair of it: the training data of ``chip_smoke.py``'s train phase and of
the CPU tests, with no dataset on disk.  ``overfit`` trains a random-init
model on one such batch until its slots look like a trained checkpoint's
(confident, differentiated): the JAX package's recipe of per-step BN
calibration, weight-norm caps, FPN gain pinning and two learning-rate
groups, each clipped by its own norm.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

# Cityscapes 19-class ids: stuff 0..10, things 11..18
_STUFF_LAYERS = (
    (10, 0.00, 0.25, (70, 130, 180)),   # sky
    (2, 0.25, 0.55, (70, 70, 70)),      # building
    (0, 0.55, 1.00, (128, 64, 128)),    # road
)
_THING_CLASSES = (11, 12, 13, 14, 15, 16, 17, 18)

# the data pipeline's normalization (data/pipeline.py; reference
# img_norm_cfg) — images render as BGR uint8 like cv2.imread output
_MEAN = np.asarray((123.675, 116.28, 103.53), np.float32)
_STD = np.asarray((58.395, 57.12, 57.375), np.float32)


class Scene(NamedTuple):
    img: np.ndarray        # [H, W, 3] uint8 (BGR)
    masks: np.ndarray      # [G, H, W] uint8 — thing masks then stuff masks
    labels: np.ndarray     # [G] int32
    is_thing: np.ndarray   # [G] bool
    semantic: np.ndarray   # [H, W] uint8 (19-class ids)


def norm_img(img: np.ndarray) -> np.ndarray:
    """BGR uint8 -> normalized RGB float32 [1, H, W, 3] (the exact
    transform of data/pipeline.preprocess)."""
    return ((img[..., ::-1].astype(np.float32) - _MEAN) / _STD)[None]


def make_scene(h: int, w: int, n_things: int = 12, seed: int = 0) -> Scene:
    """Render a layered stuff background + ``n_things`` colored ellipses
    placed on a jittered grid (non-overlapping by construction)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.uint8)
    semantic = np.zeros((h, w), np.uint8)
    stuff_masks = []
    for cls, top, bot, color in _STUFF_LAYERS:
        m = np.zeros((h, w), np.uint8)
        m[int(top * h):int(bot * h)] = 1
        img[m > 0] = color
        semantic[m > 0] = cls
        stuff_masks.append(m)

    cols = int(np.ceil(np.sqrt(n_things * w / h)))
    rows = int(np.ceil(n_things / cols))
    ch, cw = h // rows, w // cols
    yy, xx = np.mgrid[0:h, 0:w]
    thing_masks, thing_labels = [], []
    for i in range(n_things):
        r, c = divmod(i, cols)
        ry = ch * 0.18 * rng.uniform(0.7, 1.3)
        rx = cw * 0.22 * rng.uniform(0.7, 1.3)
        cy = r * ch + ch / 2 + rng.uniform(-0.12, 0.12) * ch
        cx = c * cw + cw / 2 + rng.uniform(-0.12, 0.12) * cw
        m = ((((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0) \
            .astype(np.uint8)
        cls = _THING_CLASSES[i % len(_THING_CLASSES)]
        # distinct saturated color per instance
        hue = (i * 360 / n_things) % 360
        color = _hsv_bgr(hue, 0.85, 0.9)
        img[m > 0] = color
        semantic[m > 0] = cls
        thing_masks.append(m)
        thing_labels.append(cls)
    # stuff masks exclude thing pixels (panoptic semantics)
    things_any = np.clip(sum(thing_masks), 0, 1).astype(np.uint8)
    stuff_masks = [m * (1 - things_any) for m in stuff_masks]

    masks = np.stack(thing_masks + stuff_masks)
    labels = np.asarray(thing_labels + [c for c, *_ in _STUFF_LAYERS],
                        np.int32)
    is_thing = np.asarray([True] * n_things + [False] * len(stuff_masks))
    return Scene(img, masks, labels, is_thing, semantic)


def _hsv_bgr(hue: float, s: float, v: float) -> Tuple[int, int, int]:
    c = v * s
    x = c * (1 - abs((hue / 60.0) % 2 - 1))
    m = v - c
    r, g, b = [(c, x, 0), (x, c, 0), (0, c, x),
               (0, x, c), (x, 0, c), (c, 0, x)][int(hue // 60) % 6]
    return (int((b + m) * 255), int((g + m) * 255), int((r + m) * 255))


def scene_frames(scene: Scene, n_frames: int, shift: int = 16
                 ) -> List[np.ndarray]:
    """Video of the scene translating ``shift`` px/frame (wrap-around) —
    normalized [1, H, W, 3] frames ready for extract_features."""
    return [norm_img(np.roll(scene.img, t * shift, axis=1))
            for t in range(n_frames)]


def scene_train_batch(scene: Scene, shift: int = 16, g_cap: int = 20):
    """TrainBatch (CPU tensors) for one (frame, ref) pair of the
    translating scene.

    GT masks/semantic at quarter resolution (TrainBatch contract);
    ``gt_pids`` = 1-based identity for things (the ref frame holds the
    same objects), 0 (new/none) for stuff, matching the reference's
    track-target grammar (cityscapes_vps.py:246-248)."""
    from slotvps_tpu_torch.training.step import make_train_batch

    h, w = scene.img.shape[:2]
    g = len(scene.labels)
    assert g <= g_cap, (g, g_cap)
    q = lambda m: m[::4, ::4].astype(np.float32)

    ref_img = np.roll(scene.img, -shift, axis=1)
    gt_masks = np.zeros((1, g_cap, h // 4, w // 4), np.float32)
    ref_masks = np.zeros((1, g_cap, h // 4, w // 4), np.float32)
    labels = np.zeros((1, g_cap), np.int32)
    valid = np.zeros((1, g_cap), bool)
    pids = np.zeros((1, g_cap), np.int32)
    for i in range(g):
        gt_masks[0, i] = q(scene.masks[i])
        ref_masks[0, i] = q(np.roll(scene.masks[i], -shift, axis=1))
        labels[0, i] = scene.labels[i]
        valid[0, i] = True
        if scene.is_thing[i]:
            pids[0, i] = i + 1
    semantic = scene.semantic[::4, ::4].astype(np.int32)[None]

    return make_train_batch(
        img=norm_img(scene.img), ref_img=norm_img(ref_img),
        gt_labels=labels, gt_masks=gt_masks, gt_valid=valid,
        gt_semantic=semantic, ref_gt_labels=labels, ref_gt_masks=ref_masks,
        ref_gt_valid=valid, gt_pids=pids)


# the score- and kernel-bearing heads that stay free of the norm caps and
# train at head_lr_mult * lr, as substrings of a parameter's name (the
# JAX package's tree paths joined with dots, utils/convert.py): class
# logits, the sseg predictor, the dynamic-mask kernel generators, the
# track embedder, and the whole slot decoder (LayerNorm-wrapped
# throughout; capping it collapses every slot to one score in the JAX
# package's runs)
_CAP_FREE = ("class_logits", "conv_pred", "reg_module", "track_head",
             "slot_head.stages")


def _cap_free(name: str) -> bool:
    return any(f in name for f in _CAP_FREE)


def cap_map(model: torch.nn.Module, zero_cap: float = 0.007
            ) -> Dict[str, Optional[float]]:
    """Parameter name -> its norm cap, None where it is free: the
    Frobenius norm at call time of a parameter of rank >= 2, ``zero_cap``
    where that norm is 0 (the zero-init DCN offset convs); free below rank
    2 and in ``_CAP_FREE``.  The norm does not depend on layout, so the
    port's OIHW weights get the JAX package's HWIO caps."""
    caps = {}
    for name, p in model.named_parameters():
        if p.ndim < 2 or _cap_free(name):
            caps[name] = None
        else:
            n = float(torch.linalg.vector_norm(p.detach().float()))
            caps[name] = n if n > 0.0 else zero_cap
    return caps


def _norm_cap_fn(model: torch.nn.Module, zero_cap: float = 0.007
                 ) -> Callable[[torch.nn.Module], torch.nn.Module]:
    """Per-step weight renormalization for the random-init overfit (the
    JAX package's ``_norm_cap_fn``): returns ``renorm(model)``, which
    scales each capped parameter (``cap_map``, taken now) in place by
    ``min(1, cap / max(||w||, 1e-12))``.  With GroupNorm / LayerNorm after
    most convs the loss is blind to their scale, and AdamW's
    constant-magnitude updates would inflate them step after step; the cap
    pins the magnitude and lets the direction train.  A few multi-tensor
    launches, no host sync."""
    caps = cap_map(model, zero_cap)
    names = [n for n, c in caps.items() if c is not None]
    params = dict(model.named_parameters())
    limit = torch.tensor([caps[n] for n in names],
                         device=params[names[0]].device)

    @torch.no_grad()
    def renorm(m: torch.nn.Module) -> torch.nn.Module:
        ps = dict(m.named_parameters())
        ws = [ps[n] for n in names]
        norms = torch.stack(torch._foreach_norm(ws))
        scale = torch.clamp(limit / torch.clamp(norms, min=1e-12), max=1.0)
        torch._foreach_mul_(ws, list(scale.unbind()))
        return m

    return renorm


def _fpn_gain_fix(cfg_model, sample: torch.Tensor
                  ) -> Callable[[torch.nn.Module], torch.nn.Module]:
    """Per-step FPN output-scale pinning for the random-init overfit (the
    JAX package's ``_fpn_gain_fix``): returns ``fix(model)``, which
    measures the RMS of the first ``len(model.fpn.fpn)`` FPN outputs of
    ``sample`` (the backbone and the FPN alone, no autograd) and rescales
    each level's output conv (weight and bias; the output is linear in
    both) back to the RMS the first call recorded.  Every FPN consumer but
    the semantic tower's DCN offset convs is scale-invariant, so this
    pins the one scale those offset heads see.  The first call only
    records."""
    state: Dict[str, List[float]] = {}

    @torch.no_grad()
    def measure(model) -> List[float]:
        feats = model.backbone(sample)
        outs = model.fpn(feats, num_outs=cfg_model.fpn.num_outs)
        n = len(model.fpn.fpn)
        return torch.stack([torch.sqrt(torch.mean(torch.square(
            outs[lvl].float()))) for lvl in range(n)]).tolist()

    @torch.no_grad()
    def fix(model):
        rms = measure(model)
        if "init" not in state:
            state["init"] = rms
            return model
        for lvl, (r0, r) in enumerate(zip(state["init"], rms)):
            g = r0 / max(r, 1e-12)
            conv = model.fpn.fpn[lvl]
            conv.weight.mul_(g)
            if conv.bias is not None:
                conv.bias.mul_(g)
        return model

    return fix


# the overfit's probe: every PROBE_EVERY steps from min(PROBE_FROM, steps)
# on
PROBE_EVERY, PROBE_FROM = 20, 100


def _cosine_decay(lr: float, decay_steps: int, alpha: float = 0.05):
    """optax.cosine_decay_schedule(lr, decay_steps, alpha): count ->
    lr * ((1 - alpha) * (1 + cos(pi * min(count, steps) / steps)) / 2 +
    alpha)."""
    def schedule(count):
        t = min(count, decay_steps) / decay_steps
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t))
                     + alpha)
    return schedule


def _grouped_optimizer(model: torch.nn.Module, lr: float,
                       head_lr_mult: float, decay_steps: int = 0):
    """The JAX package's ``_grouped_optimizer``: two disjoint AdamW groups,
    each ``chain(clip_by_global_norm(1.0), adamw(lr, weight_decay=1e-4))``
    over its own parameters, so each clips by its own norm (the JAX
    package's ``optax.masked`` pair): the norm-capped trunk at ``lr`` and
    the ``_CAP_FREE`` heads at ``head_lr_mult * lr``, each with its own
    cosine decay to 5 % over ``decay_steps`` (none at 0).  The frozen BN
    statistics are buffers and get no update.  Returns an object with
    ``zero_grad`` and ``step`` (what ``train_step`` calls) and ``groups``,
    "trunk" and "head" to their parameter names."""
    from slotvps_tpu_torch.training.step import AdamW

    groups = {"trunk": [], "head": []}
    params = dict(model.named_parameters())
    for name in params:
        groups["head" if _cap_free(name) else "trunk"].append(name)
    opts = []
    for g, group_lr in (("trunk", lr), ("head", lr * head_lr_mult)):
        sched = (_cosine_decay(group_lr, decay_steps) if decay_steps
                 else group_lr)
        opts.append(AdamW([params[n] for n in groups[g]], lr=sched,
                          weight_decay=1e-4, clip_norm=1.0))

    def zero_grad():
        for opt in opts:
            opt.zero_grad()

    def step():
        for opt in opts:
            opt.step()

    return SimpleNamespace(groups=groups, zero_grad=zero_grad, step=step)


@torch.no_grad()
def calibrate_fg_bn(model, cfg_model, img: torch.Tensor, scale: float):
    """Set ``fg_bn`` so that the mask logits of ``img`` decoded against
    itself come out centred with standard deviation ``scale``: its running
    statistics to the mean and variance of the raw slot-map products, its
    weight to ``scale``, its bias to 0.

    At the reference init (weight 0.1, identity statistics) the mask
    logits of a random-init model have a standard deviation of ~0.006
    (the slot embeddings meet L2-normalized features), so every sigmoid
    mask is ~0.5 everywhere, and AdamW moves the weight by ~lr a step: too
    slowly for a few hundred steps.  A trained checkpoint's fg_bn is sharp
    (cf. ``utils/calibration.doctor_params``)."""
    from slotvps_tpu_torch.models.detector import (decode_pair,
                                                   extract_features)

    bn = model.fg_bn
    f = extract_features(model, cfg_model, img)
    masks = decode_pair(model, cfg_model, f, f).pred_masks.float()
    gain = bn.weight[0] * torch.rsqrt(bn.running_var[0] + 1e-5)
    raw = (masks - (bn.bias[0] - bn.running_mean[0] * gain)) / gain
    var, mean = torch.var_mean(raw, correction=0)
    bn.running_mean.fill_(float(mean))
    bn.running_var.fill_(float(var))
    bn.weight.fill_(scale)
    bn.bias.zero_()
    return model


def overfit(cfg_model, batch, steps: int = 300, lr: float = 2e-3,
            seed: int = 0, log_every: int = 0, head_lr_mult: float = 1.0,
            query_scale: float = 1.0, device="cuda",
            state_dict: Optional[Dict[str, torch.Tensor]] = None,
            fg_scale: Optional[float] = None):
    """Overfit a model on one TrainBatch; returns the model (on
    ``device``, the card unless the caller asks for the CPU) holding the
    best probed state (the JAX package's ``overfit``).

    The model starts from ``init_model(seed)`` or from ``state_dict``
    (e.g. the JAX package's init carried across by ``from_jax_params``).
    In order: ``init_mask_query`` scaled by ``query_scale`` (sharper
    initial retrieval breaks the slots' symmetry); a ResNet backbone's BN
    statistics calibrated on ``[ref_img; img]`` with the replay check;
    with ``fg_scale`` (the port's option; the JAX package's recipe has
    none), ``calibrate_fg_bn`` on ``img``; then each step a ``train_step``
    with ``fixed_match``, the norm caps, the BN calibration again (ResNet)
    and the FPN gain fix.  Every 20 steps (``PROBE_EVERY``) from
    ``min(100, steps)`` (``PROBE_FROM``) on, a probe decodes the current
    frame against itself (no autograd) and scores ``min(#slots with a
    non-background class above 0.85, #GT) + mean across-slot score
    std``; the best scoring state is kept as a
    detached copy (the parameters change in place) and loaded at the
    end.  ``model.probe`` is the best probe's ``{"step",
    "confident_slots", "slot_std"}``, None when no probe fired."""
    from slotvps_tpu_torch.models.detector import (decode_pair,
                                                   extract_features,
                                                   init_model)
    from slotvps_tpu_torch.models.resnet import calibrate_bn_stats
    from slotvps_tpu_torch.training.step import train_step

    model = init_model(torch.Generator().manual_seed(seed), cfg_model,
                       device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    batch = batch.to(device)
    if query_scale != 1.0:
        with torch.no_grad():
            model.init_mask_query.mul_(query_scale)
    recal = None
    if cfg_model.backbone == "resnet":
        both = torch.cat([batch.ref_img, batch.img], dim=0)

        def recal(check=False):
            calibrate_bn_stats(model.backbone, both, check=check)

        recal(check=True)
    if fg_scale is not None:
        calibrate_fg_bn(model, cfg_model, batch.img, fg_scale)
    opt = _grouped_optimizer(model, lr, head_lr_mult, decay_steps=steps)
    renorm = _norm_cap_fn(model)
    fpn_fix = _fpn_gain_fix(cfg_model, batch.img)
    fpn_fix(model)   # record the initial per-level RMS
    g_valid = int(batch.gt_valid.sum())

    @torch.no_grad()
    def sat_probe():
        f = extract_features(model, cfg_model, batch.img)
        o = decode_pair(model, cfg_model, f, f)
        sc = torch.softmax(o.pred_logits[0].float(), dim=-1)
        smax = sc[:, :-1].max(-1).values   # without the no-object class
        return (int((smax > 0.85).sum()),
                float(sc.std(dim=0, correction=0).mean()))

    best_score, best_state, best_probe = -1.0, None, None
    for i in range(steps):
        metrics = train_step(model, opt, batch, cfg_model, fixed_match=True)
        renorm(model)
        if recal is not None:
            recal()
        fpn_fix(model)
        if (i + 1) % PROBE_EVERY == 0 \
                and (i + 1) >= min(PROBE_FROM, steps):
            n_conf, std = sat_probe()
            score = float(min(n_conf, g_valid)) + std
            if score > best_score:
                best_score = score
                best_state = {k: v.detach().clone()
                              for k, v in model.state_dict().items()}
                best_probe = dict(step=i + 1, confident_slots=n_conf,
                                  slot_std=std)
                if log_every:
                    print(f"# overfit best @ step {i + 1}: {n_conf} "
                          f"confident slots, slot-std {std:.4f}",
                          flush=True)
        if log_every and (i == 0 or (i + 1) % log_every == 0):
            print(f"# overfit step {i + 1}/{steps} "
                  f"loss={float(metrics['loss_total']):.3f}", flush=True)
    if best_state is not None:
        model.load_state_dict(best_state)
    model.probe = best_probe
    return model
