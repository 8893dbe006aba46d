"""The weights of a run, made on the card from ``--seed``.

The reference model is built on the meta device, given storage on the
card, and filled from one normal draw of a generator on the card, each
tensor scaled by its rule: 4-D backbone convolutions by He's rule
(``sqrt(2 / fan_in)``), every other weight of two or more axes by
Glorot's (``sqrt(2 / (fan_in + fan_out))``), Swin's relative position
biases by 0.02, the track head's by 0.01; norm scales and running variances 1; biases, running means
and the DCN offset heads 0; ``fg_bn``'s scale 0.1 (the port's inits).  Then
the regime of the configuration file's ``"regime"``: the frozen
``doctor_params``, the Retrievers' q and k LayerNorm scales multiplied by
``retriever_qk_scale``, and ``calibrate_class_head`` on the reference's f32
decode of a probe frame outside the clips (``target_valid`` slots clear the
keep rule).  The port's model is built by the port and loads the same
state dict, so both sides run the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from vpsbench import clips
from vpsbench.reference import calibration, detector as rdet, pipeline
from vpsbench.reference.swin import SwinTransformer, rel_pos_index


def _std(name: str, shape) -> float:
    if name.endswith("rel_pos_bias"):
        return 0.02
    if name.startswith("track_head."):
        return 0.01
    fan_out, fan_in = shape[0], math.prod(shape[1:])
    if len(shape) == 4:
        fan_out *= shape[2] * shape[3]
        if name.startswith("backbone."):
            return math.sqrt(2.0 / fan_in)
    return math.sqrt(2.0 / (fan_in + fan_out))


def _constant(name: str, t: torch.Tensor):
    """The constant a tensor starts at, or None for a random one."""
    if name.endswith("running_var"):
        return 1.0
    if name.endswith(("running_mean", "bias")) or ".offset." in name:
        return 0.0
    if name == "fg_bn.weight":
        return 0.1
    if t.ndim < 2:
        return 1.0
    return None


@torch.no_grad()
def _fill(model: torch.nn.Module, seed: int, device) -> None:
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    random = [(n, t) for n, t in tensors.items()
              if _constant(n, t) is None]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    draw = torch.randn(sum(t.numel() for _, t in random), generator=gen,
                       device=device)
    at = 0
    for name, t in random:
        n = t.numel()
        t.copy_(draw[at:at + n].view(t.shape) * _std(name, t.shape))
        at += n
    for name, t in tensors.items():
        c = _constant(name, t)
        if c is not None:
            t.fill_(c)


def reference_model(ref_cfg, seed: int, device) -> rdet.Detector:
    """The reference's model of ``ref_cfg.model`` with the seed's weights
    (before the regime)."""
    with torch.device("meta"):
        model = rdet.Detector(torch.Generator(), ref_cfg.model)
    model = model.to_empty(device=device).eval()
    for m in model.modules():
        if isinstance(m, SwinTransformer):
            m.rel_index = rel_pos_index(m.cfg.window_size).to(device)
    _fill(model, seed, device)
    return model


@torch.no_grad()
def apply_regime(model: rdet.Detector, ref_cfg, regime: Dict, seed: int,
                 size: Tuple[int, int], device) -> Dict:
    """Doctor, soften the Retrievers and calibrate the class head in
    place; returns the calibration's record."""
    gen = torch.Generator().manual_seed(int(seed) % (1 << 63))
    calibration.doctor_params(model, gen, **regime["doctor"])
    scale = regime["retriever_qk_scale"]
    for name, mod in model.named_modules():
        if name.endswith(("inst_interact.norm_q", "inst_interact.norm_k")):
            mod.weight.mul_(scale)
    probe = clips.probe_frame(seed, *size, device)
    img = pipeline.normalize(probe, ref_cfg.data)
    feats = rdet.extract_features(model, ref_cfg.model, img)
    logits = rdet.decode_pair(model, ref_cfg.model, feats,
                              feats).pred_logits[0]
    _, info = calibration.calibrate_class_head(
        model, logits, gen, target_valid=regime["target_valid"],
        threshold=ref_cfg.model.postprocess.threshold)
    return info


def port_model(port_cfg, state: Dict[str, torch.Tensor], device):
    """The port's model of ``port_cfg.model``, built by the port and
    loaded with ``state``."""
    from slotvps_tpu_torch.models.detector import init_model

    model = init_model(torch.Generator().manual_seed(0), port_cfg.model,
                       device=device)
    model.load_state_dict(state, strict=True)
    return model
