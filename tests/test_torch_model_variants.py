"""Port parity of the rest of the per-frame model configuration, against
the JAX package on the CPU: the GCNet context block, the ResNet stage
plugins (DCN, GCNet) and the R52 deep stem, and the learned position
embedding.

* The context block within 1e-5 of max (f32, sums in another order), with
  its zero-initialized last conv made nonzero.
* An R50 with the R52 stem and the DCN and GCNet plugins on stages 2-4
  (the chip's ``plugins`` configuration), offset heads and context blocks
  made nonzero (fractional offsets of up to 1.5 px, inside the halo of 8),
  at a 32x64 image: every output level within 1e-4 of max.  The BN sites
  in the JAX package's ``_iter_bns`` order (the R52 stem's bn2 / bn3 after
  bn1), and ``calibrate_bn_stats``'s replay holds on this backbone.
* ``convert_torchvision_resnet`` reads the R52 stem as the JAX converter
  does, leaf for leaf.
* The learned embedding equal to the JAX function at sizes up to the 50
  bins, through the detector's ``_position_embeddings``; above 50 bins
  the JAX package fails and the port raises ``ValueError``.
* The trainer refuses the Swin backbone (``loss_fn`` and the train CLI).

The JAX trees take the port's values (tests/test_torch_swin.py
``jax_params_of``: no JAX init compile).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotvps_tpu.models import context_block as jcb
from slotvps_tpu.models import detector as jdet
from slotvps_tpu.models import resnet as jres
from slotvps_tpu.utils import checkpoint as jckpt
from slotvps_tpu_torch import config as tconfig
from slotvps_tpu_torch.models import context_block as tcb
from slotvps_tpu_torch.models import detector as tdet
from slotvps_tpu_torch.models import resnet as tres
from slotvps_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_checkpoint import _resnet_sd
from tests.test_torch_models import tiny_model_cfg
from tests.test_torch_swin import jax_params_of

PLUGINS = dict(dcn_stages=(False, True, True, True),
               gcb_stages=(False, True, True, True), r52_stem=True)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch at one thread: the small CPU work stays fast beside the other
    test workers.  The worker's own count is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_close(a, b, rtol):
    b = np.asarray(b)
    err = np.abs(a.detach().numpy() - b).max()
    assert err <= rtol * np.abs(b).max(), (a.shape, err)


def test_context_block_matches_jax():
    gen = torch.Generator().manual_seed(0)
    block = tcb.init_context_block(gen, 64)
    with torch.no_grad():
        block.channel_add.conv2.weight.normal_(0.0, 0.2, generator=gen)
    p = jax_params_of(block, lambda k: jcb.init_context_block(k, 64))
    x = np.random.default_rng(0).standard_normal((2, 6, 10, 64)).astype(
        np.float32)
    ref = jax.jit(jcb.apply_context_block)(p, jnp.asarray(x))
    with torch.no_grad():
        ours = block(torch.from_numpy(x))
    assert not np.allclose(np.asarray(ref), x)
    _rel_close(ours, ref, 1e-5)


@pytest.fixture(scope="module")
def plugin_pair():
    """(JAX backbone tree, the port's R52 + DCN + GCNet R50 holding it)."""
    gen = torch.Generator().manual_seed(0)
    backbone = tres.init_resnet(gen, 50, **PLUGINS)
    with torch.no_grad():
        for blk in (b for si in range(1, 5)
                    for b in getattr(backbone, f"layer{si}")):
            if blk.conv2_offset is not None:
                blk.conv2_offset.weight.normal_(0.0, 1e-3, generator=gen)
                blk.conv2_offset.bias.uniform_(-1.5, 1.5, generator=gen)
            if blk.gcb is not None:
                blk.gcb.channel_add.conv2.weight.normal_(0.0, 0.05,
                                                         generator=gen)
    params = jax_params_of(backbone, lambda k: jres.init_resnet(
        k, 50, **PLUGINS))
    return params, backbone


def test_plugin_backbone_matches_jax(plugin_pair):
    params, backbone = plugin_pair
    # the random-init R50 amplifies its input ~1000x with identity BN
    # statistics and is linear in it apart from the context blocks'
    # softmax: a 1e-3-scale image keeps the outputs at unit scale
    img = 1e-3 * np.random.default_rng(3).standard_normal(
        (1, 32, 64, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: jres.apply_resnet(p, x, depth=50))(
        params, jnp.asarray(img))
    with torch.no_grad():
        ours = backbone(torch.from_numpy(img))
    assert [tuple(a.shape) for a in ours] == [
        (1, 8, 16, 256), (1, 4, 8, 512), (1, 2, 4, 1024), (1, 1, 2, 2048)]
    for a, b in zip(ours, ref):
        _rel_close(a, b, 1e-4)


def test_plugin_backbone_bn_order_and_calibration(plugin_pair):
    """``iter_bns`` yields the sites in ``_iter_bns``'s order (each site's
    running mean marked with its index on the JAX side), and
    ``calibrate_bn_stats`` (its replay check on) runs on this backbone."""
    params = jax.tree.map(np.array, plugin_pair[0])
    backbone = copy.deepcopy(plugin_pair[1])
    jsites = list(jres._iter_bns(params, 50))
    for i, p in enumerate(jsites):
        p["mean"] = np.full_like(p["mean"], i)
    sites = list(tres.iter_bns(backbone))
    assert len(sites) == len(jsites) == 3 + 3 * 16 + 4
    with torch.no_grad():
        for bn, p in zip(sites, jsites):
            bn.running_mean.copy_(torch.from_numpy(p["mean"]))
    state = backbone.state_dict()
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    for path, leaf in flat.items():
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[-1] == "mean":
            name = ".".join(keys[:-1] + ["running_mean"])
            np.testing.assert_array_equal(state[name].numpy(), leaf,
                                          err_msg=name)
    x = np.random.default_rng(4).standard_normal((2, 32, 64, 3)).astype(
        np.float32)
    tres.calibrate_bn_stats(backbone, torch.from_numpy(x), check=True)
    assert float(backbone.bn3.running_var.min()) > 0


def test_convert_r52_stem_matches_jax(plugin_pair):
    """The R52 stem's conv2 / bn2 / conv3 / bn3 come out of
    ``convert_torchvision_resnet`` as the JAX converter reads them (the
    plugins have no checkpoint keys in either converter)."""
    params, _ = plugin_pair
    plain = {k: v for k, v in params.items() if not k.startswith("layer")}
    plain.update({f"layer{si}": [
        {k: v for k, v in bp.items() if k not in ("conv2_offset", "gcb")}
        for bp in params[f"layer{si}"]] for si in range(1, 5)})
    sd = _resnet_sd(plain)
    for k in ("conv2", "conv3"):
        sd[f"{k}.weight"] = np.asarray(plain[k]["w"]).transpose(3, 2, 0, 1)
    for k in ("bn2", "bn3"):
        for leaf, key in (("scale", "weight"), ("bias", "bias"),
                          ("mean", "running_mean"), ("var", "running_var")):
            sd[f"{k}.{key}"] = np.asarray(plain[k][leaf])
    want = jckpt.convert_torchvision_resnet(sd, 50)
    got = tckpt.convert_torchvision_resnet(sd, 50)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    assert {"conv2", "bn2", "conv3", "bn3"} <= set(got)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(flat_g[path], np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_learned_position_embedding_matches_jax():
    cfg = dataclasses.replace(tiny_model_cfg(), pos_embedding="learned")
    tcfg = dataclasses.replace(tiny_model_cfg(config=tconfig),
                               pos_embedding="learned")
    model = tdet.init_model(torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    params = jax_params_of(model, lambda k: jdet.init_model(k, cfg))
    assert params["pos_embed"]["row_embed"].shape == (50, 128)
    shapes = [(2, 4), (8, 16), (50, 50), (37, 3)]
    feats = [np.zeros((1, h, w, 128), np.float32) for h, w in shapes]
    ref = jdet._position_embeddings(cfg, [jnp.asarray(f) for f in feats],
                                    params)
    with torch.no_grad():
        ours = tdet._position_embeddings(
            model, tcfg, [torch.from_numpy(f) for f in feats])
    for a, b, (h, w) in zip(ours, ref, shapes):
        assert a.shape == (h, w, 256)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for h, w in ((51, 8), (8, 64)):
        with pytest.raises((ValueError, TypeError)):
            jdet._position_embeddings(cfg, [jnp.zeros((1, h, w, 128))],
                                      params)
        with pytest.raises(ValueError, match="50 bins"):
            model.pos_embed(h, w)


def test_trainer_takes_swin(tmp_path):
    """The trainer takes the Swin backbone (the train step itself is held
    against the JAX package in tests/test_torch_swin_train.py) and still
    refuses bf16 compute, which no JAX entry point trains in."""
    from slotvps_tpu_torch.cli import train as train_cli
    from slotvps_tpu_torch.training.step import check_trainable, loss_fn

    cfg = tconfig.named_config("swinl_fpn_slotvps").model
    check_trainable(cfg)
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="float32"):
        check_trainable(bf16)
    with pytest.raises(NotImplementedError, match="float32"):
        loss_fn(None, bf16, None)
    # the CLI gets past the check to the dataset, which is missing here
    with pytest.raises(FileNotFoundError):
        train_cli.main(["--config", "swinl_fpn_slotvps", "--device", "cpu",
                        "--work_dir", str(tmp_path / "w"), "--ann_file",
                        str(tmp_path / "none.json"), "--img_prefix",
                        str(tmp_path)])
    assert (tmp_path / "w").is_dir()
    # the ResNet configurations of the chip's plugins phase train
    check_trainable(dataclasses.replace(
        tconfig.ModelConfig(), resnet=tconfig.ResNetConfig(**PLUGINS)))
