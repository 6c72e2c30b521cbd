"""Checkpoint ingestion in the port against the JAX package's on the CPU:
`strip_prefixes`; a ViT checkpoint in each reference format (timm names,
MoCo v3's `module.base_encoder.` with its projector, MAE's `{'model': ...}`
with its decoder, MoCo's ConvStem `nn.Sequential` with BatchNorm
statistics, MAE's `fc_norm`), a torchvision ResNet-50 and a timm AugReg
.npz, each written to a temporary directory from the port's own init and
loaded by the JAX package's loader and by the port's: the same counts and
the same outputs within 2e-4; a shape mismatch raises in both; the pooled
forward at 64 and 256 px; the reference-signature facade; `cli.convert`
against the JAX conversion table, and its output loading to the same
weights. The ViTs are narrow (2 blocks of 64, 2 heads), the ResNet-50
models one block a stage (the checkpoint a full body), float32."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssl4gie_tpu.models.resnet as jresnet
import ssl4gie_tpu.models.vit as jvit
from ssl4gie_tpu import utils as jutils
from ssl4gie_tpu.convert import loaders as jload
from ssl4gie_tpu.convert import torch_names as jnames
from ssl4gie_tpu.core.config import Architecture as JArch
from ssl4gie_tpu.core.config import TrainConfig as JaxTrainConfig
from ssl4gie_tpu_torch import utils as tutils
from ssl4gie_tpu_torch.cli import convert as tconvert
from ssl4gie_tpu_torch.convert import from_jax as conv
from ssl4gie_tpu_torch.convert import loaders as tload
from ssl4gie_tpu_torch.convert import torch_names as tnames
from ssl4gie_tpu_torch.core.config import Architecture, TrainConfig
import ssl4gie_tpu_torch.models.resnet as tresnet
import ssl4gie_tpu_torch.models.vit as tvit
from test_torch_resnet import TINY, randomized

torch.set_num_threads(1)

NARROW = dict(depth=2, embed_dim=64, num_heads=2)
S, N_CLASS = 64, 5
TOL = 2e-4


def _x(B=2, size=S, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, size, size, 3)).astype(np.float32)


def _noisy(sd, seed):
    """Every float tensor of `sd` plus N(0, 0.05) noise (so that no norm is
    at its init), the BatchNorm variances kept positive."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if v.is_floating_point():
            v = v + 0.05 * torch.randn(v.shape, generator=gen)
            if k.endswith("running_var"):
                v = v.abs() + 0.5
        out[k] = v
    return out


def _vit_sd(seed=11, **kw):
    """A narrow port ViT backbone's state dict (timm names), noisy."""
    bb = tvit.ViTBackbone(**dict(NARROW, **kw))
    bb.reset_parameters(torch.Generator().manual_seed(seed))
    return _noisy(bb.state_dict(), seed)


# ------------------------------------------------------------------ names

@pytest.mark.parametrize("wrap", ["plain", "model", "state_dict", "ddp",
                                  "moco", "base"])
def test_strip_prefixes_matches_jax(wrap):
    inner = {"patch_embed.proj.weight": 1, "blocks.0.norm1.weight": 2,
             "head.weight": 3, "module_x": 4}
    pre = {"plain": "", "model": "", "state_dict": "", "ddp": "module.",
           "moco": "module.base_encoder.", "base": "base_encoder."}[wrap]
    sd = {pre + k: v for k, v in inner.items()}
    sd["module.predictor.0.weight"] = 5
    if wrap in ("model", "state_dict"):
        sd = {wrap: sd, "epoch": 3}
    assert tnames.strip_prefixes(sd) == jnames.strip_prefixes(sd)


# ------------------------------------------------------------ ViT formats

def _reference_files(tmp_path):
    """{format: (path, out_token)} of the reference's ViT formats."""
    sd = _vit_sd()
    files = {}
    timm = dict(sd, **{"head.weight": torch.randn(N_CLASS, 64),
                       "head.bias": torch.zeros(N_CLASS)})
    files["timm"] = timm
    moco = {"module.base_encoder." + k: v for k, v in sd.items()}
    moco.update({"module.base_encoder.head.0.weight": torch.randn(32, 64),
                 "module.predictor.0.weight": torch.randn(16, 32)})
    files["moco"] = {"state_dict": moco, "epoch": 100, "arch": "vit_base"}
    mae = dict(sd, mask_token=torch.randn(1, 1, 32),
               **{"decoder_embed.weight": torch.randn(32, 64),
                  "decoder_blocks.0.norm1.weight": torch.ones(32),
                  "decoder_norm.weight": torch.ones(32)})
    files["mae"] = {"model": mae, "epoch": 399}
    fc = {k: v for k, v in sd.items() if not k.startswith("norm.")}
    fc["fc_norm.weight"] = 1 + 0.1 * torch.randn(64)
    fc["fc_norm.bias"] = 0.1 * torch.randn(64)
    files["fc_norm"] = {"model": fc}
    out = {}
    for name, obj in files.items():
        path = tmp_path / f"{name}.pth"
        torch.save(obj, path)
        out[name] = (str(path), "global_pool" if name == "fc_norm" else "cls")
    return out


def _classifiers(out_token):
    """The JAX classifier's params and the port's on the same weights."""
    jmodel = jvit.ViTClassifier(num_classes=N_CLASS, img_size=S,
                                out_token=out_token, **NARROW)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))["params"])
    model = tvit.ViTClassifier(N_CLASS, img_size=S, out_token=out_token,
                               device="cpu", **NARROW)
    model.load_state_dict(conv.vit_classifier_params_to_torch(params))
    return jmodel, params, model


def _jax_cfg(path, arch=JArch.VIT_B):
    return JaxTrainConfig(architecture=arch, checkpoint=path)


@pytest.mark.parametrize("fmt", ["timm", "moco", "mae", "fc_norm"])
def test_vit_formats_load_as_in_jax(tmp_path, fmt):
    path, out_token = _reference_files(tmp_path)[fmt]
    jmodel, params, model = _classifiers(out_token)
    jparams, jn = jload.load_vit_encoder(path, params, "backbone")
    tn = tload.load_pretrained(TrainConfig(architecture=Architecture.VIT_B,
                                           checkpoint=path), model)
    assert tn == jn
    x = _x()
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x)))
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(
        np.asarray(jload.load_pretrained(_jax_cfg(path), params)[0][
            "lin_head"]["kernel"]), params["lin_head"]["kernel"])
    sd = tload.read_state_dict(path)
    for k, v in model.backbone.state_dict().items():
        if k in sd:
            assert torch.equal(v, sd[k]), k


def _to_sequential(sd):
    """The port's ConvStem names -> MoCo v3's `nn.Sequential` indices,
    with the BatchNorms' `num_batches_tracked`."""
    idx = {v: k for k, v in tnames.CONV_STEM.items()}
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] == "patch_embed":
            k = f"patch_embed.proj.{idx[parts[1]]}.{parts[2]}"
            if parts[1].startswith("bn") and parts[2] == "running_var":
                out[f"patch_embed.proj.{idx[parts[1]]}.num_batches_tracked"] \
                    = torch.tensor(7)
        out[k] = v
    return out


def test_conv_stem_loads_as_in_jax(tmp_path):
    """MoCo v3's ConvStem checkpoint (`module.base_encoder.`, Sequential
    names, running statistics) into a conv-stem backbone: the JAX loader's
    params plus its `convstem_batch_stats`, against the port's one load;
    eval-mode features within 2e-4."""
    sd = _to_sequential(_vit_sd(seed=5, stem="conv"))
    path = tmp_path / "moco_conv.pth.tar"
    torch.save({"state_dict": {"module.base_encoder." + k: v
                               for k, v in sd.items()}}, path)
    jmodel = jvit.ViTBackbone(img_size=S, stem="conv", **NARROW)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    params, n_p = jload.load_vit_encoder(str(path), variables["params"], None)
    stats_up, _ = jnames.convstem_batch_stats(jload._load_torch_sd(str(path)))
    stats, n_s = jload.merge_into(variables["batch_stats"], stats_up, None)
    model = tvit.ViTBackbone(img_size=S, stem="conv", **NARROW)
    assert tload.load_vit_encoder(str(path), model) == n_p + n_s
    x = _x()
    want = np.asarray(jmodel.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x), train=False))
    model.eval()
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_shape_mismatch_raises_in_both(tmp_path):
    sd = _vit_sd()
    sd["norm.weight"] = torch.ones(65)
    path = tmp_path / "bad.pth"
    torch.save(sd, path)
    jmodel, params, model = _classifiers("cls")
    with pytest.raises(ValueError, match="shape mismatch"):
        jload.load_vit_encoder(str(path), params, "backbone")
    with pytest.raises(ValueError, match="shape mismatch"):
        tload.load_pretrained(TrainConfig(architecture=Architecture.VIT_B,
                                          checkpoint=str(path)), model)
    with pytest.raises(ValueError, match="torch checkpoint files only"):
        tload.read_state_dict(str(tmp_path))


@pytest.mark.parametrize("size", [64, 256])
def test_pooled_sizes_match_jax(size):
    """The position grid interpolated bilinearly with align_corners at
    forward time: logits at 64 and 256 px against JAX, cls and
    global_pool; the parameter keeps its 197 rows."""
    for out_token in ("cls", "global_pool"):
        jmodel = jvit.ViTClassifier(num_classes=N_CLASS, img_size=size,
                                    out_token=out_token,
                                    pos_embed_type="sincos", **NARROW)
        params = jmodel.init(jax.random.PRNGKey(1),
                             jnp.zeros((1, size, size, 3)))["params"]
        model = tvit.ViTClassifier(N_CLASS, img_size=size,
                                   out_token=out_token,
                                   pos_embed_type="sincos", device="cpu",
                                   **NARROW)
        model.load_state_dict(conv.vit_classifier_params_to_torch(params))
        assert model.backbone.pos_embed.shape == (1, 197, 64)
        x = _x(size=size, seed=2)
        want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
        got = model(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# ------------------------------------------------------- ResNet-50, AugReg

@pytest.fixture(scope="module")
def rn50_file(tmp_path_factory):
    """A full torchvision ResNet-50 checkpoint (with `fc` and
    `num_batches_tracked`), from the port's init with random statistics."""
    body = randomized(tresnet.ResNet50(mode="pooled"), seed=3)
    body.reset_parameters(torch.Generator().manual_seed(3))
    randomized(body, seed=3)
    sd = dict(body.state_dict())
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(10)
    sd["fc.weight"] = torch.randn(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    path = tmp_path_factory.mktemp("rn50") / "resnet50.pth"
    torch.save(sd, path)
    return str(path)


def _rn50_pair():
    jmodel = jresnet.ResNet50(mode="pooled", stage_sizes=TINY)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    model = tresnet.ResNet50(mode="pooled", stage_sizes=TINY)
    return jmodel, variables["params"], variables["batch_stats"], model


def test_resnet50_loads_as_in_jax(rn50_file):
    """The body's first block a stage (params and statistics) into a
    one-block-a-stage ResNet-50: the JAX `load_pretrained` (no backbone
    key: the root) against the port's; eval-mode features within 2e-4."""
    jmodel, params, stats, model = _rn50_pair()
    jcfg = _jax_cfg(rn50_file, JArch.RESNET50)
    _, _, jn = jload.load_resnet_encoder(rn50_file, params, stats, None)
    jparams, jstats = jload.load_pretrained(jcfg, params, stats)
    tn = tload.load_pretrained(TrainConfig(
        architecture=Architecture.RESNET50, checkpoint=rn50_file), model)
    assert tn == jn
    x = _x(seed=4)
    want = np.asarray(jmodel.apply({"params": jparams, "batch_stats": jstats},
                                   jnp.asarray(x), train=False))
    model.eval()
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got / np.abs(want).max(),
                               want / np.abs(want).max(), rtol=0, atol=TOL)
    with pytest.raises(KeyError, match="lacks"):
        tnames.resnet_encoder({"conv1.weight": torch.zeros(64, 3, 7, 7)})


def _augreg_npz(sd, path, heads=2):
    """A narrow ViT's tensors under big_vision names (the table of JAX
    `vit_flax_from_augreg_npz`, inverted)."""
    d = sd["cls_token"].shape[-1]
    hd = d // heads
    t = lambda k: sd[k].numpy()
    npz = {"embedding/kernel": t("patch_embed.proj.weight").transpose(
        2, 3, 1, 0), "embedding/bias": t("patch_embed.proj.bias"),
        "cls": t("cls_token"),
        "Transformer/posembed_input/pos_embedding": t("pos_embed"),
        "Transformer/encoder_norm/scale": t("norm.weight"),
        "Transformer/encoder_norm/bias": t("norm.bias")}
    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        b, pre = f"blocks.{i}.", f"Transformer/encoderblock_{i}/"
        att = pre + "MultiHeadDotProductAttention_1/"
        qkv_k, qkv_b = t(b + "attn.qkv.weight").T, t(b + "attn.qkv.bias")
        for j, a in enumerate(("query", "key", "value")):
            npz[att + a + "/kernel"] = qkv_k[:, j * d:(j + 1) * d].reshape(
                d, heads, hd)
            npz[att + a + "/bias"] = qkv_b[j * d:(j + 1) * d].reshape(heads,
                                                                      hd)
        npz[att + "out/kernel"] = t(b + "attn.proj.weight").T.reshape(
            heads, hd, d)
        npz[att + "out/bias"] = t(b + "attn.proj.bias")
        for ln, src in (("LayerNorm_0", "norm1"), ("LayerNorm_2", "norm2")):
            npz[pre + ln + "/scale"] = t(b + src + ".weight")
            npz[pre + ln + "/bias"] = t(b + src + ".bias")
        for dn, src in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
            npz[pre + f"MlpBlock_3/{dn}/kernel"] = t(b + f"mlp.{src}.weight").T
            npz[pre + f"MlpBlock_3/{dn}/bias"] = t(b + f"mlp.{src}.bias")
        i += 1
    np.savez(path, **npz)
    return str(path)


def test_augreg_npz_loads_as_in_jax(tmp_path, monkeypatch):
    """`--pretraining ImageNet_class` on a ViT: the .npz at
    $SSL4GIE_IMAGENET_VIT_NPZ through both packages'
    `load_imagenet_supervised`; every tensor of the backbone loaded, the
    logits within 2e-4; unset, both raise."""
    path = _augreg_npz(_vit_sd(seed=8), tmp_path / "augreg.npz")
    jmodel, params, model = _classifiers("cls")
    cfg = TrainConfig(architecture=Architecture.VIT_B)
    monkeypatch.delenv("SSL4GIE_IMAGENET_VIT_NPZ", raising=False)
    with pytest.raises(FileNotFoundError):
        tload.load_imagenet_supervised(cfg, model)
    with pytest.raises(FileNotFoundError):
        jload.load_imagenet_supervised(_jax_cfg(None), params)
    monkeypatch.setenv("SSL4GIE_IMAGENET_VIT_NPZ", path)
    jparams = jload.load_imagenet_supervised(_jax_cfg(None), params)
    n = tload.load_imagenet_supervised(cfg, model)
    assert n == len(model.backbone.state_dict())
    x = _x(seed=5)
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x)))
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# ------------------------------------------------------------------ facade

@pytest.fixture
def narrow_facades(monkeypatch):
    """Both facades' model constructors narrowed (they make full-width
    models)."""
    monkeypatch.setattr(jvit, "ViTBackbone",
                        functools.partial(jvit.ViTBackbone, **NARROW))
    monkeypatch.setattr(tvit, "ViTBackbone",
                        functools.partial(tvit.ViTBackbone, **NARROW))
    monkeypatch.setattr(jresnet, "ResNet50",
                        functools.partial(jresnet.ResNet50,
                                          stage_sizes=TINY))
    monkeypatch.setattr(tresnet, "ResNet50",
                        functools.partial(tresnet.ResNet50,
                                          stage_sizes=TINY))


def test_facade_matches_jax(tmp_path, rn50_file, monkeypatch,
                            narrow_facades):
    """The bare backbones of get_MAE_backbone, get_MoCoV3_backbone,
    get_BarlowTwins_backbone and get_ImageNet_or_random_ViT (npz) with the
    same checkpoints: the port's module on the CPU against the JAX
    module's apply (eval mode), within 2e-4; `frozen` freezes the port's
    backbone."""
    files = _reference_files(tmp_path)
    npz = _augreg_npz(_vit_sd(seed=9), tmp_path / "augreg.npz")
    monkeypatch.setenv("SSL4GIE_IMAGENET_VIT_NPZ", npz)
    x = _x(seed=6)   # built at 224 px, run at 64 (the grid interpolated)
    cases = [
        (lambda m, **k: m.get_MAE_backbone(files["mae"][0], False, 0, False,
                                           False, False, **k)),
        (lambda m, **k: m.get_MoCoV3_backbone(files["moco"][0], "vit_b",
                                              False, 0, False, False, False,
                                              **k)),
        (lambda m, **k: m.get_BarlowTwins_backbone(rn50_file, False, 0,
                                                   False, False, **k)),
        (lambda m, **k: m.get_ImageNet_or_random_ViT(False, 0, False, False,
                                                     False, True, **k))]
    for make in cases:
        jmodel, params, stats = make(jutils)
        want = np.asarray(jmodel.apply({"params": params,
                                        "batch_stats": stats},
                                       jnp.asarray(x), train=False))
        model = make(tutils, device="cpu").eval()
        got = model(torch.from_numpy(x)).detach().numpy()
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=TOL)
    frozen = tutils.get_MAE_backbone(files["mae"][0], False, 0, True,
                                     False, False, device="cpu")
    assert not any(p.requires_grad for p in frozen.parameters())


# ----------------------------------------------------------------- convert

def test_cli_convert_matches_jax_table(tmp_path, rn50_file):
    """`cli.convert` on the MoCo, MAE and ConvStem ViT files, the
    torchvision ResNet-50 and the .npz: the tensors equal JAX's conversion
    of the same file (carried to the port's names by the converters); the
    output file loads to the same backbone as the input."""
    files = _reference_files(tmp_path)
    for fmt in ("moco", "mae"):
        src = files[fmt][0]
        out = tconvert.main(["--input", src, "--output",
                             str(tmp_path / f"{fmt}_port.pt")])
        tree, n = jnames.vit_torch_to_flax(jload._load_torch_sd(src))
        want = conv.vit_classifier_params_to_torch(
            {"backbone": tree, "lin_head": {"kernel": np.zeros((64, 1)),
                                            "bias": np.zeros(1)}})
        want = {k[len("backbone."):]: v for k, v in want.items()
                if k.startswith("backbone.")}
        assert len(out) == n and set(out) == set(want)
        for k, v in out.items():
            assert torch.equal(v, want[k]), k
        a = tvit.ViTBackbone(**NARROW)
        b = tvit.ViTBackbone(**NARROW)
        assert tload.load_vit_encoder(src, a) == tload.load_vit_encoder(
            str(tmp_path / f"{fmt}_port.pt"), b) == n
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k
    out = tconvert.main(["--input", rn50_file, "--arch", "resnet50",
                         "--output", str(tmp_path / "rn50_port.pt")])
    p_up, s_up, n = jnames.resnet_torch_to_flax(
        jload._load_torch_sd(rn50_file))
    layers = conv._resnet_layers((3, 4, 6, 3))
    want = conv._stats_to_torch(s_up, layers, conv._to_torch(p_up, layers))
    assert len(out) == n and set(out) == set(want)
    for k, v in out.items():
        assert torch.equal(v, want[k]), k
    npz = _augreg_npz(_vit_sd(seed=9), tmp_path / "augreg.npz")
    out = tconvert.main(["--input", npz, "--output",
                         str(tmp_path / "npz_port.pt")])
    tree, n = jnames.vit_flax_from_augreg_npz(np.load(npz))
    want = conv.vit_classifier_params_to_torch(
        {"backbone": tree, "lin_head": {"kernel": np.zeros((64, 1)),
                                        "bias": np.zeros(1)}})
    assert len(out) == n
    for k, v in out.items():
        np.testing.assert_allclose(v.numpy(), want["backbone." + k].numpy(),
                                   rtol=0, atol=0, err_msg=k)
    saved = torch.load(tmp_path / "npz_port.pt", weights_only=True)
    assert saved["meta"] == {"epoch": 0, "source": npz}
