"""Weight bridge: the JAX package's variable trees → the port's state dicts.

The port's own copy of the mapping in `medical_image_editing_tpu/utils/
torch_export.py` (the reference's torch state-dict keys): flax HWIO kernels
→ OIHW, BatchNorm running stats (+ a zero `num_batches_tracked`), both
`StyledResUpBlock` layouts, both decoder heads, and the codebook with
`embed_avg` transposed to the reference's (C,K), and both discriminators:
the U-Net discriminator's BigGAN layers with their spectral-norm buffers
`u0` (1,O) and `sv0` (1,) (flax's `u` and `sigma`), and the PatchGAN's
`main.{i}` layout, spectral-normalized convs under `weight_orig`,
`weight_u`, `weight_v` (v derived from W and u, as the JAX package's
export derives it), its ActNorms (`loc`, `scale`, `initialized`, and the
'actnorm' collection's `data_loc`, `data_scale`); and the VQGAN
(`from_jax_vqgan`: the taming layout, GroupNorm scale/bias, the attention's
1×1 convs and its codebook), the perceptual networks' frozen weights
(`from_jax_perceptual`), the minGPT prior (`from_jax_gpt`: Dense kernels
(in, out) → (out, in)), and the volumetric VQ-WNet (`from_jax_volumetric`:
3-D kernels to (O, I, kd, kh, kw) under the flax paths; its inverse,
`to_jax_volumetric`, gives back the flax-shaped numpy tree, with numpy
only). Inputs are nested dicts of arrays (numpy, or anything `np.asarray`
takes); outputs are dicts of CPU tensors that the port's modules load with
`load_state_dict(strict=True)`.

`load_jax_train_state` loads a whole JAX `TrainState` into a port one (the
tests start both sides from it). `load_lightning_state` reads a
Lightning-shaped `.ckpt` (as the JAX package's `cli/export_ckpt.py` and the
port's write it) into per-module state dicts; a VQGAN checkpoint's
`decoder` group is the whole autoencoder with its codebook.
`load_lightning_ckpt` returns the file's epoch and step beside them.
"""

from typing import Dict

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _k(kernel) -> torch.Tensor:
    """flax HWIO → torch OIHW."""
    return _t(np.asarray(kernel, dtype=np.float32).transpose(3, 2, 0, 1))


def _conv(out: StateDict, p: str, cp: dict):
    out[f"{p}.weight"] = _k(cp["kernel"])
    if "bias" in cp:
        out[f"{p}.bias"] = _t(cp["bias"])


def _double_conv(out: StateDict, p: str, dc: dict):
    _conv(out, f"{p}.double_conv.0", dc["Conv_0"])
    _conv(out, f"{p}.double_conv.3", dc["Conv_1"])


def _res_block(out: StateDict, p: str, rb: dict):
    out[f"{p}.downsample.0.weight"] = _k(rb["Conv_0"]["kernel"])
    _double_conv(out, f"{p}.double_conv", rb["DoubleConv_0"])


def _styled_denorm(out: StateDict, p: str, sp: dict, st: dict):
    _conv(out, f"{p}.mlp_shared.0", sp["Conv_0"])
    _conv(out, f"{p}.mlp_gamma", sp["Conv_1"])
    _conv(out, f"{p}.mlp_beta", sp["Conv_2"])
    bn = st["BatchNorm_0"]
    out[f"{p}.param_free_norm.running_mean"] = _t(bn["mean"])
    out[f"{p}.param_free_norm.running_var"] = _t(bn["var"])
    out[f"{p}.param_free_norm.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def _styled_up(out: StateDict, p: str, sp: dict, st: dict):
    if "Conv_3" in sp:  # PixelShuffle variant: the extra upsample conv first
        _conv(out, f"{p}.up_sample.0", sp["Conv_0"])
        s_conv, conv1, conv2 = "Conv_1", "Conv_2", "Conv_3"
    else:
        s_conv, conv1, conv2 = "Conv_0", "Conv_1", "Conv_2"
    _conv(out, f"{p}.conv.0", sp[s_conv])
    _conv(out, f"{p}.conv1", sp[conv1])
    _conv(out, f"{p}.conv2", sp[conv2])
    for i, norm in enumerate(("norm1", "norm2")):
        _styled_denorm(out, f"{p}.{norm}", sp[f"StyledDenorm_{i}"],
                       st[f"StyledDenorm_{i}"])


def from_jax_vq(vq, prefix: str = "vq.") -> StateDict:
    """Codebook state (anything with `embed`, `cluster_size`, `embed_avg`
    (K,C)) → `vq.*` buffers, `embed_avg` as the reference's (C,K)."""
    return {
        f"{prefix}embed": _t(vq.embed),
        f"{prefix}cluster_size": _t(vq.cluster_size),
        f"{prefix}embed_avg": _t(np.asarray(vq.embed_avg, dtype=np.float32).T),
    }


def from_jax_encoder(enc_vars: dict, vq=None) -> StateDict:
    """UNetEncoder variables (+ optional codebook) → `EncoderWithVQ` keys."""
    params = enc_vars["params"]
    stats = enc_vars.get("batch_stats", {})
    out: StateDict = {}
    for i in range(4):
        _res_block(out, f"down_conv1_{i + 1}", params[f"ResBlock_{i}"])
    _double_conv(out, "double_conv1", params["DoubleConv_0"])
    for j, n in enumerate((4, 3, 2, 1)):
        if f"UpBlock_{j}" in params:
            _double_conv(out, f"up_conv1_{n}.double_conv",
                         params[f"UpBlock_{j}"]["DoubleConv_0"])
        else:
            _styled_up(out, f"up_conv1_{n}", params[f"StyledResUpBlock_{j}"],
                       stats[f"StyledResUpBlock_{j}"])
    if vq is not None:
        out.update(from_jax_vq(vq))
    return out


def from_jax_decoder(dec_vars: dict) -> StateDict:
    """UNetDecoder variables → `UNetDecoder` keys (either head)."""
    params = dec_vars["params"]
    stats = dec_vars.get("batch_stats", {})
    out: StateDict = {}
    n_levels = sum(1 for k in params if k.startswith("ResBlock_"))
    for i in range(n_levels):
        _res_block(out, f"down_conv2_{i + 1}", params[f"ResBlock_{i}"])
    _double_conv(out, "double_conv2", params["DoubleConv_0"])
    for j in range(n_levels):
        n = n_levels - j
        _styled_up(out, f"up_conv2_{n}", params[f"StyledResUpBlock_{j}"],
                   stats[f"StyledResUpBlock_{j}"])
    if "ASPP_0" in params:  # residual ASPP head
        for name, cp in params["ASPP_0"].items():
            idx = int(name.split("_")[1])
            out[f"conv_last.0.stages.c{idx}.conv.weight"] = _k(cp["kernel"])
        _double_conv(out, "conv_last.1", params["DoubleConv_1"])
        _conv(out, "conv1x1", params["Conv_0"])
    else:  # multi-scale PixelShuffle head
        for j in range(n_levels - 1):
            _conv(out, f"pixel_shuffle2_{n_levels - j}.0", params[f"Conv_{j}"])
        _conv(out, "conv_last", params[f"Conv_{n_levels - 1}"])
    return out


def _sn_conv(out: StateDict, p: str, cp: dict, st: dict):
    """BigGAN `SNConv` (flax `SpectralNorm(Conv_0)`) → weight, bias, u0, sv0."""
    _conv(out, p, cp["Conv_0"])
    sn = st["SpectralNorm_0"]
    out[f"{p}.u0"] = _t(np.asarray(sn["Conv_0/kernel/u"]).reshape(1, -1))
    out[f"{p}.sv0"] = _t(np.asarray(sn["Conv_0/kernel/sigma"]).reshape(1))


def from_jax_unet_discriminator(dis_vars: dict, *, D_attn: str = "0") -> StateDict:
    """`UNetDiscriminator` variables → the port's `UNetDiscriminator` keys
    (the reference's, without its unused `linear.*`). The resolution and
    `D_ch` are read from the variables; `D_attn` places the attention
    blocks, as the module's own argument does."""
    from ..models.unet_discriminator import attention_resolutions, d_unet_arch

    params, stats = dis_vars["params"], dis_vars["batch_stats"]
    n_down = sum(1 for k in params if k.startswith("DBlock_"))
    resolution = {5: 128, 6: 256, 7: 512}[n_down]
    ch = int(np.asarray(params["DBlock_0"]["SNConv_1"]["Conv_0"]["kernel"]).shape[-1])
    arch = d_unet_arch(resolution, ch)
    attn_res = attention_resolutions(D_attn)
    out: StateDict = {}
    n_d = n_g = n_a = 0
    for index, down in enumerate(arch["downsample"]):
        if down:
            name, n_d = f"DBlock_{n_d}", n_d + 1
        else:
            name, n_g = f"GBlock2_{n_g}", n_g + 1
        for part, sub in (("conv1", "SNConv_0"), ("conv2", "SNConv_1"), ("conv_sc", "SNConv_2")):
            if sub in params[name]:
                _sn_conv(out, f"blocks.{index}.0.{part}", params[name][sub], stats[name][sub])
        if arch["resolution"][index] in attn_res and index < 5:
            ap, ast = params[f"Attention_{n_a}"], stats[f"Attention_{n_a}"]
            for t, part in enumerate(("theta", "phi", "g", "o")):
                _sn_conv(out, f"blocks.{index}.1.{part}", ap[f"SNConv_{t}"], ast[f"SNConv_{t}"])
            out[f"blocks.{index}.1.gamma"] = _t(np.asarray(ap["gamma"]).reshape(()))
            n_a += 1
    _conv(out, f"blocks.{len(arch['downsample'])}", params["Conv_0"])
    dense = params["SNDense_0"]["Dense_0"]
    sn = stats["SNDense_0"]["SpectralNorm_0"]
    out["linear_middle.weight"] = _t(np.asarray(dense["kernel"], dtype=np.float32).T)
    if "bias" in dense:
        out["linear_middle.bias"] = _t(dense["bias"])
    out["linear_middle.u0"] = _t(np.asarray(sn["Dense_0/kernel/u"]).reshape(1, -1))
    out["linear_middle.sv0"] = _t(np.asarray(sn["Dense_0/kernel/sigma"]).reshape(1))
    return out


def from_jax_nlayer_discriminator(dis_vars: dict) -> StateDict:
    """`NLayerDiscriminator` variables → the port's `NLayerDiscriminator`
    keys: conv j at `main.{0 if j == 0 else 3j − 1}`, norm k at
    `main.{3k + 3}`; a spectral-normalized conv as `weight_orig`,
    `weight_u` (flax's u, (O,)) and `weight_v` = normalize(Wᵀu)."""
    params = dis_vars["params"]
    stats = dis_vars.get("batch_stats", {})
    out: StateDict = {}
    for j in sorted(int(k.split("_")[1]) for k in params if k.startswith("Conv_")):
        cp, p = params[f"Conv_{j}"], f"main.{0 if j == 0 else 3 * j - 1}"
        if f"SpectralNorm_{j}" in stats:
            w = np.asarray(cp["kernel"], dtype=np.float32).transpose(3, 2, 0, 1)
            u = np.asarray(stats[f"SpectralNorm_{j}"][f"Conv_{j}/kernel/u"],
                           dtype=np.float32).reshape(-1)
            v = w.reshape(w.shape[0], -1).T @ u
            out[f"{p}.weight_orig"] = _t(w)
            out[f"{p}.weight_u"] = _t(u)
            out[f"{p}.weight_v"] = _t(v / (np.linalg.norm(v) + 1e-12))
            if "bias" in cp:
                out[f"{p}.bias"] = _t(cp["bias"])
        else:
            _conv(out, p, cp)
    for k in sorted(int(k.split("_")[1]) for k in params if k.startswith("BatchNorm_")):
        p, bn, st = f"main.{3 * k + 3}", params[f"BatchNorm_{k}"], stats[f"BatchNorm_{k}"]
        out[f"{p}.weight"] = _t(bn["scale"])
        out[f"{p}.bias"] = _t(bn["bias"])
        out[f"{p}.running_mean"] = _t(st["mean"])
        out[f"{p}.running_var"] = _t(st["var"])
        out[f"{p}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    actnorm = dis_vars.get("actnorm", {})
    for k in sorted(int(k.split("_")[1]) for k in params if k.startswith("ActNorm_")):
        p, an = f"main.{3 * k + 3}", actnorm.get(f"ActNorm_{k}", {})
        c = np.asarray(params[f"ActNorm_{k}"]["loc"]).shape[0]
        out[f"{p}.loc"] = _t(params[f"ActNorm_{k}"]["loc"]).reshape(1, c, 1, 1)
        out[f"{p}.scale"] = _t(params[f"ActNorm_{k}"]["scale"]).reshape(1, c, 1, 1)
        out[f"{p}.initialized"] = torch.tensor(int(bool(np.asarray(an.get("initialized", 0)))),
                                               dtype=torch.uint8)
        out[f"{p}.data_loc"] = _t(an.get("data_loc", np.zeros(c))).reshape(1, c, 1, 1)
        out[f"{p}.data_scale"] = _t(an.get("data_scale", np.ones(c))).reshape(1, c, 1, 1)
    return out


def _gn(out: StateDict, p: str, gp: dict):
    out[f"{p}.weight"] = _t(gp["scale"])
    out[f"{p}.bias"] = _t(gp["bias"])


def _vqgan_resnet(out: StateDict, p: str, rp: dict, block):
    _gn(out, f"{p}.norm1", rp["GroupNorm_0"])
    _conv(out, f"{p}.conv1", rp["Conv_0"])
    _gn(out, f"{p}.norm2", rp["GroupNorm_1"])
    _conv(out, f"{p}.conv2", rp["Conv_1"])
    if "Conv_2" in rp:
        name = "conv_shortcut" if hasattr(block, "conv_shortcut") else "nin_shortcut"
        _conv(out, f"{p}.{name}", rp["Conv_2"])


def _vqgan_attn(out: StateDict, p: str, ap: dict):
    _gn(out, f"{p}.norm", ap["GroupNorm_0"])
    for i, name in enumerate(("q", "k", "v", "proj_out")):
        _conv(out, f"{p}.{name}", ap[f"Conv_{i}"])


def _vqgan_levels(out: StateDict, part: str, levels, order, tree: dict, n_rb: int,
                  n_at: int, resample: str):
    """The `down`/`up` levels of the port's `part`, walked in the JAX
    module's call order `order`, from flax's counters `n_rb`, `n_at`."""
    n_rs = 0
    flax_resample = {"downsample": "Downsample", "upsample": "Upsample"}[resample]
    for lv in order:
        level = levels[lv]
        for b, block in enumerate(level.block):
            _vqgan_resnet(out, f"{part}.{lv}.block.{b}", tree[f"ResnetBlock_{n_rb}"], block)
            n_rb += 1
            if len(level.attn):
                _vqgan_attn(out, f"{part}.{lv}.attn.{b}", tree[f"AttnBlock_{n_at}"])
                n_at += 1
        if hasattr(level, resample):
            _conv(out, f"{part}.{lv}.{resample}.conv",
                  tree[f"{flax_resample}_{n_rs}"]["Conv_0"])
            n_rs += 1
    return n_rb, n_at


def from_jax_vqgan(vqgan_vars: dict, vq, module) -> StateDict:
    """The JAX `VQGAN`'s variables and codebook state → the port's `VQGAN`
    keys (the reference's): HWIO → OIHW, GroupNorm scale/bias → weight/bias,
    the attention's 1×1 convs, `embed_avg` as (C,K). `module` is the port's
    `VQGAN` of the same configuration: its levels give the layout (the
    flax names count blocks in call order)."""
    enc = vqgan_vars["params"]["encoder"]
    dec = vqgan_vars["params"]["decoder"]
    out: StateDict = {}
    _conv(out, "encoder.conv_in", enc["Conv_0"])
    n_rb, n_at = _vqgan_levels(out, "encoder.down", module.encoder.down,
                               range(len(module.encoder.down)), enc, 0, 0, "downsample")
    _vqgan_resnet(out, "encoder.mid.block_1", enc[f"ResnetBlock_{n_rb}"],
                  module.encoder.mid.block_1)
    _vqgan_attn(out, "encoder.mid.attn_1", enc[f"AttnBlock_{n_at}"])
    _vqgan_resnet(out, "encoder.mid.block_2", enc[f"ResnetBlock_{n_rb + 1}"],
                  module.encoder.mid.block_2)
    _gn(out, "encoder.norm_out", enc["GroupNorm_0"])
    _conv(out, "encoder.conv_out", enc["Conv_1"])

    _conv(out, "decoder.conv_in", dec["Conv_0"])
    _vqgan_resnet(out, "decoder.mid.block_1", dec["ResnetBlock_0"], module.decoder.mid.block_1)
    _vqgan_attn(out, "decoder.mid.attn_1", dec["AttnBlock_0"])
    _vqgan_resnet(out, "decoder.mid.block_2", dec["ResnetBlock_1"], module.decoder.mid.block_2)
    _vqgan_levels(out, "decoder.up", module.decoder.up,
                  reversed(range(len(module.decoder.up))), dec, 2, 1, "upsample")
    _gn(out, "decoder.norm_out", dec["GroupNorm_0"])
    _conv(out, "decoder.conv_out", dec["Conv_1"])
    out.update(from_jax_vq(vq))
    return out


def from_jax_volumetric_params(params: dict, prefix: str = "") -> StateDict:
    """One volumetric module's flax params (or a tree shaped like them,
    e.g. Adam's moments) → its state dict: keys the flax paths, 3-D kernels
    (kd, kh, kw, I, O) → (O, I, kd, kh, kw)."""
    out: StateDict = {}
    for name, sub in params.items():
        if "kernel" in sub:
            out[f"{prefix}{name}.weight"] = _t(
                np.asarray(sub["kernel"], dtype=np.float32).transpose(4, 3, 0, 1, 2))
            if "bias" in sub:
                out[f"{prefix}{name}.bias"] = _t(sub["bias"])
        else:
            out.update(from_jax_volumetric_params(sub, f"{prefix}{name}."))
    return out


def from_jax_volumetric(enc_vars: dict, dec_vars: dict, vq) -> Dict[str, StateDict]:
    """The volumetric VQ-WNet's variables → {"enc", "dec", "vq"}, the layout
    of the port's `train_volumetric` checkpoint: the modules' keys are the
    flax paths (`ResBlock3D_i.Conv_0` the 1×1×1 identity,
    `ResBlock3D_i.DoubleConv3D_0.Conv_{0,1}`, `DoubleConv3D_0`,
    `UpBlock3D_j.DoubleConv3D_0`, the decoder's `Conv_0`; the remat-stable
    names, not flax's `Checkpoint*`), the codebook `from_jax_vq`'s."""
    return {"enc": from_jax_volumetric_params(enc_vars["params"]),
            "dec": from_jax_volumetric_params(dec_vars["params"]),
            "vq": from_jax_vq(vq, prefix="")}


def to_jax_volumetric_params(state_dict: StateDict) -> dict:
    """The inverse of `from_jax_volumetric_params`: a volumetric module's
    state dict → its flax params as numpy arrays, nested on the keys' dots,
    3-D weights (O, I, kd, kh, kw) → kernels (kd, kh, kw, I, O)."""
    params: dict = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        node = params
        for name in path:
            node = node.setdefault(name, {})
        a = value.detach().cpu().numpy()
        if leaf == "weight":
            node["kernel"] = np.ascontiguousarray(a.transpose(2, 3, 4, 1, 0))
        elif leaf == "bias":
            node["bias"] = np.array(a)
        else:
            raise KeyError(f"{key}: a volumetric module holds weights and biases only")
    return params


def to_jax_volumetric(sds: Dict[str, StateDict]) -> dict:
    """The inverse of `from_jax_volumetric`: the port's `train_volumetric`
    checkpoint {"enc", "dec", "vq"} → the tree the JAX package's
    `train_volumetric` saves with Orbax, in numpy: {"enc": {"params"},
    "dec": {"params"}, "vq": {embed, cluster_size, embed_avg (K, C)}}."""
    vq = sds["vq"]
    return {"enc": {"params": to_jax_volumetric_params(sds["enc"])},
            "dec": {"params": to_jax_volumetric_params(sds["dec"])},
            "vq": {"embed": vq["embed"].detach().cpu().numpy().copy(),
                   "cluster_size": vq["cluster_size"].detach().cpu().numpy().copy(),
                   "embed_avg": np.ascontiguousarray(
                       vq["embed_avg"].detach().cpu().numpy().T)}}


def from_jax_discriminator(dis_vars: dict, *, D_attn: str = "0") -> StateDict:
    """Either discriminator's variables → the port's keys (the U-Net one is
    told apart by its `DBlock_0`)."""
    if "DBlock_0" in dis_vars["params"]:
        return from_jax_unet_discriminator(dis_vars, D_attn=D_attn)
    return from_jax_nlayer_discriminator(dis_vars)


def from_jax_perceptual(params) -> StateDict:
    """The JAX perceptual networks' parameters (`ops/perceptual.py`) → the
    port's buffers: the VGG's {torchvision index: (kernel HWIO, bias)} →
    `VGGLoss` keys `features.{i}.weight` (OIHW) / `.bias`; LPIPS's
    (convs [(kernel HWIO, bias)], heads [(C,)]) → `LPIPSLoss` keys
    `convs.{k}.weight` / `.bias` and `lin{k}`."""
    out = {}
    if isinstance(params, dict):
        for i, (w, b) in params.items():
            out[f"features.{i}.weight"], out[f"features.{i}.bias"] = _k(w), _t(b)
        return out
    convs, lins = params
    for k, (w, b) in enumerate(convs):
        out[f"convs.{k}.weight"], out[f"convs.{k}.bias"] = _k(w), _t(b)
    for k, lin in enumerate(lins):
        out[f"lin{k}"] = _t(lin)
    return out


def _dense(out: StateDict, p: str, dp: dict):
    """flax Dense (kernel (in, out), optional bias) → nn.Linear (out, in)."""
    out[f"{p}.weight"] = _t(np.asarray(dp["kernel"], dtype=np.float32).T)
    if "bias" in dp:
        out[f"{p}.bias"] = _t(dp["bias"])


def _layer_norm(out: StateDict, p: str, lp: dict):
    out[f"{p}.weight"], out[f"{p}.bias"] = _t(lp["scale"]), _t(lp["bias"])


def from_jax_gpt(params: dict) -> StateDict:
    """The JAX minGPT's `params` (`models/mingpt.py`: `tok_emb`, `pos_emb`,
    `block_{i}` with `LayerNorm_0`, `LayerNorm_1`, `attn/{q,k,v,proj}`,
    `Dense_0`, `Dense_1`, then `ln_f` and `head`) → the port's `GPT` keys
    (`tok_embed`, `pos_embed`, `blocks.{i}.ln1`, `.ln2`, `.att.*`,
    `.mlp.0`, `.mlp.2`, `ln_f`, `head`), Dense kernels transposed."""
    out = {"tok_embed.weight": _t(params["tok_emb"]["embedding"]),
           "pos_embed": _t(params["pos_emb"])}
    n_layer = sum(1 for k in params if k.startswith("block_"))
    for i in range(n_layer):
        bp, p = params[f"block_{i}"], f"blocks.{i}"
        _layer_norm(out, f"{p}.ln1", bp["LayerNorm_0"])
        _layer_norm(out, f"{p}.ln2", bp["LayerNorm_1"])
        for name in ("q", "k", "v", "proj"):
            _dense(out, f"{p}.att.{name}", bp["attn"][name])
        _dense(out, f"{p}.mlp.0", bp["Dense_0"])
        _dense(out, f"{p}.mlp.2", bp["Dense_1"])
    _layer_norm(out, "ln_f", params["ln_f"])
    _dense(out, "head", params["head"])
    return out


def from_jax_train_state(state, *, D_attn: str = "0") -> Dict[str, StateDict]:
    """A JAX `TrainState` (anything with `enc_vars`, `dec_vars` and `vq`,
    and optionally `dis_vars`) → {"encoder": `EncoderWithVQ` keys with the
    codebook, "decoder": `UNetDecoder` keys, and "discriminator" where
    `dis_vars` is not empty}: parameters, BatchNorm running stats,
    spectral-norm vectors and the VQ EMA state, for starting a port
    `TrainState` where a JAX one stands. The optimizers' moments are not
    carried: both sides start them at 0."""
    out = {"encoder": from_jax_encoder(state.enc_vars, state.vq),
           "decoder": from_jax_decoder(state.dec_vars)}
    dis_vars = getattr(state, "dis_vars", None)
    if dis_vars:
        out["discriminator"] = from_jax_discriminator(dis_vars, D_attn=D_attn)
    return out


def load_jax_train_state(port_state, jax_state, *, D_attn: str = "0"):
    """Load a JAX `TrainState` (its `enc_vars`, `vq`, `dec_vars` and
    `dis_vars` as arrays) into a port `TrainState` in place, every module
    with `strict=True`: a joint or second-stage state's encoder with its
    codebook, decoder and U-Net discriminator; a VQGAN state's autoencoder
    with its codebook (the decoder slot; the JAX `enc_vars` are empty) and
    discriminator. A port state with a discriminator needs JAX `dis_vars`;
    a JAX discriminator beside a port state without one (the JAX trainer
    builds it in every mode) is not loaded. Adam's moments are not carried.
    Returns `port_state`."""
    if port_state.encoder is None:  # the VQGAN in the decoder slot
        sds = {"decoder": from_jax_vqgan(jax_state.dec_vars, jax_state.vq,
                                         port_state.decoder)}
        if getattr(jax_state, "dis_vars", None):
            sds["discriminator"] = from_jax_discriminator(jax_state.dis_vars, D_attn=D_attn)
    else:
        sds = from_jax_train_state(jax_state, D_attn=D_attn)
    for part in ("encoder", "decoder", "discriminator"):
        module = getattr(port_state, part)
        if module is None:
            continue
        if part not in sds:
            raise KeyError(f"the JAX state has no {part} for the port state's")
        module.load_state_dict(sds[part], strict=True)
    return port_state


def load_lightning_ckpt(path: str):
    """Read a Lightning-shaped `.ckpt` → (groups, {"epoch", "step"}): groups
    as `load_lightning_state` returns them, and the file's `epoch` and
    `global_step` (0 where absent)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "state_dict" not in ckpt:
        raise ValueError(f"{path}: not a Lightning checkpoint (no 'state_dict')")
    groups: Dict[str, StateDict] = {}
    for key, value in ckpt["state_dict"].items():
        head, _, rest = key.partition(".")
        groups.setdefault(head, {})[rest] = value
    meta = {"epoch": int(ckpt.get("epoch", 0) or 0),
            "step": int(ckpt.get("global_step", 0) or 0)}
    return groups, meta


def load_lightning_state(path: str) -> Dict[str, StateDict]:
    """Read a Lightning-shaped `.ckpt` → {"encoder": {...}, "decoder": {...},
    "discriminator": {...}, ...}: the `state_dict` split on its first key
    component (the encoder's group holds the `vq.*` buffers, a VQGAN
    checkpoint's `decoder` group the whole autoencoder with them; a U-Net
    discriminator's group still holds the reference's unused `linear.*`,
    which `models.unet_discriminator.reference_state_dict` drops)."""
    return load_lightning_ckpt(path)[0]
