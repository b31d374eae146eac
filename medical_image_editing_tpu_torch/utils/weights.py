"""Weight bridge: the JAX package's variable trees → the port's state dicts.

The port's own copy of the mapping in `medical_image_editing_tpu/utils/
torch_export.py` (the reference's torch state-dict keys): flax HWIO kernels
→ OIHW, BatchNorm running stats (+ a zero `num_batches_tracked`), both
`StyledResUpBlock` layouts, both decoder heads, and the codebook with
`embed_avg` transposed to the reference's (C,K). Inputs are nested dicts of
arrays (numpy, or anything `np.asarray` takes); outputs are dicts of CPU
tensors that the port's modules load with `load_state_dict(strict=True)`.

`load_lightning_state` reads a Lightning-shaped `.ckpt` (as the JAX
package's `cli/export_ckpt.py` writes it) into per-module state dicts.
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


def from_jax_train_state(state) -> Dict[str, StateDict]:
    """A JAX `TrainState` (anything with `enc_vars`, `dec_vars` and `vq`) →
    {"encoder": `EncoderWithVQ` keys with the codebook, "decoder":
    `UNetDecoder` keys}: parameters, BatchNorm running stats and the VQ
    EMA state, for starting a port `TrainState` where a JAX one stands.
    The optimizers' moments are not carried: both sides start them at 0."""
    return {"encoder": from_jax_encoder(state.enc_vars, state.vq),
            "decoder": from_jax_decoder(state.dec_vars)}


def load_lightning_state(path: str) -> Dict[str, StateDict]:
    """Read a Lightning-shaped `.ckpt` → {"encoder": {...}, "decoder": {...},
    ...}: the `state_dict` split on its first key component (the encoder's
    group holds the `vq.*` buffers)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "state_dict" not in ckpt:
        raise ValueError(f"{path}: not a Lightning checkpoint (no 'state_dict')")
    groups: Dict[str, StateDict] = {}
    for key, value in ckpt["state_dict"].items():
        head, _, rest = key.partition(".")
        groups.setdefault(head, {})[rest] = value
    return groups
