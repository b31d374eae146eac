"""Configuration helpers: the port's own copy of
`medical_image_editing_tpu/utils/config.py` (reference
`src/utils/__init__.py:99-106`): JSON config loading, `load_dotenv` and
`validate_config`.

A JSON config becomes recursive attribute-access `ConfigNode`s, with the
reference's object-hook quirk kept by default: `False` values become `None`
(both are falsy, so gated features behave the same; `false_to_none=False`
keeps them). `getattr_else_none` is the optional-field accessor of the
reference's `src/trainers/base.py`.
"""

import json
import os
from typing import Any, Mapping


class ConfigNode:
    """Recursive attribute-access view over a dict. A missing key raises
    AttributeError; use `getattr_else_none`/`get` for optional fields."""

    def __init__(self, data: Mapping[str, Any]):
        object.__setattr__(self, "_data", dict(data))

    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name not in data:
            raise AttributeError(f"config has no field {name!r}")
        return data[name]

    def __setattr__(self, name, value):
        object.__getattribute__(self, "_data")[name] = value

    def get(self, name: str, default=None) -> Any:
        return object.__getattribute__(self, "_data").get(name, default)

    def __contains__(self, name: str) -> bool:
        return name in object.__getattribute__(self, "_data")

    def __repr__(self):
        return f"ConfigNode({object.__getattribute__(self, '_data')!r})"

    def to_dict(self) -> dict:
        def undo(v):
            if isinstance(v, ConfigNode):
                return v.to_dict()
            if isinstance(v, list):
                return [undo(x) for x in v]
            return v

        return {k: undo(v) for k, v in object.__getattribute__(self, "_data").items()}


def to_config(data: Any, false_to_none: bool = True) -> Any:
    """Recursively wrap dicts in ConfigNode; `False` → `None` unless
    `false_to_none` is off."""
    if isinstance(data, Mapping):
        return ConfigNode({k: to_config(v, false_to_none) for k, v in data.items()})
    if isinstance(data, list):
        return [to_config(v, false_to_none) for v in data]
    return None if data is False and false_to_none else data


def load_json(path: str, false_to_none: bool = True):
    """Load a reference-format JSON config."""
    with open(path) as f:
        return to_config(json.load(f), false_to_none)


def getattr_else_none(config, name: str, default=None):
    """Optional-field accessor: the field, or `default` when it is missing."""
    try:
        if isinstance(config, ConfigNode):
            return config.get(name, default)
        return getattr(config, name, default)
    except AttributeError:
        return default


def load_dotenv(path: str = ".env") -> dict:
    """Minimal python-dotenv replacement (the reference loads `.env` for
    checkpoint paths — `run_recon.py:20-24`). Parses KEY=VALUE lines into
    os.environ (existing variables win) and returns the parsed dict."""
    parsed = {}
    if not os.path.exists(path):
        return parsed
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip().strip("'\"")
            parsed[key] = value
            os.environ.setdefault(key, value)
    return parsed


def validate_config(cfg, multi_window: bool = False, vqgan: bool = False):
    """Fail fast, with the JAX package's messages, on the config mistakes
    that would otherwise surface deep inside model construction. Returns a
    list of warnings for oddities that still run; raises ValueError on
    definite errors."""
    problems = []
    warnings_ = []
    g = getattr_else_none

    run = g(cfg, "run")
    ds = g(cfg, "dataset")
    model = g(cfg, "model")
    if run is None or ds is None or model is None:
        raise ValueError("config must contain 'run', 'dataset' and 'model' sections")

    mode = str(g(run, "training_mode", ""))
    known_modes = {"first_step", "second_step", "joint_step", "inference", "test"}
    if mode not in known_modes:
        problems.append(f"run.training_mode={mode!r} is not one of {sorted(known_modes)}")
    if mode == "joint_step" and not multi_window:
        problems.append("training_mode 'joint_step' requires the multi-window "
                        "trainer (-w flag)")

    name = str(g(ds, "dataset_name", ""))
    known_ds = {"MICCAIBraTSDataset", "NCCLungDataset", "CRCDataset",
                "SyntheticSliceDataset"}
    if name not in known_ds:
        problems.append(f"dataset.dataset_name={name!r} is not one of {sorted(known_ds)}")
    if name == "MICCAIBraTSDataset" and not g(ds, "modality"):
        problems.append("MICCAIBraTSDataset requires dataset.modality")
    if name == "NCCLungDataset":
        missing = [k for k in ("window_width", "window_center", "window_scale")
                   if g(ds, k) is None]
        if missing:
            warnings_.append(
                f"NCCLungDataset without dataset.{'/'.join(missing)}: slices "
                "load un-windowed (raw HU)"
            )
    if multi_window and g(ds, "window_width") is None:
        problems.append(
            "multi-window training (-w) computes per-window losses in HU; "
            "dataset.window_width/window_center/window_scale must be set"
        )

    image_size = g(ds, "image_size")
    hw = None
    if image_size:
        # both [H, W] and a bare int
        if isinstance(image_size, (int, float)):
            hw = [int(image_size)] * 2
        else:
            hw = [int(s) for s in image_size]
        vqm = g(model, "vqmodel")
        if vqm is not None and not vqgan:
            filters = list(g(vqm, "enc_filters", []) or [])
            if filters:
                down = 2 ** (len(filters) - 1)
                for s in hw:
                    if s % down != 0:
                        problems.append(
                            f"image_size {s} not divisible by the encoder's "
                            f"downsampling factor {down} "
                            f"(len(enc_filters)={len(filters)})"
                        )

    dis = g(model, "dis")
    if dis is None:
        problems.append("config must contain model.dis (the trainer builds "
                        "the discriminator for every mode)")
    else:
        unet_dis_only = (vqgan and mode not in ("test", "inference")) or (
            multi_window and mode in ("second_step", "joint_step")
        )
        if unet_dis_only and str(g(dis, "model_name", "")) != "UNetDiscriminator":
            which = "VQGAN trainer (-v)" if vqgan else "multi-window GAN modes (-w)"
            problems.append(
                f"the {which} require model.dis.model_name="
                f"'UNetDiscriminator', got {g(dis, 'model_name')!r}"
            )
        if str(g(dis, "model_name", "")) == "UNetDiscriminator":
            res = g(dis, "resolution")
            if res is not None and int(res) not in (128, 256, 512):
                problems.append(
                    f"UNetDiscriminator resolution must be 128/256/512 "
                    f"(D_unet_arch table), got {res}"
                )
            if hw and res is not None and int(res) != hw[0]:
                warnings_.append(
                    f"dis.resolution={res} != dataset.image_size[0]={hw[0]} — "
                    "the discriminator arch is chosen for a different size"
                )

    loss = g(cfg, "loss")
    if loss is not None and bool(g(loss, "use_perceptual_loss")):
        if not (os.environ.get("MEDIMG_VGG19_NPZ") or os.environ.get("MEDIMG_LPIPS_NPZ")):
            warnings_.append(
                "use_perceptual_loss=true without MEDIMG_VGG19_NPZ/"
                "MEDIMG_LPIPS_NPZ: training uses the seeded random-feature "
                "fallback, not the reference's learned metric"
            )

    if problems:
        raise ValueError("invalid config:\n  - " + "\n  - ".join(problems))
    return warnings_
