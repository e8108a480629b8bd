"""Weights into the port's modules: from the JAX package's flax params, from
HF / ForCTC torch state dicts (``pytorch_model.bin`` or ``model.safetensors``,
the latter read by :func:`read_safetensors`), or a seeded random init; and back from the
port's state dict to a flax params tree (``flax_from_state_dict``), so a
test can hold updated params against the JAX package's.

The port's modules keep HF attribute names, so:
  * flax Dense ``kernel`` -> ``weight = kernel.T``,
  * flax Conv ``kernel [k, in/g, out]`` -> ``weight = transpose(2, 1, 0)``,
  * flax LayerNorm/GroupNorm ``scale`` -> ``weight``,
  * a JAX ``scan_layers`` tree's stacked ``encoder/layers_scan/layer``
    (leading ``[L, ...]`` axis) <-> ``layers.{i}``,
  * an HF state dict maps by stripping the encoder prefix, with the
    weight-normed positional conv (wav2vec2/hubert ``single``) merged into a
    plain weight: weight norm is a reparametrisation, not a function.

A ``BackboneConfig`` gives the backbone's state dict (:class:`SSLBackbone`,
or :class:`SEWDBackbone` for ``model_type="sew-d"``); a ``DACSConfig``
gives the state dict of its method's model (``get_recipe(cfg.method).
make_model``: the DACS model, or a variant of models/variants.py, with the
backbone under ``backbone.`` plus the method's heads). Values are fp32 CPU
tensors; ``load_state_dict`` casts them to each module's dtype and device.

SEW-D's flax tree (the JAX package's ``SEWDBackbone``) names its modules
otherwise than HF: ``pos_conv``, the raw ``rel_embeddings`` param and its
``rel_embeddings_layer_norm``, ``layers_{i}/attention_self|
attention_output|attention_layer_norm|intermediate|output|
output_layer_norm`` and ``upsample``; :data:`_SEWD_NAMES` maps them onto
the HF names both ways.
"""

from __future__ import annotations

import json
import re
import struct
from typing import Any, Mapping

import numpy as np
import torch

from .config import BackboneConfig, DACSConfig
from .factory import make_backbone

# ForCTC head names -> the port's model attributes (the heads the JAX
# package's ``port_dacs_heads`` carries)
_HEADS = {"lm_head": "lm_head", "dementia_head": "dementia_head",
          "arbitrator": "arbitrator", "criterion_similar.fc": "similar_fc"}
_ENCODER_PREFIXES = ("data2vec_audio.", "wav2vec2.", "hubert.", "unispeech_sat.",
                     "sew_d.", "")
# SEW-D: flax module path (dotted, ``{i}`` a layer index) <-> HF module name
_SEWD_NAMES = (
    ("pos_conv", "encoder.pos_conv_embed.conv"),
    ("rel_embeddings_layer_norm", "encoder.encoder.LayerNorm"),
    ("layers.{i}.attention_self", "encoder.encoder.layer.{i}.attention.self"),
    ("layers.{i}.attention_output", "encoder.encoder.layer.{i}.attention.output.dense"),
    ("layers.{i}.attention_layer_norm", "encoder.encoder.layer.{i}.attention.output.LayerNorm"),
    ("layers.{i}.intermediate", "encoder.encoder.layer.{i}.intermediate.dense"),
    ("layers.{i}.output", "encoder.encoder.layer.{i}.output.dense"),
    ("layers.{i}.output_layer_norm", "encoder.encoder.layer.{i}.output.LayerNorm"),
    ("upsample", "encoder.upsample.projection"),
)
_SEWD_REL = "encoder.encoder.rel_embeddings.weight"


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np.float32)))


def _skeleton(cfg: BackboneConfig | DACSConfig) -> torch.nn.Module:
    """The module a config's state dict belongs to, on the meta device."""
    from .recipes import get_recipe

    with torch.device("meta"):
        if isinstance(cfg, DACSConfig):
            return get_recipe(cfg.method).make_model(cfg)
        return make_backbone(cfg)


def _skeleton_keys(cfg: BackboneConfig | DACSConfig) -> list[str]:
    return list(_skeleton(cfg).state_dict())


def _sewd_rename(key: str, to_hf: bool) -> str:
    """A SEW-D state-dict key between the flax module path (dotted) and the
    HF name, either way; a ``backbone.`` prefix is kept. The raw flax
    ``rel_embeddings`` param is the HF embedding's ``weight``."""
    prefix = "backbone." if key.startswith("backbone.") else ""
    rest = key[len(prefix):]
    if rest == ("rel_embeddings" if to_hf else _SEWD_REL):
        return prefix + (_SEWD_REL if to_hf else "rel_embeddings")
    for flax, hf in _SEWD_NAMES:
        src, dst = (flax, hf) if to_hf else (hf, flax)
        m = re.match(re.escape(src).replace(r"\{i\}", r"(\d+)") + r"\.", rest)
        if m:
            head = dst.replace("{i}", m.group(1)) if m.groups() else dst
            return f"{prefix}{head}.{rest[m.end():]}"
    return key


# ---------------------------------------------------------------------------
# flax params (the JAX package's DACSModel / SSLBackbone)
# ---------------------------------------------------------------------------

def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unstack_scan_layers(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    """A JAX ``scan_layers`` tree (``encoder/layers_scan/layer`` leaves with
    a leading ``[L, ...]`` axis) in the per-layer ``layers_{i}`` layout; any
    other tree as it is (the JAX ``models/port.py::unstack_scan_layers``)."""
    if "layers_scan" in tree.get("encoder", {}):
        enc = dict(tree["encoder"])
        stacked = dict(_flatten(enc.pop("layers_scan")["layer"]))
        n = len(next(iter(stacked.values())))
        for i in range(n):
            layer: dict = {}
            for path, v in stacked.items():
                node = layer
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = np.asarray(v)[i]
            enc[f"layers_{i}"] = layer
        return {**tree, "encoder": enc}
    return {k: _unstack_scan_layers(v) if isinstance(v, Mapping) else v
            for k, v in tree.items()}


def stack_scan_layers(tree: Mapping[str, Any]) -> dict:
    """The inverse of the unstacking above: every ``encoder`` holding
    ``layers_{i}`` gets them stacked as ``layers_scan/layer`` with a leading
    ``[L, ...]`` axis (``np.stack``), the JAX ``scan_layers`` layout."""
    out = {}
    for k, v in tree.items():
        if not isinstance(v, Mapping):
            out[k] = v
        elif k == "encoder" and "layers_0" in v:
            enc = dict(v)
            n = sum(1 for name in enc if re.fullmatch(r"layers_\d+", name))
            layers = [dict(_flatten(enc.pop(f"layers_{i}"))) for i in range(n)]
            stacked: dict = {}
            for path in layers[0]:
                node = stacked
                for p in path[:-1]:
                    node = node.setdefault(p, {})
                node[path[-1]] = np.stack([np.asarray(lay[path]) for lay in layers])
            enc["layers_scan"] = {"layer": stacked}
            out[k] = enc
        else:
            out[k] = stack_scan_layers(v)
    return out


def state_dict_from_flax(params: Mapping[str, Any],
                         cfg: BackboneConfig | DACSConfig) -> dict[str, torch.Tensor]:
    """Flax params (nested dict of arrays) -> the port's state dict.
    ``layers_{i}`` / ``conv_layers_{i}`` / ``lm_heads_{i}`` become
    ``layers.{i}`` / ``conv_layers.{i}`` / ``lm_heads.{i}``, and a
    ``scan_layers`` tree's stacked ``layers_scan/layer`` is read as its
    ``L`` layers; SpecAugment's ``masked_spec_embed`` (present when
    ``mask_time_prob > 0``) keeps its name. A SEW-D tree's names are mapped
    onto HF's (:data:`_SEWD_NAMES`)."""
    bcfg = cfg.backbone if isinstance(cfg, DACSConfig) else cfg
    sewd = bcfg.model_type == "sew-d"
    sd = {}
    for path, value in _flatten(_unstack_scan_layers(params)):
        mods = [re.sub(r"^(conv_layers|layers|lm_heads)_(\d+)$", r"\1.\2", p)
                for p in path[:-1]]
        leaf = path[-1]
        w = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            w = w.T if w.ndim == 2 else w.transpose(2, 1, 0)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        key = ".".join(mods + [leaf])
        sd[_sewd_rename(key, to_hf=True) if sewd else key] = _tensor(w)
    want = set(_skeleton_keys(cfg))
    if set(sd) != want:
        raise KeyError(f"flax params do not match the port's model: missing "
                       f"{sorted(want - set(sd))[:5]}, unexpected "
                       f"{sorted(set(sd) - want)[:5]}")
    return sd


def flax_from_state_dict(sd: Mapping[str, torch.Tensor], scan_layers: bool = False) -> dict:
    """The port's state dict -> a flax params tree of numpy arrays (the
    inverse of :func:`state_dict_from_flax`): 2-D weights become Dense
    ``kernel`` (transposed), 3-D conv weights ``kernel [k, in/g, out]``, 1-D
    ``weight`` (LayerNorm / GroupNorm) ``scale``. ``scan_layers`` writes the
    encoder layers in the JAX ``scan_layers`` layout (stacked). A SEW-D
    state dict gets the JAX ``SEWDBackbone``'s names."""
    sewd = any(k.endswith(_SEWD_REL) for k in sd)
    tree: dict = {}
    for key, value in sd.items():
        if sewd:
            key = _sewd_rename(key, to_hf=False)
        *mods, leaf = key.split(".")
        w = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            if w.ndim == 2:
                w, leaf = w.T, "kernel"
            elif w.ndim == 3:
                w, leaf = w.transpose(2, 1, 0), "kernel"
            else:
                leaf = "scale"
        names = []
        for m in mods:
            if m.isdigit():
                names[-1] = f"{names[-1]}_{m}"
            else:
                names.append(m)
        node = tree
        for m in names:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(w)
    return stack_scan_layers(tree) if scan_layers else tree


# ---------------------------------------------------------------------------
# HF / ForCTC torch state dicts (and the JAX package's `cli export-hf`)
# ---------------------------------------------------------------------------

def _merge_weight_norm(sd: Mapping[str, Any], prefix: str) -> torch.Tensor:
    """torch weight_norm(g, v) -> effective conv weight [out, in/g, k]; both
    the legacy ``weight_g/weight_v`` and ``parametrizations.weight.original*``
    key styles."""
    for g_key, v_key in ((f"{prefix}.weight_g", f"{prefix}.weight_v"),
                         (f"{prefix}.parametrizations.weight.original0",
                          f"{prefix}.parametrizations.weight.original1")):
        if g_key in sd:
            g = _tensor(sd[g_key]).double()
            v = _tensor(sd[v_key]).double()
            dims = tuple(i for i in range(v.dim()) if g.shape[i] == 1)
            norm = v.square().sum(dim=dims, keepdim=True).sqrt()
            return (g * v / norm.clamp_min(1e-12)).float()
    return _tensor(sd[f"{prefix}.weight"])


def state_dict_from_hf(sd: Mapping[str, Any],
                       cfg: BackboneConfig | DACSConfig) -> dict[str, torch.Tensor]:
    """HF encoder or ForCTC state dict -> the port's state dict. The encoder
    prefix (``data2vec_audio.``, ``wav2vec2.``, ...) is found and stripped;
    with a ``DACSConfig`` the ForCTC heads present in ``sd`` are carried too
    (``criterion_similar.fc`` -> ``similar_fc``). Backbone keys must all be
    there; heads the checkpoint lacks are left out, for the caller to keep
    from an init."""
    bcfg = cfg.backbone if isinstance(cfg, DACSConfig) else cfg
    prefix = next((p for p in _ENCODER_PREFIXES
                   if any(k.startswith(p + "feature_extractor.") for k in sd)), None)
    if prefix is None:
        raise ValueError("could not locate a speech encoder in the state_dict")
    enc = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    out = {}
    for key in _skeleton_keys(bcfg):
        if key == "encoder.pos_conv_embed.conv.weight":
            out[key] = _merge_weight_norm(enc, "encoder.pos_conv_embed.conv")
        elif key in enc:
            out[key] = _tensor(enc[key])
        else:
            raise KeyError(f"state_dict lacks encoder key {prefix + key!r}")
    if not isinstance(cfg, DACSConfig):
        return out
    out = {f"backbone.{k}": v for k, v in out.items()}
    for src, dst in _HEADS.items():
        for leaf in ("weight", "bias"):
            if f"{src}.{leaf}" in sd:
                out[f"{dst}.{leaf}"] = _tensor(sd[f"{src}.{leaf}"])
    # the multitask N-best heads (reference
    # Data2VecAudioForCTCMultitask_model.py:270-275) keep their names
    for k, v in sd.items():
        if re.fullmatch(r"lm_heads\.\d+\.(weight|bias)", k):
            out[k] = _tensor(v)
    return out


# ---------------------------------------------------------------------------
# safetensors files, read without the safetensors package
# ---------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file as CPU tensors (HF's ``model.safetensors``).
    The format: an 8-byte little-endian header length, a JSON header
    mapping each name to its ``dtype``, ``shape`` and ``data_offsets``
    (begin, end) into the bytes after the header, then those bytes. Reads
    F32, F16, BF16, I64 and I32; the card's machine may lack the
    ``safetensors`` package, so it is not used."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                             f"not one of {sorted(_SAFETENSORS_DTYPES)}")
        begin, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        numel = int(np.prod(info["shape"], dtype=np.int64))
        if end - begin != numel * dtype.itemsize or end > len(data):
            raise ValueError(f"{path}: tensor {name!r} has {end - begin} bytes at "
                             f"offsets {begin}..{end}, its shape needs "
                             f"{numel * dtype.itemsize}")
        t = (torch.frombuffer(data, dtype=dtype, count=numel, offset=begin)
             if numel else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(info["shape"]).clone()
    return out


# ---------------------------------------------------------------------------
# seeded random init
# ---------------------------------------------------------------------------

def init_dacs_state_dict(cfg: DACSConfig,
                         generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Seeded random weights of the method's model (``cfg.method``) in fp32
    on ``generator.device``: normal(0, 1/sqrt(fan_in)) matmul, conv and
    embedding weights (flax's lecun scale), zero biases, unit norm scales,
    and ``masked_spec_embed`` uniform in [0, 1) as flax initialises it."""
    shapes = {k: v.shape for k, v in _skeleton(cfg).state_dict().items()}
    dev = generator.device
    sd = {}
    for name, shape in shapes.items():
        if name.endswith("bias"):
            sd[name] = torch.zeros(shape, device=dev)
        elif name.endswith("masked_spec_embed"):
            sd[name] = torch.rand(shape, device=dev, generator=generator)
        elif len(shape) == 1:
            sd[name] = torch.ones(shape, device=dev)
        else:
            fan_in = int(np.prod(shape[1:]))
            sd[name] = torch.empty(shape, device=dev).normal_(
                0.0, fan_in ** -0.5, generator=generator)
    return sd
