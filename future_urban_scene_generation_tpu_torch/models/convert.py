"""Weight bridge: JAX-package (Flax) parameter trees -> the port's modules.

The port's modules carry the reference's state-dict names, so the JAX package's
flax -> torch exporter logic (models/convert.py ``export_state_dict`` :91-183,
copied here as numpy code, not imported) maps a flax tree onto
``module.state_dict()``'s keys and shapes; ``load_state_dict(strict=True)`` then
loads it. The reference's own ``.pth`` files load into the same modules directly,
after :func:`fold_spectral_norm` where they were saved with spectral norm (the
EdgeConnect edge generator).

Spectral-norm triples are carried as trained: from a flax ``kernel`` (the raw W of
``SNConv``) and the ``spectral`` collection's ``u``, ``weight_orig`` = W,
``weight_u`` = u and ``weight_v`` = n(W_mat^T u), so a port module starts from the
JAX trainer's exact state. (The JAX exporter instead treats the kernel as the
folded weight and picks u, v with sigma = 1, which serves the raw W of a trained
spectral layer: fault F8 of ROADMAP.md, not carried.)
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch


def _merge_path(parts: Sequence[str]) -> Tuple[str, ...]:
    merged = []
    for p in parts:
        if p.isdigit() and merged:
            merged[-1] = merged[-1] + "_" + p
        else:
            merged.append(p)
    return tuple(merged)


def _lookup(tree: dict, path: Tuple[str, ...], leaf_name: str):
    node = tree
    for p in path:
        if p not in node:
            raise KeyError(f"flax params missing module {'/'.join(path)}")
        node = node[p]
    if leaf_name not in node:
        raise KeyError(f"flax params missing leaf {'/'.join(path)}/{leaf_name}")
    return np.asarray(node[leaf_name])


def _has_leaf(tree: dict, path: Tuple[str, ...], leaf_name: str) -> bool:
    try:
        _lookup(tree, path, leaf_name)
    except KeyError:
        return False
    return True


def _l2_normalize(v: np.ndarray) -> np.ndarray:
    return v / (np.linalg.norm(v) + 1e-12)


def export_state_dict(
    params: dict,
    template: Dict[str, Sequence[int]],
    convt_keys: Iterable[str] = (),
    flatten_linear_key: Optional[str] = None,
    flatten_linear_chw: Optional[Tuple[int, int, int]] = None,
    spectral: Optional[dict] = None,
) -> Dict[str, np.ndarray]:
    """Flax params -> a state dict with ``template``'s keys (key -> shape):
    conv kernels HWIO -> OIHW, conv-transpose kernels (keys in ``convt_keys``, or
    their ``weight_orig`` twins) (kh,kw,in,out) -> (in,out,kh,kw), linear kernels
    transposed (with an optional HWC -> CHW flatten permutation for
    ``flatten_linear_key``), batch-norm gamma/beta/running stats, weight-norm v/g,
    and spectral-norm triples from the kernel and ``spectral`` (the flax
    'spectral' collection, ``u`` at each layer's path): W, u and n(W_mat^T u), in
    float64 before the float32 cast. A template with a triple and no
    ``spectral`` raises."""
    convt_keys = set(convt_keys)
    tree = params.get("params", params)
    bn_prefixes = {k[: -len("running_mean")] for k in template if k.endswith("running_mean")}
    sn_prefixes = {k[: -len("weight_orig")] for k in template if k.endswith("weight_orig")}
    if sn_prefixes and spectral is None:
        raise ValueError("the template has spectral-norm triples: pass the 'spectral' "
                         "collection for their u")
    out: Dict[str, np.ndarray] = {}
    for key in template:
        shape = tuple(int(s) for s in template[key])
        parts = key.split(".")
        leaf = parts[-1]
        path = _merge_path(parts[:-1])
        module_prefix = key[: -len(leaf)]
        if leaf == "num_batches_tracked":
            out[key] = np.asarray(0, np.int64)
            continue
        if module_prefix in sn_prefixes and leaf in ("weight_u", "weight_v"):
            continue  # written with weight_orig
        if leaf == "weight_orig":
            k_flax = _lookup(tree, path, "kernel")
            if module_prefix + "weight" in convt_keys or key in convt_keys:
                w = k_flax.transpose(2, 3, 0, 1)
                w_mat = np.moveaxis(w, 1, 0).reshape(w.shape[1], -1)  # torch's dim=1
            else:
                w = k_flax.transpose(3, 2, 0, 1)
                w_mat = w.reshape(w.shape[0], -1)
            u = _lookup(spectral, path, "u").astype(np.float64)
            out[key] = w
            out[module_prefix + "weight_u"] = u
            out[module_prefix + "weight_v"] = _l2_normalize(w_mat.astype(np.float64).T @ u)
        elif leaf == "weight":
            if module_prefix in bn_prefixes:
                out[key] = _lookup(tree, path, "gamma")
            elif len(shape) == 4:
                if spectral is not None and _has_leaf(spectral, path, "u"):
                    raise ValueError(f"{key}: the flax layer is spectral-normed, the "
                                     "template's is plain")
                k_flax = _lookup(tree, path, "kernel")
                out[key] = (k_flax.transpose(2, 3, 0, 1) if key in convt_keys
                            else k_flax.transpose(3, 2, 0, 1))
            elif len(shape) == 2:
                arr = _lookup(tree, path, "kernel").T
                if key == flatten_linear_key:
                    c, h, w = flatten_linear_chw
                    arr = arr.reshape(arr.shape[0], h, w, c).transpose(0, 3, 1, 2)
                    arr = arr.reshape(arr.shape[0], -1)
                out[key] = arr
            else:
                out[key] = _lookup(tree, path, "weight")
        elif leaf == "bias":
            out[key] = _lookup(tree, path, "beta" if module_prefix in bn_prefixes else "bias")
        elif leaf in ("running_mean", "running_var"):
            out[key] = _lookup(tree, path, leaf)
        elif leaf == "weight_v":
            out[key] = _lookup(tree, path, "v").transpose(3, 2, 0, 1)
        elif leaf == "weight_g":
            out[key] = _lookup(tree, path, "g").reshape(shape)
        else:
            out[key] = _lookup(tree, path, leaf)
        if tuple(out[key].shape) != shape:
            raise ValueError(f"exported {key} has shape {out[key].shape}, template wants {shape}")
    return {
        k: v if np.asarray(v).dtype == np.int64
        else np.ascontiguousarray(np.asarray(v, np.float32))
        for k, v in out.items()
    }


def load_jax_params(module: torch.nn.Module, params_numpy: dict,
                    convt_keys: Iterable[str] = (),
                    flatten_linear_key: Optional[str] = None,
                    flatten_linear_chw: Optional[Tuple[int, int, int]] = None,
                    spectral: Optional[dict] = None) -> torch.nn.Module:
    """Load a flax parameter tree (numpy leaves) into ``module`` with
    ``load_state_dict(strict=True)``; the template is the module's own state
    dict (key -> shape). ``spectral``: the flax 'spectral' collection (numpy
    leaves) of a module with spectral-norm layers."""
    template = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    sd = export_state_dict(params_numpy, template, convt_keys, flatten_linear_key,
                           flatten_linear_chw, spectral)
    ref = module.state_dict()
    module.load_state_dict(
        {k: torch.as_tensor(np.array(v)).to(ref[k].dtype) for k, v in sd.items()}, strict=True
    )
    return module


def vgg_classifier_tree(params: dict) -> dict:
    """The JAX ``VGG19Classifier`` nests its conv trunk under ``trunk``; hoist it so
    the tree's paths match torchvision's ``features.N`` keys."""
    tree = dict(params.get("params", params))
    trunk = tree.pop("trunk", {})
    return {"params": {**trunk, **tree}}


def load_vgg_classifier(module: torch.nn.Module, params_numpy: dict) -> torch.nn.Module:
    """``load_jax_params`` for the CAD classifier: trunk hoisted, and the first
    linear's input permuted from flax's (H, W, C) flatten to torch's (C, H, W)."""
    return load_jax_params(
        module, vgg_classifier_tree(params_numpy),
        flatten_linear_key="classifier.0.weight", flatten_linear_chw=(512, 7, 7),
    )


def fold_spectral_norm(sd: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """Replace each (``weight_orig``, ``weight_u``, ``weight_v``) triple of a torch
    state dict with torch's eval-mode effective weight, W = W_orig / sigma with
    sigma = u . (W_mat v), in float64 and cast to float32 as the JAX package's
    ``fold_spectral_norm`` (models/convert.py:36) does. The normalized dim is 0 (conv,
    linear) or 1 (transposed conv), read off u's length. Other entries pass through."""
    out = dict(sd)
    for key in list(sd.keys()):
        if not key.endswith("weight_orig"):
            continue
        prefix = key[: -len("weight_orig")]
        w = _to_numpy(sd[key]).astype(np.float64)
        u = _to_numpy(sd[prefix + "weight_u"]).astype(np.float64)
        v = _to_numpy(sd[prefix + "weight_v"]).astype(np.float64)
        if u.size == w.shape[0]:
            w_mat = w.reshape(w.shape[0], -1)
        elif w.ndim >= 2 and u.size == w.shape[1]:
            w_mat = np.moveaxis(w, 1, 0).reshape(w.shape[1], -1)
        else:
            raise ValueError(f"cannot infer spectral-norm dim for {key}: {w.shape} vs u {u.shape}")
        sigma = float(u @ (w_mat @ v))
        out[prefix + "weight"] = torch.from_numpy((w / sigma).astype(np.float32))
        del out[key], out[prefix + "weight_u"], out[prefix + "weight_v"]
    return out


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)
