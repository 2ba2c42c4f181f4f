"""Weight bridge: the JAX package's GlassRGBD param tree -> this port's
state dict.

The port's modules carry the original PyTorch code's parameter names, so
the bridge is the JAX package's import map (original names -> flax param
paths, `gwdepth_tpu/convert/full_model.py` and `torch_weights.py`) run
backwards. This module keeps its own copy of that map (for the modules the
port builds) and inverts it by probing, as
`gwdepth_tpu/convert/export_torch.py` does: an `arange` probe pushed
through the forward map shows which flat index of the torch tensor lands
where in the flax leaves, so every transpose and reshape inverts exactly.

Layout rules of the map: conv (O, I, kh, kw) -> (kh, kw, I, O), linear
(O, I) -> (I, O), norms and biases verbatim, the fused attention
`in_proj_*` verbatim. The learned position tables
`backbone.1.{row,col}_embed.weight` (the names DETR's `Joiner` gives
them) map to `position_embedding/{row,col}_embed` verbatim; the JAX
package's own converters map no name onto those two leaves.

Models with a gate off (`with_line=False`, `with_dense=False`) have no
tensors of the missing branch in their state dict, so the template asks
for none of them. The dense encoder's gates add the class blocks'
reference mixture (`attn.{ref_qk,diff_mu,diff_logsigma,
ref_attn_diffusion}`, as in the 1/32 blocks), their `token_relation.*`,
and `point_depth_token`, `init_token` and `gpgN.*`.

    sd = jax_params_to_state_dict(params_numpy_tree, model.state_dict())
    model.load_state_dict(sd, strict=True)

Integer buffers (`relative_position_index`) pass through from the
template; any float tensor the map does not reach raises.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping

import numpy as np
import torch

# ---------------------------------------------------------------------------
# forward map: original torch names -> flax param paths
# ---------------------------------------------------------------------------


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _set(tree: dict, path: str, value: np.ndarray) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _put_linear(params, dst, key, val):
    _set(params, f"{dst}/{'kernel' if key == 'weight' else 'bias'}",
         val.T if key == "weight" else val)


def _put_norm(params, dst, key, val):
    _set(params, f"{dst}/{'scale' if key == 'weight' else 'bias'}", val)


def _put_conv(params, dst, key, val):
    _set(params, f"{dst}/{'kernel' if key == 'weight' else 'bias'}",
         _conv(val) if key == "weight" else val)


def _map_resnet(params, parts, val):
    """torchvision ResNet names (after `backbone.0.body.`)."""
    if parts[0] == "conv1":
        _set(params, "backbone/conv1/kernel", _conv(val))
    elif parts[0] == "bn1":
        _set(params, f"backbone/bn1/{parts[1]}", val)
    elif parts[0].startswith("layer"):
        dst = f"backbone/{parts[0]}/block{parts[1]}"
        sub = parts[2]
        if sub.startswith("conv"):
            _set(params, f"{dst}/{sub}/kernel", _conv(val))
        elif sub.startswith("bn"):
            _set(params, f"{dst}/{sub}/{parts[3]}", val)
        elif sub == "downsample":
            if parts[3] == "0":
                _set(params, f"{dst}/downsample_conv/kernel", _conv(val))
            else:
                _set(params, f"{dst}/downsample_bn/{parts[4]}", val)


def _map_mha(params, dst, rest, val):
    if rest[0] in ("in_proj_weight", "in_proj_bias"):
        _set(params, f"{dst}/{rest[0]}", val)
    elif rest[0] == "out_proj":
        _put_linear(params, f"{dst}/out_proj", rest[1], val)


def _map_convln(params, dst, rest, val):
    if rest[0] == "conv":
        _put_conv(params, f"{dst}/conv", rest[1], val)
    elif rest[0] == "layer_norm":
        _put_norm(params, f"{dst}/ln", rest[1], val)


def _map_pyramid(params, dst, rest, val):
    mod = rest[0]
    if mod == "firstconv":
        idx = {"0": "first0", "2": "first1"}.get(rest[1])
        if idx:
            _map_convln(params, f"{dst}/{idx}", rest[2:], val)
    elif mod in ("layer1", "layer2", "layer3"):
        blk = f"{dst}/{mod}_{rest[1]}"
        if rest[2] == "conv1":                  # Sequential(ConvLn, GELU)
            _map_convln(params, f"{blk}/conv1", rest[4:], val)
        elif rest[2] == "conv2":
            _map_convln(params, f"{blk}/conv2", rest[3:], val)
    elif mod.startswith("branch"):
        if rest[1] == "1":                      # Sequential(pool, ConvLn, GELU)
            _map_convln(params, f"{dst}/{mod}", rest[2:], val)
    elif mod == "lastconv":
        if rest[1] == "0":
            _map_convln(params, f"{dst}/last0", rest[2:], val)
        elif rest[1] == "2":
            _put_conv(params, f"{dst}/last1", rest[2], val)


def _map_swin_attn(params, dst, rest, val):
    name = rest[0]
    if name in ("qkv", "proj", "cls_dth_q", "cls_seg_q", "global_k",
                "global_v", "proj_dth"):
        _put_linear(params, f"{dst}/{name}", rest[1], val)
    elif name == "relative_position_bias_table":
        _set(params, f"{dst}/rel_pos_bias/relative_position_bias_table", val)
    elif name in ("diff_mu", "diff_logsigma"):
        _set(params, f"{dst}/ref/{name}", val)
    elif name == "ref_qk":
        _put_linear(params, f"{dst}/ref/ref_qk", rest[1], val)
    elif name == "ref_attn_diffusion":
        if rest[1] == "weight":
            _set(params, f"{dst}/ref/ref_attn_diffusion/conv_kernel",
                 _conv(val))
        else:
            _set(params, f"{dst}/ref/ref_attn_diffusion/conv_bias", val)


def _map_token_fuse(params, dst, rest, val):
    """`token_relation` (PointGuidedTokenFuse) of a class block."""
    name = rest[0]
    if name in ("xseg_proj", "xdth_proj", "kv_refer_depth", "q_seg",
                "mlpctx"):
        _put_linear(params, f"{dst}/{name}/{rest[1]}", rest[2], val)
    elif name in ("norm_seg", "norm_fuse") or name.startswith("convctx_norm"):
        _put_norm(params, f"{dst}/{name}", rest[1], val)
    elif name in ("fuse_proj", "fused_depth_proj", "mutil_depth_fuse"):
        _put_linear(params, f"{dst}/{name}", rest[1], val)
    elif name.startswith("convctx_pre"):
        # Sequential(ConvA, ConvA) -> convctx_preK_{0,1}/conv
        _put_conv(params, f"{dst}/{name}_{rest[1]}/conv", rest[3], val)
    elif name.startswith("convctx_after"):
        _put_conv(params, f"{dst}/{name}/conv", rest[2], val)


def _map_swin_layer(params, dst, rest, val):
    if rest[0] != "blocks":
        return
    blk = f"{dst}/block{rest[1]}"
    name = rest[2]
    if name == "attn":
        _map_swin_attn(params, f"{blk}/attn", rest[3:], val)
    elif name.startswith("norm"):
        _put_norm(params, f"{blk}/{name}", rest[3], val)
    elif name in ("mlp", "mlp_depth", "mlp_seg"):
        _put_linear(params, f"{blk}/{name}/{rest[3]}", rest[4], val)
    elif name == "token_relation":
        _map_token_fuse(params, f"{blk}/token_relation", rest[3:], val)


def _map_dense_encoder(params, rest, val):
    dst = "dense_encoder"
    name = rest[0]
    if name in ("depth_token", "seg_token"):
        _set(params, f"{dst}/{name}", val.reshape(1, 1, -1))
    elif name in ("point_depth_token", "init_token"):
        _set(params, f"{dst}/{name}", val)
    elif name.startswith("gpg"):
        if rest[1] in ("node_relation", "node_attention", "token_node_fuse"):
            _put_linear(params, f"{dst}/{name}/{rest[1]}/{rest[2]}",
                        rest[3], val)
    elif name == "dense_transformer" or name.startswith("class_transformer"):
        _map_swin_layer(params, f"{dst}/{name}", rest[1:], val)
    elif name.startswith("depth_pred"):
        idx = {"0": "fc1", "1": "fc2"}.get(rest[1])
        if idx:
            _put_linear(params, f"{dst}/{name}/{idx}", rest[2], val)
    elif name.startswith("proj_class"):
        _put_linear(params, f"{dst}/{name}", rest[1], val)
    elif name.startswith("proj_backbn"):
        if rest[1] == "conv":
            _put_conv(params, f"{dst}/{name}/conv", rest[2], val)
    elif name.startswith("old_"):
        if rest[1] == "norm":
            _put_norm(params, f"{dst}/{name}/norm", rest[2], val)
        else:
            _put_linear(params, f"{dst}/{name}/{rest[1]}", rest[2], val)
    elif name.startswith("point_based_pred"):
        if rest[1] in ("pre_proj", "refer_proj"):
            _put_linear(params, f"{dst}/{name}/{rest[1]}", rest[2], val)
        elif rest[1] == "pyramid":
            _map_pyramid(params, f"{dst}/{name}/pyramid", rest[2:], val)


def _map_decoder(params, rest, val):
    dst = "depth_decoder"
    name = rest[0]
    if name in ("depth_token_fuse", "seg_token_fuse"):
        _put_linear(params, f"{dst}/{name}/{rest[1]}", rest[2], val)
    elif name.startswith("upconv"):
        if rest[1] == "conv":
            _put_conv(params, f"{dst}/{name}/conv", rest[2], val)
    elif name in ("norm_depth", "norm_seg"):
        _put_norm(params, f"{dst}/{name}", rest[1], val)
    elif name.startswith(("conv1", "conv2", "get_depth", "get_seg")):
        if rest[1] == "0":                      # Sequential(Conv2d, ...)
            _put_conv(params, f"{dst}/{name}", rest[2], val)


def torch_names_to_flax(state: Mapping[str, np.ndarray]) -> dict:
    """Original-name tensors -> a (partial) flax param tree."""
    params: dict = {}
    for key, val in state.items():
        parts = key.split(".")
        head = parts[0]
        if key.startswith("backbone.0.body."):
            _map_resnet(params, parts[3:], val)
        elif key.startswith("backbone.1."):
            # DETR's Joiner: the learned position tables, (50, F) both sides
            _set(params, f"position_embedding/{parts[2]}", val)
        elif head == "query_embed":
            params["query_embed"] = val
        elif head in ("input_proj", "dense_input_proj"):
            _put_conv(params, head, parts[1], val)
        elif head == "class_embed":
            _put_linear(params, "class_embed", parts[1], val)
        elif head == "lines_embed":
            _put_linear(params, f"lines_embed/layer{parts[2]}", parts[3], val)
        elif head == "transformer":
            side = parts[1]
            if side == "decoder" and parts[2] == "norm":
                _put_norm(params, "transformer/decoder_norm", parts[3], val)
            elif parts[2] == "layers":
                dst = f"transformer/{side}_layer{parts[3]}"
                mod = parts[4]
                if mod in ("self_attn", "multihead_attn"):
                    _map_mha(params, f"{dst}/{mod}", parts[5:], val)
                elif mod in ("linear1", "linear2"):
                    _put_linear(params, f"{dst}/{mod}", parts[5], val)
                elif mod.startswith("norm"):
                    _put_norm(params, f"{dst}/{mod}", parts[5], val)
        elif head == "dense_encoder":
            _map_dense_encoder(params, parts[1:], val)
        elif head == "depth_decoder":
            _map_decoder(params, parts[1:], val)
    return params


# ---------------------------------------------------------------------------
# inversion by probing
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=()):
    if isinstance(tree, Mapping):
        for k in tree:
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    node = tree
    for k in path:
        if not isinstance(node, Mapping) or k not in node:
            return None
        node = node[k]
    return node


@functools.lru_cache(maxsize=None)
def _invert_key(key: str, shape):
    """[(flax_path, index_map)] for one torch tensor, index_map[i] being the
    torch flat index stored at flat position i of the flax leaf; None when
    the map does not consume the whole tensor bijectively. Cached: it
    depends on the key and shape only (callers do not modify it)."""
    size = int(np.prod(shape)) if shape else 1
    probe = np.arange(size, dtype=np.float64).reshape(shape)
    overlay = torch_names_to_flax({key: probe})
    entries = []
    covered = np.zeros(size, dtype=bool)
    for path, leaf in _leaves(overlay):
        flat = np.asarray(leaf, dtype=np.float64).ravel()
        idx = flat.astype(np.int64)
        if flat.size == 0 or (flat != idx).any() or idx.min() < 0 \
                or idx.max() >= size:
            return None
        covered[idx] = True
        entries.append((path, idx))
    if not entries or not covered.all():
        return None
    return entries


def jax_params_to_state_dict(params, template: Mapping[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """Fill `template`'s keys (a port model's `state_dict()`, or a prefixed
    part of one) from `params` (the JAX GlassRGBD param tree as nested
    dicts of numpy arrays). Integer buffers pass through; an unmapped or
    missing float tensor raises KeyError."""
    out: Dict[str, torch.Tensor] = {}
    for key, tval in template.items():
        if not torch.is_floating_point(tval):
            out[key] = tval.clone()
            continue
        shape = tuple(tval.shape)
        entries = _invert_key(key, shape)
        if entries is None:
            raise KeyError(f"no JAX param maps onto {key}")
        dest = np.empty(int(np.prod(shape)) if shape else 1, np.float64)
        for path, idx in entries:
            leaf = _get(params, path)
            if leaf is None:
                raise KeyError(f"{key}: JAX param {'/'.join(path)} missing")
            dest[idx] = np.asarray(leaf, dtype=np.float64).ravel()
        out[key] = torch.from_numpy(dest.reshape(shape)).to(tval.dtype)
    return out
