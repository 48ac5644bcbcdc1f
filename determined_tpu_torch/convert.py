"""Weight bridge between the JAX package's param tree and the port's modules.

The tree is the one ``determined_tpu.models.transformer.TransformerLM.init``
produces (unboxed), with or without the outer ``"params"`` key, its leaves
given as numpy arrays.  Layouts mapped:

- ``DenseGeneral`` ``wq``/``wk``/``wv`` kernels ``[d, h, hd]`` and ``wo``
  ``[h, hd, d]`` against ``nn.Linear.weight`` ``[h*hd, d]`` and ``[d, h*hd]``;
- ``nn.Dense`` kernels ``[in, out]`` (MLP, ``lm_head`` ``[d, V]``) against
  ``nn.Linear.weight`` ``[out, in]``;
- ``Embed.embedding`` ``[V, d]`` as is; RMSNorm ``scale`` as ``weight``;
- an MoE block's ``moe/{router, w_in, w_gate, w_out}`` (``[d, e]``,
  ``[e, d, f]``, ``[e, d, f]``, ``[e, f, d]``) as ``moe.<name>``, as they
  are: ``models/moe.py`` keeps flax's layout.

The MNIST models, the ResNet and the diffusion UNet (``models/mnist.py``,
``models/resnet.py``, ``models/diffusion.py``) name every submodule as
flax does, so their trees map leaf by leaf through one mapping
(``mnist_state_dict_from_flax``, ``resnet_state_dict_from_flax``,
``unet_state_dict_from_flax`` and the inverses): conv kernels HWIO against
OIHW, dense kernels ``[in, out]`` against ``[out, in]``, GroupNorm
``scale``/``bias`` as ``weight``/``bias``, biases as they are.  The port's
CNN flattens its last feature map in NHWC order, as flax does, so
``fc1``'s rows need no permutation.

The HuggingFace families (``models/hf_gpt2.py``, ``models/hf_bert.py``)
take the parameter names of transformers' torch classes, which are the flax
paths joined by "." (``gpt2_state_dict_from_flax``,
``bert_state_dict_from_flax``): ``embedding`` and LayerNorm ``scale``
become ``weight``, and every 2-D ``kernel`` becomes a transposed
``weight``.  The transpose is right for both layouts: flax GPT-2's
``FlaxConv1D`` stores its kernel (out, in) and torch GPT-2's ``Conv1D``
weight is (in, out); a flax ``nn.Dense`` kernel is (in, out) and a torch
``nn.Linear`` weight (out, in).

A pipe-parallel JAX trial keeps its LM in ``split_pipeline_params``'s
layout, ``{"outer": {"params": <embed, ln_f, lm_head>}, "blocks":
{"layer_j": <layer j of every chunk stacked [P, ...], or [P, V, ...]
interleaved: [p, v] is chunk v * P + p>}}``; the port keeps the whole
model's names on every stage (``TransformerLM.shard_pipe``).
``state_dict_from_split`` and ``split_from_state_dict`` map the two both
ways; ``stage_state_dict`` is one pipe rank's part of a state dict, and
``state_dict_box`` one rank's boxes of its leaves on any other mesh (an
expert leaf on tensor x expert cut on two dims).

Optimizer moments (``mu``/``nu`` trees of a ``FusedAdamWState`` or of the
``ScaleByAdamState`` inside an optax chain state) are param-shaped and map
through the same transforms (``opt_state_from_flax``,
``flax_from_opt_state``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from determined_tpu_torch.models.transformer import TransformerLM
from determined_tpu_torch.ops.fused_adamw import FusedAdamWState

_ATTN = ("wq", "wk", "wv")
_MLP = ("w_gate", "w_up", "w_down")
_MOE = ("router", "w_in", "w_gate", "w_out")


def state_dict_from_flax(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` (as numpy) from the JAX param tree."""
    if "params" in tree:
        tree = tree["params"]
    arr = lambda x: np.asarray(x, dtype=np.float32)  # noqa: E731
    out = {
        "embed.weight": arr(tree["embed"]["embedding"]),
        "ln_f.weight": arr(tree["ln_f"]["scale"]),
        "lm_head.weight": arr(tree["lm_head"]["kernel"]).T,
    }
    n_layers = sum(1 for k in tree if k.startswith("block_"))
    for i in range(n_layers):
        blk, pre = tree[f"block_{i}"], f"blocks.{i}."
        out[pre + "ln1.weight"] = arr(blk["ln1"]["scale"])
        out[pre + "ln2.weight"] = arr(blk["ln2"]["scale"])
        for name in _ATTN:
            kern = arr(blk["attn"][name]["kernel"])  # [d, h, hd]
            out[pre + f"attn.{name}.weight"] = kern.reshape(kern.shape[0], -1).T
        wo = arr(blk["attn"]["wo"]["kernel"])  # [h, hd, d]
        out[pre + "attn.wo.weight"] = wo.reshape(-1, wo.shape[-1]).T
        if "moe" in blk:
            for name in _MOE:
                out[pre + f"moe.{name}"] = arr(blk["moe"][name])
            continue
        for name in _MLP:
            out[pre + f"mlp.{name}.weight"] = arr(blk["mlp"][name]["kernel"]).T
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def flax_from_state_dict(
    state: Mapping[str, Any], n_heads: int, n_kv_heads: int
) -> Dict[str, Any]:
    """The inverse: the JAX param tree (inner dict, numpy leaves) from the
    port's ``state_dict``."""
    arr = lambda x: (  # noqa: E731
        x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    )
    tree: Dict[str, Any] = {
        "embed": {"embedding": arr(state["embed.weight"])},
        "ln_f": {"scale": arr(state["ln_f.weight"])},
        "lm_head": {"kernel": arr(state["lm_head.weight"]).T},
    }
    n_layers = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("blocks."))
    heads = {"wq": n_heads, "wk": n_kv_heads, "wv": n_kv_heads}
    for i in range(n_layers):
        pre = f"blocks.{i}."
        attn = {}
        for name in _ATTN:
            w = arr(state[pre + f"attn.{name}.weight"])  # [h*hd, d]
            attn[name] = {"kernel": w.T.reshape(w.shape[1], heads[name], -1)}
        wo = arr(state[pre + "attn.wo.weight"])  # [d, h*hd]
        attn["wo"] = {"kernel": wo.T.reshape(n_heads, -1, wo.shape[0])}
        tree[f"block_{i}"] = {
            "ln1": {"scale": arr(state[pre + "ln1.weight"])},
            "ln2": {"scale": arr(state[pre + "ln2.weight"])},
            "attn": attn,
        }
        if pre + "moe.router" in state:
            tree[f"block_{i}"]["moe"] = {name: arr(state[pre + f"moe.{name}"]) for name in _MOE}
        else:
            tree[f"block_{i}"]["mlp"] = {
                name: {"kernel": arr(state[pre + f"mlp.{name}.weight"]).T} for name in _MLP
            }
    return {k: _contiguous(v) for k, v in tree.items()}


def _tree_map(fn: Any, *trees: Any) -> Any:
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _chunk_of(layer: int, lpc: int, n_stages: int) -> Tuple[int, int, int]:
    """(stage p, virtual stage v, position j) of ``layer``: chunk c = v * P
    + p holds layers [c * lpc, (c + 1) * lpc)."""
    chunk, j = divmod(layer, lpc)
    v, p = divmod(chunk, n_stages)
    return p, v, j


def state_dict_from_split(split: Mapping[str, Any], n_stages: int,
                          virtual_stages: int = 1) -> Dict[str, np.ndarray]:
    """The port's whole ``state_dict`` (as numpy) from JAX's
    ``split_pipeline_params`` layout, unboxed."""
    outer = split["outer"]
    outer = outer.get("params", outer)
    blocks = split["blocks"]
    lpc = len(blocks)
    tree = dict(outer)
    for layer in range(lpc * n_stages * virtual_stages):
        p, v, j = _chunk_of(layer, lpc, n_stages)
        pos = (p, v) if virtual_stages > 1 else (p,)
        tree[f"block_{layer}"] = _tree_map(lambda a: np.asarray(a)[pos], blocks[f"layer_{j}"])
    return state_dict_from_flax(tree)


def split_from_state_dict(state: Mapping[str, Any], n_heads: int, n_kv_heads: int,
                          n_stages: int, virtual_stages: int = 1) -> Dict[str, Any]:
    """The inverse: JAX's split layout (numpy leaves) from the port's
    whole ``state_dict``."""
    tree = flax_from_state_dict(state, n_heads, n_kv_heads)
    n_layers = sum(1 for k in tree if k.startswith("block_"))
    chunks = n_stages * virtual_stages
    if n_layers % chunks:
        raise ValueError(f"n_layers={n_layers} not divisible into {chunks} pipeline chunks")
    lpc = n_layers // chunks
    blocks = {}
    for j in range(lpc):
        def stack(*leaves: Any, j: int = j) -> np.ndarray:
            by = {_chunk_of(layer, lpc, n_stages)[:2]: leaves[layer // lpc]
                  for layer in range(j, n_layers, lpc)}
            if virtual_stages == 1:
                return np.stack([by[(p, 0)] for p in range(n_stages)])
            return np.stack([np.stack([by[(p, v)] for v in range(virtual_stages)])
                             for p in range(n_stages)])

        blocks[f"layer_{j}"] = _tree_map(
            stack, *(tree[f"block_{c * lpc + j}"] for c in range(chunks)))
    outer = {k: v for k, v in tree.items() if not k.startswith("block_")}
    return {"outer": {"params": outer}, "blocks": blocks}


def stage_state_dict(state: Mapping[str, Any], rank: int, n_stages: int,
                     virtual_stages: int = 1) -> Dict[str, Any]:
    """Pipe rank ``rank``'s part of a whole ``state_dict``: the layers of
    its chunks, ``embed`` on rank 0, ``ln_f`` and ``lm_head`` on the last
    (``TransformerLM.shard_pipe``)."""
    n_layers = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("blocks."))
    lpc = n_layers // (n_stages * virtual_stages)

    def mine(key: str) -> bool:
        if key.startswith("blocks."):
            return _chunk_of(int(key.split(".")[1]), lpc, n_stages)[0] == rank
        if key.startswith("embed."):
            return rank == 0
        return rank == n_stages - 1

    return {k: v for k, v in state.items() if mine(k)}


def state_dict_box(state: Mapping[str, Any],
                   boxes: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Each leaf's part of a whole ``state_dict`` that one rank of a mesh
    holds: ``boxes[name]``, a ``(start, stop)`` a dim (``ShardPlan.box``:
    the tensor split, the expert split and the FSDP chunk, on two dims
    where a leaf is split over tensor and expert)."""
    return {k: np.asarray(state[k])[tuple(slice(lo, hi) for lo, hi in box)]
            for k, box in boxes.items()}


def _contiguous(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _contiguous(v) for k, v in node.items()}
    return np.ascontiguousarray(node)


def load_flax_params(model: TransformerLM, tree: Mapping[str, Any]) -> TransformerLM:
    """Copy the JAX param tree into ``model`` (in place, on its device)."""
    state = {k: torch.tensor(v) for k, v in state_dict_from_flax(tree).items()}
    model.load_state_dict(state, strict=True)
    return model


def _adam_state(opt_state: Any) -> Any:
    """The (count, mu, nu) node of a JAX optimizer state: a FusedAdamWState
    itself, or the ScaleByAdamState nested in an optax chain's tuples."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for node in opt_state:
            found = _adam_state(node)
            if found is not None:
                return found
    return None


def opt_state_from_flax(
    opt_state: Any, *, device: Any = "cpu", mu_dtype: Optional[torch.dtype] = None
) -> FusedAdamWState:
    """The port's optimizer state from a JAX one (its moments in the port's
    ``state_dict`` layout; mu in ``mu_dtype``, f32 when None; nu f32)."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no (count, mu, nu) Adam state in this optimizer state")
    mu = state_dict_from_flax(adam.mu)
    nu = state_dict_from_flax(adam.nu)
    dev = torch.device(device)
    return FusedAdamWState(
        torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32, device=dev),
        {k: torch.tensor(v, device=dev).to(mu_dtype or torch.float32) for k, v in mu.items()},
        {k: torch.tensor(v, device=dev) for k, v in nu.items()},
    )


def flax_from_opt_state(
    state: FusedAdamWState, n_heads: int, n_kv_heads: int
) -> Dict[str, Any]:
    """The inverse: ``{"count": int, "mu": tree, "nu": tree}`` with the
    moments as JAX param trees (numpy f32 leaves)."""
    return {
        "count": int(state.count),
        "mu": flax_from_state_dict(state.mu, n_heads, n_kv_heads),
        "nu": flax_from_state_dict(state.nu, n_heads, n_kv_heads),
    }


def _f32_or_f64(x: Any) -> np.ndarray:
    a = np.asarray(x)
    return a if a.dtype == np.float64 else a.astype(np.float32)


def _conv_net_state_dict_from_flax(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The state_dict (as numpy) of a port module named as its flax module
    (the MNIST models, ``ResNet``, ``UNet``): each leaf at its flax path joined by ".";
    ``kernel`` becomes ``weight`` (Conv HWIO -> OIHW, Dense transposed),
    ``scale`` becomes ``weight``; f32 leaves, f64 where the tree's are."""
    if "params" in tree:
        tree = tree["params"]
    out: Dict[str, np.ndarray] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for key, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{key}.")
                continue
            a = _f32_or_f64(v)
            if key == "kernel":
                a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
            out[prefix + ("weight" if key in ("kernel", "scale") else key)] = a

    walk(tree, "")
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def _flax_from_conv_net_state_dict(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse: the flax param tree (inner dict, numpy leaves).  A 1-D
    ``weight`` is a GroupNorm ``scale``, a 2-D or 4-D one a kernel."""
    tree: Dict[str, Any] = {}
    for key, v in state.items():
        *path, kind = key.split(".")
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            v = v.numpy() if v.dtype == torch.float64 else v.float().numpy()
        v = np.asarray(v)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        if kind != "weight":
            node[kind] = v
        elif v.ndim == 1:
            node["scale"] = v
        else:
            node["kernel"] = v.T if v.ndim == 2 else v.transpose(2, 3, 1, 0)
    return _contiguous(tree)


#: ``models/mnist.py``'s MnistMLP and MnistCNN: fc1, fc2 (and conv1, conv2)
mnist_state_dict_from_flax = _conv_net_state_dict_from_flax
flax_from_mnist_state_dict = _flax_from_conv_net_state_dict
#: ``models/resnet.py``'s ResNet: stem, gn_stem, s{stage}b{block}.{conv1, gn1,
#: conv2, gn2, proj, gn_proj}, head
resnet_state_dict_from_flax = _conv_net_state_dict_from_flax
flax_from_resnet_state_dict = _flax_from_conv_net_state_dict
#: ``models/diffusion.py``'s UNet: stem, temb1, temb2, down{i}, mid1, mid_attn,
#: mid2, up{i}, GroupNorm_0, head, each ResBlock with conv1, temb_proj, conv2,
#: skip and its GroupNorm_0 / GroupNorm_1
unet_state_dict_from_flax = _conv_net_state_dict_from_flax
flax_from_unet_state_dict = _flax_from_conv_net_state_dict


def _hf_state_dict_from_flax(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The state_dict (as f32 numpy) of a port HF module from the flax
    param tree of transformers' Flax class (with or without the outer
    ``"params"`` key): each leaf at its flax path joined by "."; ``kernel``
    becomes ``weight`` transposed, ``scale`` and ``embedding`` become
    ``weight``."""
    if "params" in tree:
        tree = tree["params"]
    out: Dict[str, np.ndarray] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for key, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{key}.")
                continue
            a = np.asarray(v, dtype=np.float32)
            if key == "kernel":
                if a.ndim != 2:
                    raise ValueError(f"{prefix}{key} is {a.ndim}-D; an HF kernel is 2-D")
                a = a.T
            out[prefix + ("weight" if key in ("kernel", "scale", "embedding") else key)] = a

    walk(tree, "")
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


#: ``models/hf_gpt2.py``'s GPT2LMHeadModel from a ``FlaxGPT2LMHeadModel`` tree:
#: ``transformer.{wte, wpe}.weight``, ``transformer.h.{i}.{ln_1, attn.c_attn,
#: attn.c_proj, ln_2, mlp.c_fc, mlp.c_proj}``, ``transformer.ln_f``; the
#: ``FlaxConv1D`` kernels (out, in) become ``Conv1D`` weights (in, out); a tied
#: head has no leaf of its own (it reads ``wte``), as in flax
gpt2_state_dict_from_flax = _hf_state_dict_from_flax
#: ``models/hf_bert.py``'s BertForSequenceClassification from a
#: ``FlaxBertForSequenceClassification`` tree: ``bert.embeddings.*``,
#: ``bert.encoder.layer.{i}.*``, ``bert.pooler.dense``, ``classifier``; the
#: ``nn.Dense`` kernels (in, out) become ``nn.Linear`` weights (out, in)
bert_state_dict_from_flax = _hf_state_dict_from_flax
