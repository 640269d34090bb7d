"""Moves a flax parameter tree of the JAX package's AMIDModel (any of its
three backbones, optional InnerComp/InterComp, DR heads) into this package's
`state_dict`, and the JAX trainer's optimizer state (optax Adam's `count`,
`mu`, `nu`; the lazy table Adam's `LazyTableState`) into the port's
`AdamState` / `LazyTableState`, all from numpy arrays.

Leaves are found by their flax paths, e.g. `enc_d1/attn_0/in_proj_kernel`,
`itc_d1/PeerMessage_0/trans_bs_kernel`, `predict_ips/fc1_kernel`,
`enc_d1/block_0/ff1/kernel`, `enc_d2/gru/w_hh`. Flax kernels are [in, out]
and torch weights [out, in], so kernels are transposed; trans_bs's [bs]
kernel becomes Linear(bs, 1)'s [1, bs] weight. The GRU's four tensors keep
the JAX package's layout (`TorchGRU` holds `w_ih` [D, 3H] and `w_hh`
[H, 3H] as they are) and are copied untransposed. A leaf no rule knows, a
tree whose encoders are of more than one backbone, or a leaf missing from the
structure the tree implies (that backbone's full set, both towers with the
same number of blocks, both directions of a comp module, both DR heads),
raises.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_ENC = r"(enc_d[12])"
_COMP = r"((?:itc|inc)_d[12])/PeerMessage_0"
_HEAD = r"(predict|predict_ips|predict_gfunc)"


def _t(x):
    return x.T


def _row(x):
    return x[None, :]


# (flax path pattern, torch name template, transform)
_RULES = [
    (r"item_embedding", "item_embedding", None),
    (_ENC + r"/pos_emb", r"\1.pos_emb", None),
    (_ENC + r"/attn_(\d+)/in_proj_kernel", r"\1.attn.\2.in_proj_weight", _t),
    (_ENC + r"/attn_(\d+)/in_proj_bias", r"\1.attn.\2.in_proj_bias", None),
    (_ENC + r"/attn_(\d+)/out_proj_kernel", r"\1.attn.\2.out_proj.weight", _t),
    (_ENC + r"/attn_(\d+)/out_proj_bias", r"\1.attn.\2.out_proj.bias", None),
    (_ENC + r"/(attn_ln|ffn_ln)_(\d+)/scale", r"\1.\2.\3.weight", None),
    (_ENC + r"/(attn_ln|ffn_ln)_(\d+)/bias", r"\1.\2.\3.bias", None),
    (_ENC + r"/ffn_(\d+)/(conv[12])/kernel", r"\1.ffn.\2.\3.weight", _t),
    (_ENC + r"/ffn_(\d+)/(conv[12])/bias", r"\1.ffn.\2.\3.bias", None),
    (_ENC + r"/last_ln/scale", r"\1.last_ln.weight", None),
    (_ENC + r"/last_ln/bias", r"\1.last_ln.bias", None),
    (_ENC + r"/block_(\d+)/(ln[12])/scale", r"\1.block.\2.\3.weight", None),
    (_ENC + r"/block_(\d+)/(ln[12])/bias", r"\1.block.\2.\3.bias", None),
    (_ENC + r"/block_(\d+)/(q|k|v|out|ff1|ff2)/kernel", r"\1.block.\2.\3.weight", _t),
    (_ENC + r"/block_(\d+)/(q|k|v|out|ff1|ff2)/bias", r"\1.block.\2.\3.bias", None),
    (_ENC + r"/gru/(w_ih|w_hh|b_ih|b_hh)", r"\1.gru.\2", None),
    (_COMP + r"/trans_nn_kernel", r"\1.message.trans_nn.weight", _t),
    (_COMP + r"/trans_nn_bias", r"\1.message.trans_nn.bias", None),
    (_COMP + r"/trans_bs_kernel", r"\1.message.trans_bs.weight", _row),
    (_COMP + r"/trans_bs_bias", r"\1.message.trans_bs.bias", None),
    (_HEAD + r"/fc([12])_kernel", r"\1.fc\2.weight", _t),
    (_HEAD + r"/fc([12])_bias", r"\1.fc\2.bias", None),
]


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path + "/"))
        else:
            flat[path] = val
    return flat


def _map_leaf(path: str) -> tuple[str, Any]:
    for pattern, template, fn in _RULES:
        m = re.fullmatch(pattern, path)
        if m:
            return m.expand(template), fn
    raise ValueError(f"flax leaf {path!r} has no counterpart in amid_tpu_torch")


# each backbone's encoder leaves, by the torch name's form
_BACKBONE_NAMES = {
    "sasrec": r"enc_d[12]\.(pos_emb|last_ln\..*|(attn|attn_ln|ffn_ln|ffn)\.\d+\..*)",
    "bert4rec": r"enc_d[12]\.block\.\d+\..*",
    "gru4rec": r"enc_d[12]\.gru\..*",
}


def _backbone(names: set[str]) -> str:
    """The backbone whose encoder leaves `names` holds; raises on a mix."""
    found = {b for b, pat in _BACKBONE_NAMES.items()
             for n in names if re.fullmatch(pat, n)}
    if len(found) > 1:
        raise ValueError(f"the tree's encoders mix backbones: {sorted(found)}")
    return found.pop() if found else "sasrec"


def _encoder_names(backbone: str, blocks: int) -> set[str]:
    """Every torch name of the two towers of `backbone` with `blocks` blocks."""
    want = set()
    for enc in ("enc_d1", "enc_d2"):
        if backbone == "gru4rec":
            want |= {f"{enc}.gru.{w}" for w in ("w_ih", "w_hh", "b_ih", "b_hh")}
        elif backbone == "bert4rec":
            want |= {f"{enc}.block.{i}.{m}.{w}" for i in range(blocks)
                     for m in ("ln1", "ln2", "q", "k", "v", "out", "ff1", "ff2")
                     for w in ("weight", "bias")}
        else:
            want |= {f"{enc}.pos_emb", f"{enc}.last_ln.weight", f"{enc}.last_ln.bias"}
            for i in range(blocks):
                want |= {
                    f"{enc}.attn.{i}.in_proj_weight", f"{enc}.attn.{i}.in_proj_bias",
                    f"{enc}.attn.{i}.out_proj.weight", f"{enc}.attn.{i}.out_proj.bias",
                    f"{enc}.attn_ln.{i}.weight", f"{enc}.attn_ln.{i}.bias",
                    f"{enc}.ffn_ln.{i}.weight", f"{enc}.ffn_ln.{i}.bias",
                    f"{enc}.ffn.{i}.conv1.weight", f"{enc}.ffn.{i}.conv1.bias",
                    f"{enc}.ffn.{i}.conv2.weight", f"{enc}.ffn.{i}.conv2.bias",
                }
    return want


def _expected_names(names: set[str], with_table: bool = True) -> set[str]:
    """Every torch name the structure implied by `names` must have."""
    blocks = {int(m.group(1)) for n in names
              if (m := re.fullmatch(r"enc_d[12]\.(?:attn|attn_ln|ffn_ln|ffn|block)\.(\d+)\..*", n))}
    want = {"item_embedding"} if with_table else set()
    want |= _encoder_names(_backbone(names), max(blocks, default=-1) + 1)
    for kind in ("inc", "itc"):
        if any(n.startswith(kind + "_") for n in names):
            for dom in ("d1", "d2"):
                want |= {f"{kind}_{dom}.message.{p}.{w}"
                         for p in ("trans_nn", "trans_bs") for w in ("weight", "bias")}
    heads = ["predict"]
    if any(n.startswith(("predict_ips.", "predict_gfunc.")) for n in names):
        heads += ["predict_ips", "predict_gfunc"]
    for h in heads:
        want |= {f"{h}.fc{i}.{w}" for i in (1, 2) for w in ("weight", "bias")}
    return want


def convert_leaves(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Maps every leaf of a (partial) flax tree to its torch name and layout;
    raises on a leaf no rule knows. Does not check that the tree is whole."""
    out = {}
    for path, leaf in _flatten(tree).items():
        name, fn = _map_leaf(path)
        x = np.asarray(leaf, dtype=np.float32)
        out[name] = torch.tensor(np.ascontiguousarray(fn(x) if fn else x))
    return out


def params_from_flax(tree: Mapping[str, Any],
                     with_table: bool = True) -> dict[str, torch.Tensor]:
    """flax params (nested dicts of arrays) -> state_dict for AMIDModel.

    with_table=False converts the tree of the non-table parameters (the lazy
    table Adam's dense part): `item_embedding` must then be absent."""
    out = convert_leaves(tree)
    if not with_table and "item_embedding" in out:
        raise ValueError("the dense tree must not hold item_embedding")
    missing = _expected_names(set(out), with_table) - set(out)
    if missing:
        raise ValueError(f"flax tree lacks leaves for {sorted(missing)}")
    return out


def adam_state_from_optax(count, mu: Mapping[str, Any], nu: Mapping[str, Any],
                          with_table: bool = True):
    """optax `ScaleByAdamState(count, mu, nu)` -> `train.optim.AdamState`.

    `mu` and `nu` are trees shaped like the parameters, so they take the
    parameters' conversion (and its checks for missing or left-over leaves)."""
    from amid_tpu_torch.train.optim import AdamState

    mu_t = params_from_flax(mu, with_table)
    nu_t = params_from_flax(nu, with_table)
    if set(mu_t) != set(nu_t):
        raise ValueError(f"mu and nu name different leaves: {sorted(set(mu_t) ^ set(nu_t))}")
    return AdamState(_count(count), mu_t, nu_t)


def _count(count) -> torch.Tensor:
    """optax's int32 step count as the port's count tensor."""
    return torch.tensor(int(np.asarray(count)), dtype=torch.int32)


def lazy_state_from_numpy(dense_count, dense_mu, dense_nu, mu, nu, count):
    """The JAX lazy table Adam's `LazyTableState(dense_opt, mu, nu, count)` ->
    the port's. `dense_*` are the optax Adam state over the non-table
    parameters; `mu`, `nu` the [V, D] table moments; `count` the global step."""
    from amid_tpu_torch.train.lazy import LazyTableState

    mu, nu = (np.asarray(x, dtype=np.float32) for x in (mu, nu))
    if mu.ndim != 2 or mu.shape != nu.shape:
        raise ValueError(f"table moments must share one [V, D] shape; got "
                         f"{mu.shape} and {nu.shape}")
    return LazyTableState(
        dense_opt=adam_state_from_optax(dense_count, dense_mu, dense_nu, with_table=False),
        mu=torch.tensor(mu),
        nu=torch.tensor(nu),
        count=_count(count),
    )
