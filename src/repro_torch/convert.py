"""Carry the JAX package's parameters into the port: the predictor's, and
an LM's or the encoder-decoder's (:func:`lm_params_from_jax`), through one
mapping between the JAX package's stacked LM tree and the port's parameter
names (:func:`jax_layout`) that also maps gradients and optimizer state
(:func:`unstack`) and groups the port's tensors as the JAX leaves
(:func:`group`).

The JAX package keeps the LSTM predictor's parameters as a dict of arrays
(``w_ih (4H, I)``, ``w_hh (4H, H)``, ``b (4H,)``, ``w_out (O, H)``,
``b_out (O,)``; H = 4, I = O = 1 for the paper's model).  ``jax.random``
initialisation cannot be reproduced in PyTorch, so parameters cross over
as numbers: :func:`params_from_jax` takes such a dict of numpy arrays and
returns the port's :class:`~repro_torch.core.predictor.LSTMPredictor`.

The port also trains its own (``repro_torch.core.predictor.train_predictor``,
on the card by default).  A port-trained ``LSTMPredictor`` is a drop-in for
:func:`load_params`: it has the same parameter names and shapes, goes
straight into ``SpeedPredictor``, and its ``named_parameters()`` as numpy
arrays are a dict that :func:`params_from_jax` takes back.  From the same
initial parameters the port's training reaches the JAX package's metrics;
from its own ``torch.Generator`` start it lands elsewhere, as another
``jax.random`` key would.

``data/lstm_predictor.json`` holds the trained parameters the main path
uses.  They were produced, from the root of the checkout, with the JAX
package's own training call of ``benchmarks/fig_predictor.py``::

    PYTHONPATH=src python -c "import json, numpy as np; \\
    from repro.core.predictor import train_predictor; \\
    from repro.core.traces import TraceConfig, sample_traces; \\
    p, _ = train_predictor(sample_traces(TraceConfig(n_nodes=20, n_iters=400, \\
        noise_sigma=0.08, p_become_straggler=0.03, p_recover=0.25, \\
        drift_sigma=0.05), seed=7), epochs=300); \\
    json.dump({k: np.asarray(v).tolist() for k, v in p.items()}, \\
        open('src/repro_torch/data/lstm_predictor.json', 'w'), indent=1)"

``data/lstm_predictor_init.json`` (:data:`INIT_PARAMS`) holds that
training's start, the JAX package's ``init_lstm(LSTMParams(),
PRNGKey(0))``, made the same way::

    PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import json, jax, numpy as np; \\
    from repro.core.predictor import LSTMParams, init_lstm; \\
    p = init_lstm(LSTMParams(), jax.random.PRNGKey(0)); \\
    json.dump({k: np.asarray(v).tolist() for k, v in p.items()}, \\
        open('src/repro_torch/data/lstm_predictor_init.json', 'w'), indent=1)"

``train_predictor(..., init=load_params(INIT_PARAMS))`` on those traces
reaches the committed parameters' metrics.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import TYPE_CHECKING, Mapping, TypeVar

import numpy as np
import torch

from repro_torch.core.predictor import LSTMParams, LSTMPredictor

if TYPE_CHECKING:
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.lm import LM

__all__ = ["DEFAULT_PARAMS", "INIT_PARAMS", "params_from_jax", "load_params", "load_params_numpy",
           "lm_params_from_jax", "jax_layout", "unstack", "group"]

T = TypeVar("T")

DEFAULT_PARAMS = Path(__file__).resolve().parent / "data" / "lstm_predictor.json"
INIT_PARAMS = DEFAULT_PARAMS.with_name("lstm_predictor_init.json")
_NAMES = ("w_ih", "w_hh", "b", "w_out", "b_out")


def params_from_jax(params: Mapping[str, np.ndarray],
                    device: str | torch.device = "cuda") -> LSTMPredictor:
    """JAX predictor params (a dict of arrays) -> the port's module."""
    missing = [n for n in _NAMES if n not in params]
    if missing:
        raise KeyError(f"predictor params lack {missing}")
    w_hh = np.asarray(params["w_hh"], np.float32)
    w_ih = np.asarray(params["w_ih"], np.float32)
    w_out = np.asarray(params["w_out"], np.float32)
    cfg = LSTMParams(hidden=w_hh.shape[1], input_dim=w_ih.shape[1],
                     output_dim=w_out.shape[0])
    model = LSTMPredictor(cfg, device=device)
    with torch.no_grad():
        for name in _NAMES:
            dst = getattr(model, name)
            src = np.asarray(params[name], np.float32)
            if src.shape != tuple(dst.shape):
                raise ValueError(f"{name} has shape {src.shape}, expected {tuple(dst.shape)}")
            dst.copy_(torch.tensor(src))
    return model


def load_params_numpy(path: str | Path = DEFAULT_PARAMS) -> dict[str, np.ndarray]:
    """The committed (or given) JSON params as a dict of float32 arrays."""
    raw = json.loads(Path(path).read_text())
    return {name: np.asarray(raw[name], np.float32) for name in _NAMES}


def load_params(path: str | Path = DEFAULT_PARAMS,
                device: str | torch.device = "cuda") -> LSTMPredictor:
    """The committed (or given) JSON params as the port's module."""
    return params_from_jax(load_params_numpy(path), device=device)


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested dict of arrays as {"a/b/c": array}."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, name + "/"))
        else:
            out[name] = value
    return out


def jax_layout(model: LM | EncDecLM) -> dict[str, tuple[str, int | None, int]]:
    """Where each of ``model``'s parameters sits in the JAX package's tree.

    Returns {the port's name ("layers.5.mlstm.wq"): (the JAX key
    ("slots/s1/mlstm/wq"), the index in its stack or None, the stack's
    length or 0)}.  The JAX package stacks each slot of the decoder's layer
    period over the periods: ``slots/s{i}/...[p]`` is the port's layer
    ``p·plen + i``, and ``rem/r{j}/...`` its layer ``n_periods·plen + j``.
    The encoder-decoder stacks every layer of each stack on one axis, with
    no period: ``enc/...[i]`` is the port's ``enc.<i>`` and ``dec/...[i]``
    its ``dec.<i>``.  One mapping serves the parameters, their gradients
    and the optimizer's state (:func:`unstack`, :func:`group`).
    """
    cfg = model.cfg
    if cfg.is_encdec:
        stacks = {"enc": cfg.enc_layers, "dec": cfg.num_layers}

        def locate(parts):
            if parts[0] in stacks:
                return f"{parts[0]}/" + "/".join(parts[2:]), int(parts[1]), stacks[parts[0]]
            return "/".join(parts), None, 0
    else:
        from repro_torch.models.lm import period_layout   # the LM stack only for LM users

        period, n_periods, _ = period_layout(cfg)
        plen = len(period)

        def locate(parts):
            if parts[0] != "layers":
                return "/".join(parts), None, 0
            layer, rest = int(parts[1]), "/".join(parts[2:])
            if layer < n_periods * plen:
                index, slot = divmod(layer, plen)
                return f"slots/s{slot}/{rest}", index, n_periods
            return f"rem/r{layer - n_periods * plen}/{rest}", None, 0

    return {name: locate(name.split(".")) for name, _ in model.named_parameters()}


def unstack(tree: Mapping, model: LM | EncDecLM) -> dict[str, np.ndarray]:
    """A tree shaped like the JAX package's parameters (the parameters
    themselves, their gradients, or one field of the optimizer's state) as
    {the port's parameter name: array}, each stacked leaf sliced to its
    layer.  Raises KeyError for a name missing on either side and
    ValueError for a shape that differs from the port's parameter."""
    flat = _flatten(tree)
    shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
    out, used = {}, set()
    for name, (key, index, stacked) in jax_layout(model).items():
        if key not in flat:
            raise KeyError(f"the JAX parameters have no {key} (the port's {name})")
        src = np.asarray(flat[key])
        if index is not None:
            if src.ndim == 0 or src.shape[0] != stacked:
                raise ValueError(f"{key} has shape {src.shape}, not {stacked} stacked "
                                 "layers or periods")
            src = src[index]
        if src.shape != shapes[name]:
            raise ValueError(f"{key} has shape {src.shape}, the port's {name} {shapes[name]}")
        out[name] = src
        used.add(key)
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"the JAX parameters {extra} have no place in the port's {model.cfg.name}")
    return out


def group(named: Mapping[str, T], model: LM | EncDecLM) -> dict[str, T | list[T]]:
    """The inverse of :func:`unstack`'s slicing: values by the port's
    parameter name (the parameters, their gradients) grouped as the JAX
    package's leaves, {JAX key: the value of an unstacked leaf, or the list
    of the stack's values in stack order}.  The optimizer works on this
    grouping, so that Adafactor factors and clips each JAX leaf whole."""
    out: dict = {}
    for name, (key, index, stacked) in jax_layout(model).items():
        if index is None:
            out[key] = named[name]
        else:
            out.setdefault(key, [None] * stacked)[index] = named[name]
    return out


def lm_params_from_jax(params: Mapping, model: LM | EncDecLM) -> LM | EncDecLM:
    """Copy the JAX package's LM parameters into ``model``, in place.

    ``params`` is the tree of the JAX package's ``initialize(model.specs(),
    key)`` with numpy arrays as leaves (float32 or bfloat16), mapped by
    :func:`unstack`.  Raises KeyError for a name missing on either side and
    ValueError for a shape that differs.  Returns ``model``.
    """
    arrays = unstack(params, model)
    with torch.no_grad():
        for name, dst in model.named_parameters():
            dst.copy_(torch.tensor(np.asarray(arrays[name], np.float32)).to(dst.dtype))
    return model
