"""Carry a graph built by the reference package into the port.

Here the graph plays the part that weights play in a model: the state
handed across. ``from_reference`` takes the reference's B2SR, ELL and
bucketed arrays, read out as numpy (``np.uint32`` words, int32
indices), and returns the port's objects on a device. Array keys:

  ``tile_row_ptr``, ``tile_col_idx``, ``bit_tiles``          B2SR
  ``ell.tile_col_idx``, ``ell.bit_tiles``, ``ell.row_n_tiles``  ELL view
  ``buckets.{i}.col_idx``, ``buckets.{i}.bit_tiles``,
  ``buckets.{i}.rows``                                       bucket ``i``

The reference's ``GraphMatrix`` keeps only its ELL views, so the B2SR is
derived from the ELL when its own keys are absent. The same keys with
the prefix ``t.`` give the transpose. ``meta`` holds ``tile_dim``,
``n_rows``, ``n_cols`` and ``nnz`` of the forward orientation.

``frontier_from_reference`` and ``bitmatrix_from_reference`` take the
reference's packed frontier words (``np.uint32[tiles, t, W]``) and
activation words (``np.uint32[tiles, d]``) into a port ``FrontierBatch``
and ``BitMatrix``, so one operand can be fed to both packages.

The weights of a model cross over too: ``gnn_state_from_reference``
turns a reference GNN's ``params`` (any of the four families) into the
``state_dict`` of the port's module (``gcn_state_from_reference`` the
GCN's), and ``gnn_model_from_reference`` a served model's ``((w, b),
...)`` and features into the arguments of the port's
``engine.queries.register_gnn_model``; ``opt_state_from_reference``
turns the reference optimizer's state for those weights into the port's
``training.optimizer.OptState``, so both packages resume from one
mid-run state. ``lm_state_from_reference`` does the same for a
transformer's tree (the stacked ``[L, …]`` layers unstacked into
``layers.{i}``), ``din_state_from_reference`` for DIN's (the tables
by their names, the MLPs' dense layers transposed).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.core import csr as csr_mod
from repro_torch.core.b2sr import B2SR, B2SRBucketedEll, B2SREll, b2sr_to_coo
from repro_torch.core.graphblas import GraphMatrix, Orientation
from repro_torch.core.operands import BitMatrix, FrontierBatch
from repro_torch.core.words import from_numpy_u32
from repro_torch.device import DeviceLike, resolve_device

Arrays = Mapping[str, np.ndarray]


def _idx(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.int32).copy()).to(dev)


def _ell(arrays: Arrays, p: str, t: int, n_rows: int, n_cols: int,
         dev: torch.device) -> Optional[B2SREll]:
    if p + "ell.tile_col_idx" not in arrays:
        return None
    return B2SREll(tile_col_idx=_idx(arrays[p + "ell.tile_col_idx"], dev),
                   bit_tiles=from_numpy_u32(arrays[p + "ell.bit_tiles"], dev),
                   row_n_tiles=_idx(arrays[p + "ell.row_n_tiles"], dev),
                   tile_dim=t, n_rows=n_rows, n_cols=n_cols)


def _buckets(arrays: Arrays, p: str, t: int, n_rows: int, n_cols: int,
             dev: torch.device) -> Optional[B2SRBucketedEll]:
    n_b = 0
    while f"{p}buckets.{n_b}.col_idx" in arrays:
        n_b += 1
    if not n_b:
        return None
    key = [f"{p}buckets.{i}." for i in range(n_b)]
    return B2SRBucketedEll(
        col_idx=tuple(_idx(arrays[k + "col_idx"], dev) for k in key),
        bit_tiles=tuple(from_numpy_u32(arrays[k + "bit_tiles"], dev)
                        for k in key),
        rows=tuple(_idx(arrays[k + "rows"], dev) for k in key),
        tile_dim=t, n_rows=n_rows, n_cols=n_cols,
        n_tile_rows=-(-n_rows // t))


def _b2sr(arrays: Arrays, p: str, meta: Mapping, n_rows: int, n_cols: int,
          ell: Optional[B2SREll], dev: torch.device) -> B2SR:
    t = int(meta["tile_dim"])
    if p + "tile_row_ptr" in arrays:
        ptr = _idx(arrays[p + "tile_row_ptr"], dev)
        col = _idx(arrays[p + "tile_col_idx"], dev)
        tiles = from_numpy_u32(arrays[p + "bit_tiles"], dev).view(-1, t)
    elif ell is not None:
        n_tr = -(-n_rows // t)
        valid = ell.tile_col_idx[:n_tr] >= 0
        ptr = torch.zeros(n_tr + 1, dtype=torch.int32, device=dev)
        ptr[1:] = torch.cumsum(ell.row_n_tiles[:n_tr], 0)
        col = ell.tile_col_idx[:n_tr][valid]
        tiles = ell.bit_tiles[:n_tr][valid]
    else:
        raise KeyError(f"no B2SR or ELL arrays under prefix {p!r}")
    return B2SR(tile_row_ptr=ptr, tile_col_idx=col, bit_tiles=tiles,
                tile_dim=t, n_rows=n_rows, n_cols=n_cols,
                nnz=int(meta["nnz"]))


def from_reference(arrays: Arrays, meta: Mapping, device: DeviceLike = None,
                   backend: str = "b2sr") -> Union[B2SR, GraphMatrix]:
    """The reference's arrays as port objects on ``device`` (None = CUDA).

    Returns a :class:`GraphMatrix` (CSR twins derived from the tiles, the
    given ELL/bucketed views installed as its cached views) when the
    transpose's arrays are present, else the forward :class:`B2SR`.
    """
    dev = resolve_device(device)
    t, n_rows, n_cols = (int(meta[k]) for k in ("tile_dim", "n_rows",
                                                "n_cols"))
    orient: Dict[str, Orientation] = {}
    for p, (nr, nc) in (("", (n_rows, n_cols)), ("t.", (n_cols, n_rows))):
        if not any(k.startswith("t.") == (p == "t.") for k in arrays):
            continue
        ell = _ell(arrays, p, t, nr, nc, dev)
        mat = _b2sr(arrays, p, meta, nr, nc, ell, dev)
        rows, cols = b2sr_to_coo(mat)
        o = Orientation(mat, csr_mod.from_coo(rows, cols, nr, nc, device=dev))
        o.ell = ell
        o.buckets = _buckets(arrays, p, t, nr, nc, dev)
        orient[p] = o
    if "" not in orient:
        raise KeyError("no forward-orientation arrays given")
    if "t." not in orient:
        return orient[""].b2sr
    return GraphMatrix(n_rows=n_rows, n_cols=n_cols, nnz=int(meta["nnz"]),
                       tile_dim=t, fwd=orient[""], bwd=orient["t."],
                       backend=backend)


def frontier_from_reference(words: np.ndarray, n: int, n_sources: int,
                            tile_dim: int,
                            device: DeviceLike = None) -> FrontierBatch:
    """The reference's frontier words (``np.uint32[ceil(n/t), t, W]``,
    ``pack_frontier_matrix``) as a port :class:`FrontierBatch` of the same
    bits on ``device`` (None = CUDA)."""
    arr = np.asarray(words, dtype=np.uint32)
    if arr.ndim != 3 or arr.shape[1] != tile_dim:
        raise ValueError(f"frontier words of shape {arr.shape} are not "
                         f"[tiles, {tile_dim}, W]")
    return FrontierBatch.from_words(from_numpy_u32(arr,
                                                   resolve_device(device)),
                                    n, n_sources, tile_dim)


def bitmatrix_from_reference(words: np.ndarray, n: int, tile_dim: int,
                             device: DeviceLike = None) -> BitMatrix:
    """The reference's ``BitMatrix`` words (``np.uint32[ceil(n/t), d]``)
    as a port :class:`BitMatrix` of the same bits on ``device``."""
    arr = np.asarray(words, dtype=np.uint32)
    if arr.ndim != 2 or arr.shape[0] != -(-n // tile_dim):
        raise ValueError(f"activation words of shape {arr.shape} are not "
                         f"[{-(-n // tile_dim)}, d]")
    return BitMatrix.from_words(from_numpy_u32(arr, resolve_device(device)),
                                n, tile_dim)


def _f32(a, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=dev)


def gcn_state_from_reference(params: Mapping[str, Mapping[str, np.ndarray]],
                             device: DeviceLike = None
                             ) -> Dict[str, torch.Tensor]:
    """The reference GCN's ``{"layer_i": {"w": [d_in, d_out], "b":
    [d_out]}}`` (numpy) as the ``state_dict`` of ``GCN``:
    ``layers.i.weight`` is ``w`` transposed (``nn.Linear`` keeps
    ``[d_out, d_in]``), ``layers.i.bias`` is ``b``."""
    return _gcn_layers(params, resolve_device(device), _f32)


def _gcn_layers(tree: Mapping[str, Mapping[str, np.ndarray]], dev,
                convert) -> Dict[str, torch.Tensor]:
    """``{"layer_i": {"w", "b"}}`` as ``layers.i.weight`` (``w``
    transposed) and ``layers.i.bias``, each through ``convert``."""
    out = {}
    for i in range(len(tree)):
        layer = tree[f"layer_{i}"]
        out[f"layers.{i}.weight"] = convert(layer["w"], dev).T.contiguous()
        out[f"layers.{i}.bias"] = convert(layer["b"], dev)
    return out


def _tree_state(tree, prefix: str, dev, convert) -> Dict[str, torch.Tensor]:
    """A reference parameter tree of the gatedgcn, egnn and graphcast
    families as ``state_dict`` entries, keyed by the tree's own path
    (the port's modules carry the reference's names: ``embed_h``,
    ``layers.{i}``, ``U``/``V``/``A``/``B``/``C``, ``norm_h``/``norm_e``,
    ``phi_e``/``phi_x``/``phi_h``, ``layer_{i}`` of an MLP, ``head``,
    ``grid_encoder`` … ``grid_decoder``): a dense layer ``{"w", "b"}``
    gives ``.weight`` (``w`` transposed) and ``.bias``; a layer norm's
    ``scale`` and ``bias`` keep their names."""
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, sub in enumerate(tree):
            out.update(_tree_state(sub, f"{prefix}{i}.", dev, convert))
        return out
    if "w" in tree:
        out = {prefix + "weight": convert(tree["w"], dev).T.contiguous()}
        if "b" in tree:
            out[prefix + "bias"] = convert(tree["b"], dev)
        return out
    out = {}
    for k, sub in tree.items():
        if isinstance(sub, (Mapping, list, tuple)):
            out.update(_tree_state(sub, f"{prefix}{k}.", dev, convert))
        else:
            out[prefix + k] = convert(sub, dev)
    return out


def _family_state(family: str, tree, dev, convert) -> Dict[str, torch.Tensor]:
    if family == "gcn":
        return _gcn_layers(tree, dev, convert)
    if family in ("gatedgcn", "egnn", "graphcast", "din"):
        return _tree_state(tree, "", dev, convert)
    raise NotImplementedError(f"no weight carry-over for family {family!r}")


def gnn_state_from_reference(cfg, params, device: DeviceLike = None
                             ) -> Dict[str, torch.Tensor]:
    """The reference's ``init_params(cfg, key)`` tree (numpy) of
    ``cfg.family`` as the ``state_dict`` of the port's module (``GCN``,
    ``GatedGCN``, ``EGNN`` or ``GraphCast``) on ``device``, float32."""
    return _family_state(cfg.family, params, resolve_device(device), _f32)


def din_state_from_reference(cfg, params, device: DeviceLike = None
                             ) -> Dict[str, torch.Tensor]:
    """The reference DIN's ``init_params(cfg, key)`` tree (numpy) as the
    ``state_dict`` of ``models.recsys.din.DIN`` on ``device``, float32:
    ``item_table``, ``cate_table`` and ``user_table`` as they are, each
    ``attn_mlp``/``mlp`` layer's ``w`` transposed into ``.weight`` and
    ``b`` as ``.bias``. ``opt_state_from_reference(..., family="din")``
    lays out AdamW's moments the same way."""
    return _family_state("din", params, resolve_device(device), _f32)


def _moment(a, dev: torch.device) -> torch.Tensor:
    """A float32 or bfloat16 numpy array (``ml_dtypes``' bfloat16, as JAX
    gives it) as a tensor of the same dtype: bfloat16 goes through
    float32, which holds it exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=dev).to(
            torch.bfloat16)
    return torch.tensor(a, device=dev)


def opt_state_from_reference(opt_state, device: DeviceLike = None,
                             family: str = "gcn"):
    """The reference optimizer's ``OptState`` (``step``, ``m``, ``v`` as
    numpy, the moments in ``family``'s parameter tree; ``v`` None for
    sgd) as the port's ``OptState`` on ``device``: the moments keyed and
    laid out as :func:`gnn_state_from_reference` lays out the weights,
    in their own dtype; ``step`` an int32 scalar."""
    from repro_torch.training.optimizer import OptState
    dev = resolve_device(device)
    step, m, v = opt_state
    return OptState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev),
        m=_family_state(family, m, dev, _moment),
        v=None if v is None else _family_state(family, v, dev, _moment))


def gnn_model_from_reference(params, features,
                             device: DeviceLike = None) -> Dict[str, object]:
    """A served model's ``((w, b), ...)`` and node features (numpy, the
    reference's ``GNNModel`` fields) as keyword arguments of the port's
    ``register_gnn_model`` (float32 tensors on ``device``; ``w`` keeps
    the ``[d_in, d_out]`` layout both packages serve with)."""
    dev = resolve_device(device)
    return {"params": tuple((_f32(w, dev), _f32(b, dev)) for w, b in params),
            "features": _f32(features, dev), "device": dev}


#: the LM tree's matrices kept as ``nn.Linear``'s ``[out, in]`` (the MoE
#: experts' ``[E, …]`` stacks keep the reference's layout)
_LM_LINEAR = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "router",
              "dense_gate", "dense_up", "dense_down", "lm_head")


def _lm_entries(tree, prefix: str, dev, in_moe: bool = False):
    out = {}
    for k, a in tree.items():
        if isinstance(a, Mapping):
            out.update(_lm_entries(a, f"{prefix}{k}.", dev, k == "moe"))
        elif k in _LM_LINEAR and not (in_moe and k in ("w_gate", "w_up",
                                                       "w_down")):
            out[f"{prefix}{k}.weight"] = _f32(a, dev).T.contiguous()
        else:
            out[prefix + k] = _f32(a, dev)
    return out


def lm_state_from_reference(cfg, params, device: DeviceLike = None
                            ) -> Dict[str, torch.Tensor]:
    """The reference transformer's ``init_params(cfg, key)`` tree (numpy)
    as the ``state_dict`` of ``models.transformer.Transformer`` on
    ``device``, float32: ``params["layers"]`` (stacked on a leading
    ``L`` axis, or a list of per-layer trees) unstacked into
    ``layers.{i}.…``; every projection transposed into ``.weight``; the
    norms' ``.scale`` and the experts' ``w_gate``/``w_up``/``w_down`` as
    they are. A tied model has no ``lm_head``: its head is ``embed``."""
    dev = resolve_device(device)
    layers = params["layers"]
    if isinstance(layers, Mapping):
        layers = [_index_tree(layers, i) for i in range(cfg.n_layers)]
    out = {"embed": _f32(params["embed"], dev)}
    for i, lp in enumerate(layers):
        out.update(_lm_entries(lp, f"layers.{i}.", dev))
    rest = {k: v for k, v in params.items()
            if k in ("final_norm", "lm_head")}
    out.update(_lm_entries(rest, "", dev))
    return out


def _index_tree(tree, i: int):
    return {k: _index_tree(v, i) if isinstance(v, Mapping)
            else np.asarray(v)[i] for k, v in tree.items()}
