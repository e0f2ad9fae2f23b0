"""Booster: the trained GBDT model container.

The port's counterpart of ``mmlspark_tpu/gbdt/booster.py``.  Models round
trip as LightGBM v3 *text* (``save_native_model_string`` /
``load_native_model_string``, byte-identical to the reference's, with the
same content-digest header on files), so a model saved by either package
loads in the other and in stock LightGBM.

On a CUDA device prediction walks every tree at once: a ``(T, n)`` node
frontier advances one level per step for ``depth`` steps, with the
reference's float32 compares (thresholds rounded up to float32, NaN goes
right on numeric nodes) and its categorical bitset rule.  On the CPU the
reference's native scorer (``native/fastforest.cc``,
:func:`..native.predict_forest`) walks each row down each tree to its
leaf with the same compares, over host arrays stacked once per booster
(:meth:`Booster._host_stack`).  Both add the tree outputs in tree order in
float32, then the init score, as the reference's walkers add them, so
margins agree bit for bit.  The device walk gives the leaf indices
(:meth:`Booster.predict_leaf_index`), and :class:`CompiledPredictor`
(:meth:`Booster.predictor`) resolves the scorer once for a serving loop:
the forest sliced to an iteration count or a tree range, the native
scorer for a CPU booster and the device walk for a CUDA one.  TreeSHAP
contributions (:meth:`Booster.predict_contrib`, :mod:`.shap`) run on the
host, as in the reference.
"""

from __future__ import annotations

import hashlib
import io
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..device import DeviceLike, resolve_device
from .binning import BinMapper
from .objectives import exp32, sigmoid, softmax, sum_last

#: content-digest header: ``save_native_model`` prepends ONE comment line
#: hashing everything after it, so a torn or bit-flipped model file is
#: refused at load.  The same header as the reference's, so files stay
#: interchangeable between the packages.
DIGEST_HEADER = "# mmlspark_tpu.digest.sha256="


class ModelDigestError(ValueError):
    """A native-model file's content no longer hashes to its embedded
    digest header."""


def with_digest_header(text: str) -> str:
    """Prepend the digest header line (an already-stamped text is
    re-verified and returned unchanged)."""
    if text.startswith(DIGEST_HEADER):
        split_native_digest(text)
        return text
    h = hashlib.sha256(text.encode("utf-8")).hexdigest()
    return f"{DIGEST_HEADER}{h}\n{text}"


def split_native_digest(text: str) -> str:
    """Strip and verify the digest header when present; return the bare
    model text.  Digest-less input (stock LightGBM files) passes."""
    if not text.startswith(DIGEST_HEADER):
        if ".digest.sha256=" in text[:len(DIGEST_HEADER) + 16]:
            raise ModelDigestError(
                "native model digest header is mangled; refusing to load")
        return text
    line, _, body = text.partition("\n")
    want = line[len(DIGEST_HEADER):].strip()
    got = hashlib.sha256(body.encode("utf-8")).hexdigest()
    if got != want:
        raise ModelDigestError(
            f"native model content fails its embedded digest (want "
            f"sha256:{want[:12]}…, got sha256:{got[:12]}…): the file is "
            "torn or bit-flipped; refusing to load")
    return body


@dataclass
class HostTree:
    """One tree with real-valued thresholds, trimmed to its actual size."""
    split_feature: np.ndarray   # (m,) i32
    threshold: np.ndarray       # (m,) f64  (x <= threshold -> left)
    split_gain: np.ndarray      # (m,) f64
    left_child: np.ndarray      # (m,) i32  (>=0 node, <0 leaf ~idx)
    right_child: np.ndarray     # (m,) i32
    decision_type: np.ndarray   # (m,) i32
    leaf_value: np.ndarray      # (L,) f64
    leaf_weight: np.ndarray     # (L,) f64
    leaf_count: np.ndarray      # (L,) i64
    internal_value: np.ndarray  # (m,) f64
    internal_weight: np.ndarray  # (m,) f64
    internal_count: np.ndarray  # (m,) i64
    shrinkage: float = 1.0
    #: categorical splits (LightGBM layout): for a node with decision_type
    #: bit0 set, ``threshold`` indexes ``cat_boundaries``; the words
    #: ``cat_threshold[cat_boundaries[j]:cat_boundaries[j+1]]`` are a
    #: bitset over raw category values — bit set → the value goes left
    num_cat: int = 0
    cat_boundaries: np.ndarray = field(
        default_factory=lambda: np.zeros(1, np.int32))
    cat_threshold: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.uint32))

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_value)

    def max_depth(self) -> int:
        if self.num_leaves <= 1:
            return 0
        m = len(self.split_feature)
        depth = np.zeros(m, dtype=np.int64)
        out = 1
        for i in range(m):  # children always have larger node ids
            for c in (self.left_child[i], self.right_child[i]):
                if c >= 0:
                    depth[c] = depth[i] + 1
                    out = max(out, int(depth[c]) + 1)
        return out


def host_tree_from_arrays(tree, mapper: BinMapper) -> HostTree:
    """Trim a grower ``TreeArrays`` to its actual size with real
    thresholds.  A categorical node's bin bitset becomes LightGBM's
    bitset over raw category values (``cat_boundaries`` /
    ``cat_threshold``, ``threshold`` its index), with decision_type bit 1
    set when the missing bin goes left."""
    num_leaves = int(tree.num_leaves)
    m = max(num_leaves - 1, 0)
    feat = np.asarray(tree.node_feat)[:m]
    bins = np.asarray(tree.node_bin)[:m]
    is_cat = np.asarray(tree.node_is_cat)[:m] > 0
    cat_bits = np.asarray(tree.node_cat_bits)[:m]
    thr = np.array([mapper.bin_threshold_value(int(f), int(b))
                    for f, b in zip(feat, bins)], dtype=np.float64)
    # missing (NaN) routes right in training (the missing bin is the
    # trailing bin): 8 = missing:NaN, 2 = default-left (numerical)
    dt = np.where(mapper.has_missing[feat] if m else np.zeros(0, bool),
                  8, 2).astype(np.int32)
    miss = mapper.missing_bin
    cat_boundaries = [0]
    cat_words: List[np.ndarray] = []
    for i in np.flatnonzero(is_cat):
        cats = mapper.cat_values[int(feat[i])]
        bits = cat_bits[i]
        left_cats = sorted(int(cats[b]) for b in range(len(cats))
                           if (bits[b >> 5] >> (b & 31)) & 1)
        missing_left = bool((bits[miss >> 5] >> (miss & 31)) & 1)
        words = np.zeros(max(left_cats, default=0) // 32 + 1, np.uint32)
        for c in left_cats:
            words[c >> 5] |= np.uint32(1) << np.uint32(c & 31)
        dt[i] = 1 | (2 if missing_left else 0)
        thr[i] = float(len(cat_words))      # index into cat_boundaries
        cat_words.append(words)
        cat_boundaries.append(cat_boundaries[-1] + len(words))
    return HostTree(
        split_feature=feat.astype(np.int32),
        threshold=thr,
        split_gain=np.asarray(tree.node_gain, np.float64)[:m],
        left_child=np.asarray(tree.node_left, np.int32)[:m],
        right_child=np.asarray(tree.node_right, np.int32)[:m],
        decision_type=dt,
        leaf_value=np.asarray(tree.leaf_value, np.float64)[:num_leaves],
        leaf_weight=np.asarray(tree.leaf_weight, np.float64)[:num_leaves],
        leaf_count=np.asarray(tree.leaf_count, np.float64)[:num_leaves]
            .astype(np.int64),
        internal_value=np.asarray(tree.node_value, np.float64)[:m],
        internal_weight=np.asarray(tree.node_weight, np.float64)[:m],
        internal_count=np.asarray(tree.node_count, np.float64)[:m]
            .astype(np.int64),
        num_cat=len(cat_words),
        cat_boundaries=np.asarray(cat_boundaries, np.int32),
        cat_threshold=(np.concatenate(cat_words) if cat_words
                       else np.zeros(0, np.uint32)),
    )


def _thr32(t: HostTree) -> np.ndarray:
    """Thresholds rounded UP to float32, so the f32 decision ``x <= thr``
    agrees with the exact f64 threshold for every f32 ``x``."""
    v = t.threshold.astype(np.float32)
    low = v.astype(np.float64) < t.threshold
    v[low] = np.nextafter(v[low], np.float32(np.inf))
    return v


class Booster:
    """A trained forest + objective metadata; predicts on ``device``."""

    def __init__(self, trees: List[HostTree], num_class: int = 1,
                 objective_str: str = "regression",
                 init_score: float = 0.0,
                 feature_names: Optional[List[str]] = None,
                 feature_infos: Optional[List[str]] = None,
                 max_feature_idx: Optional[int] = None,
                 params: Optional[Dict[str, str]] = None,
                 device: DeviceLike = "cuda"):
        self.trees = trees
        self.num_class = num_class
        self.objective_str = objective_str
        self.init_score = init_score
        self.max_feature_idx = max_feature_idx if max_feature_idx is not None \
            else (max((int(t.split_feature.max()) for t in trees
                       if len(t.split_feature)), default=0))
        nf = self.max_feature_idx + 1
        self.feature_names = feature_names or [
            f"Column_{i}" for i in range(nf)]
        self.feature_infos = feature_infos or ["none"] * nf
        self.params = params or {}
        self.device = device
        self._stacked: Dict[torch.device, dict] = {}
        self._stacked_host: Optional[dict] = None
        # bumped whenever the stacked forests are dropped: a
        # CompiledPredictor keeps the token it was built with and refuses
        # to score a forest that changed under it
        self._cache_token = 0
        #: the fit-time data-quality baseline
        #: (:class:`..core.sketch.ReferenceProfile`) the engine attaches
        #: after training; None for a loaded or extended model, as in the
        #: reference (stage persistence does not write it)
        self.reference_profile = None

    def extended(self, continuation: "Booster") -> "Booster":
        """The merged model of continued training (LightGBM's
        ``init_model``): this booster's trees, then the ``continuation``
        forest trained with this booster's margins as init scores, so the
        merged margins are the sum of both.  The merged model records the
        iterations of both and keeps this booster's device."""
        if continuation.num_class != self.num_class:
            raise ValueError(
                f"cannot extend a {self.num_class}-class model with a "
                f"{continuation.num_class}-class continuation")
        if continuation.max_feature_idx != self.max_feature_idx:
            raise ValueError(
                f"feature count mismatch: base model uses "
                f"{self.max_feature_idx + 1} features, continuation "
                f"{continuation.max_feature_idx + 1}")
        params = dict(continuation.params)
        old_it = len(self.trees) // max(self.num_class, 1)
        new_it = len(continuation.trees) // max(self.num_class, 1)
        params["num_iterations"] = str(old_it + new_it)
        return Booster(
            list(self.trees) + list(continuation.trees),
            num_class=self.num_class,
            objective_str=continuation.objective_str,
            init_score=self.init_score,
            feature_names=continuation.feature_names,
            feature_infos=continuation.feature_infos,
            max_feature_idx=self.max_feature_idx,
            params=params, device=self.device)

    # -- prediction ----------------------------------------------------------

    def invalidate_cache(self) -> None:
        """Drop the stacked forests.  Call after changing ``trees`` in
        place: a :class:`CompiledPredictor` built before raises on its
        next call instead of scoring the old forest."""
        self._stacked.clear()
        self._stacked_host = None
        self._cache_token += 1

    def predictor(self, num_iteration: Optional[int] = None,
                  backend: str = "auto",
                  tree_range: Optional[Tuple[int, int]] = None,
                  include_init_score: bool = True
                  ) -> "CompiledPredictor":
        """A margin scorer with the per-call work of
        :meth:`predict_margin` (stacking, slicing, the backend choice)
        done once, on this booster's device.  ``backend``: "auto" (the
        native scorer on a CPU booster, the device walk on a CUDA one),
        "native" (a CPU booster only) or "jit" (the device walk).

        ``tree_range=(lo, hi)`` scores trees ``lo .. hi-1`` only, bounds
        aligned to ``num_class``; with ``include_init_score=False`` the
        partial carries no init score, so the partials of a split forest
        sum to the full margins."""
        return CompiledPredictor(self, num_iteration, backend,
                                 tree_range=tree_range,
                                 include_init_score=include_init_score)

    def _host_stack(self) -> dict:
        """The forest as padded ``(T, ...)`` numpy arrays in the dtypes of
        :data:`..native.FOREST_ARRAYS` (the reference's stacked arrays),
        made once per booster: what the native scorer reads, and what
        :meth:`_stack` moves to a device."""
        if self._stacked_host is not None:
            return self._stacked_host
        T = len(self.trees)
        m = max(max(len(t.split_feature) for t in self.trees), 1)
        L = max(max(t.num_leaves for t in self.trees), 1)

        def pad(arrs, width, dtype):
            out = np.zeros((T, width), dtype=dtype)
            for i, a in enumerate(arrs):
                out[i, :len(a)] = a
            return out

        ncat = max(max(t.num_cat for t in self.trees), 1)
        words = max(max(len(t.cat_threshold) for t in self.trees), 1)
        self._stacked_host = {
            "feat": pad([t.split_feature for t in self.trees], m, np.int32),
            "thr": pad([_thr32(t) for t in self.trees], m, np.float32),
            "left": pad([t.left_child for t in self.trees], m, np.int32),
            "right": pad([t.right_child for t in self.trees], m, np.int32),
            "leaf": pad([t.leaf_value for t in self.trees], L, np.float32),
            "single": np.asarray([t.num_leaves <= 1 for t in self.trees],
                                 np.uint8),
            "is_cat": pad([t.decision_type & 1 for t in self.trees], m,
                          np.int32),
            "dleft": pad([(t.decision_type & 2) >> 1 for t in self.trees],
                         m, np.int32),
            "cat_bnd": pad([t.cat_boundaries for t in self.trees],
                           ncat + 1, np.int32),
            "cat_words": pad([t.cat_threshold for t in self.trees], words,
                             np.uint32),
            "depth": max(max(t.max_depth() for t in self.trees), 1),
            "has_cat": any(t.num_cat > 0 for t in self.trees),
        }
        return self._stacked_host

    def _stack(self, dev: torch.device) -> dict:
        """The forest as padded ``(T, ...)`` tensors on ``dev`` for the
        device walk (:meth:`_host_stack` widened to its index dtypes)."""
        if dev in self._stacked:
            return self._stacked[dev]
        h = self._host_stack()
        dtypes = {"feat": torch.int64, "thr": torch.float32,
                  "left": torch.int64, "right": torch.int64,
                  "leaf": torch.float32, "single": torch.bool,
                  "is_cat": torch.bool, "dleft": torch.bool,
                  "cat_bnd": torch.int64, "cat_words": torch.int64}
        s = {k: torch.as_tensor(h[k].astype(np.int64) if k == "cat_words"
                                else h[k], device=dev).to(dt)
             for k, dt in dtypes.items()}
        s.update(depth=h["depth"], has_cat=h["has_cat"])
        self._stacked[dev] = s
        return s

    def _device_input(self, X, device: Optional[DeviceLike]
                      ) -> torch.Tensor:
        """``X`` as float32 on its own device (a tensor) or on ``device``
        (default the booster's), after the feature-count check."""
        if isinstance(X, torch.Tensor):
            dev = resolve_device(X.device)
        else:
            dev = resolve_device(device or self.device)
            X = np.asarray(X)
        if X.ndim != 2 or X.shape[1] <= self.max_feature_idx:
            raise ValueError(
                f"Model uses feature index {self.max_feature_idx} but input "
                f"has shape {tuple(X.shape)}; expected (n, >= "
                f"{self.max_feature_idx + 1})")
        return torch.as_tensor(X, device=dev).to(torch.float32)

    def predict_margin(self, X, num_iteration: Optional[int] = None,
                       device: Optional[DeviceLike] = None) -> torch.Tensor:
        """Raw margins: ``(n,)`` float32 for single-class, ``(n, K)`` for
        multiclass.  ``X`` is a tensor (its device is used) or an array
        (moved to ``device``, default the booster's).  On the CPU the
        native scorer walks the rows, on a CUDA device the device walk;
        their margins are the same bits."""
        X = self._device_input(X, device)
        K = self.num_class
        if not self.trees:
            return _margins(None, X, K, self.init_score)
        T = len(self.trees)
        sl = slice(0, T if num_iteration is None
                   else min(num_iteration * K, T))
        if X.device.type == "cpu":
            return _native_margins(_slice_host(self._host_stack(), sl), X,
                                   K, self.init_score)
        return _margins(_slice_forest(self._stack(X.device), sl), X, K,
                        self.init_score)

    def predict_leaf_index(self, X, device: Optional[DeviceLike] = None
                           ) -> torch.Tensor:
        """``(n, T)`` int32: the leaf each row reaches in each tree, the
        walk of :meth:`predict_margin` (``X`` as there)."""
        X = self._device_input(X, device)
        if not self.trees:
            return torch.zeros((X.shape[0], 0), dtype=torch.int32,
                               device=X.device)
        forest = _slice_forest(self._stack(X.device),
                               slice(0, len(self.trees)))
        return _leaves(forest, X).T.to(torch.int32)

    def predict_contrib(self, X) -> np.ndarray:
        """Per-row TreeSHAP contributions in LightGBM's ``pred_contrib``
        layout, ``(n, num_class · (num_features + 1))`` with each class's
        expected value in its last slot (:mod:`.shap`, on the host)."""
        from .shap import predict_contrib
        if isinstance(X, torch.Tensor):
            X = X.cpu().numpy()
        return predict_contrib(self, X)

    def predict(self, X, raw_score: bool = False,
                num_iteration: Optional[int] = None,
                device: Optional[DeviceLike] = None) -> torch.Tensor:
        """The objective's output transform of the margins, in the
        reference's float order: the sigmoid (binary, cross_entropy), the
        softmax (multiclass), the sigmoids normalised to sum 1
        (multiclassova), the exp of the log link (poisson, gamma,
        tweedie), else the margins."""
        m = self.predict_margin(X, num_iteration, device)
        if raw_score:
            return m
        obj = self.objective_str.split(" ")[0]
        if obj == "binary":
            sig = _param_from_str(self.objective_str, "sigmoid", 1.0)
            return sigmoid(sig * m)
        if obj in ("multiclass", "softmax"):
            return softmax(m)
        if obj in ("poisson", "gamma", "tweedie"):
            return exp32(m)
        if obj in ("cross_entropy", "xentropy"):
            return sigmoid(m)
        if obj == "multiclassova":
            sig = _param_from_str(self.objective_str, "sigmoid", 1.0)
            p = sigmoid(sig * m)
            return p / torch.clamp(sum_last(p), min=1e-12)
        return m

    # -- feature importance --------------------------------------------------

    def feature_importances(self, importance_type: str = "split"):
        nf = self.max_feature_idx + 1
        out = np.zeros(nf)
        for t in self.trees:
            if importance_type == "gain":
                np.add.at(out, t.split_feature, t.split_gain)
            else:
                np.add.at(out, t.split_feature, 1.0)
        return out

    # -- LightGBM text-format interop ----------------------------------------

    def save_native_model_string(self) -> str:
        buf = io.StringIO()
        nf = self.max_feature_idx + 1
        buf.write("tree\n")
        buf.write("version=v3\n")
        buf.write(f"num_class={self.num_class}\n")
        buf.write(f"num_tree_per_iteration={self.num_class}\n")
        buf.write("label_index=0\n")
        buf.write(f"max_feature_idx={self.max_feature_idx}\n")
        buf.write(f"objective={self.objective_str}\n")
        buf.write("feature_names=" + " ".join(self.feature_names[:nf]) + "\n")
        buf.write("feature_infos=" + " ".join(self.feature_infos[:nf]) + "\n")

        tree_bufs = []
        for i, t in enumerate(self.trees):
            tb = io.StringIO()
            tb.write(f"Tree={i}\n")
            tb.write(f"num_leaves={t.num_leaves}\n")
            tb.write(f"num_cat={t.num_cat}\n")
            if t.num_leaves > 1:
                tb.write(_arr_line("split_feature", t.split_feature))
                tb.write(_arr_line("split_gain", t.split_gain))
                tb.write(_arr_line("threshold", t.threshold))
                tb.write(_arr_line("decision_type", t.decision_type))
                tb.write(_arr_line("left_child", t.left_child))
                tb.write(_arr_line("right_child", t.right_child))
                tb.write(_arr_line("leaf_value", t.leaf_value))
                tb.write(_arr_line("leaf_weight", t.leaf_weight))
                tb.write(_arr_line("leaf_count", t.leaf_count))
                tb.write(_arr_line("internal_value", t.internal_value))
                tb.write(_arr_line("internal_weight", t.internal_weight))
                tb.write(_arr_line("internal_count", t.internal_count))
                if t.num_cat > 0:
                    tb.write(_arr_line("cat_boundaries", t.cat_boundaries))
                    tb.write(_arr_line("cat_threshold", t.cat_threshold))
            else:
                tb.write(_arr_line("leaf_value", t.leaf_value))
            tb.write("is_linear=0\n")
            tb.write(f"shrinkage={t.shrinkage:g}\n")
            tb.write("\n\n")
            tree_bufs.append(tb.getvalue())

        buf.write("tree_sizes=" + " ".join(
            str(len(tb.encode("utf-8"))) for tb in tree_bufs) + "\n\n")
        for tb in tree_bufs:
            buf.write(tb)
        buf.write("end of trees\n\n")
        buf.write("feature_importances:\n")
        imp = self.feature_importances("gain")
        for j in np.argsort(-imp):
            if imp[j] > 0:
                buf.write(f"{self.feature_names[j]}={imp[j]:g}\n")
        buf.write("\nparameters:\n")
        for k, v in self.params.items():
            buf.write(f"[{k}: {v}]\n")
        buf.write("end of parameters\n")
        return buf.getvalue()

    def save_native_model(self, path: str) -> None:
        """Write the native-model text with the digest header prepended."""
        with open(path, "w") as f:
            f.write(with_digest_header(self.save_native_model_string()))

    @classmethod
    def load_native_model_string(cls, text: str,
                                 device: DeviceLike = "cuda") -> "Booster":
        text = split_native_digest(text)
        header, _, rest = text.partition("Tree=")
        head = _parse_kv(header)
        trees: List[HostTree] = []
        body = rest.split("end of trees")[0]
        for block in re.split(r"Tree=\d+\n", "Tree=" + body):
            block = block.strip()
            if not block or block == "Tree=":
                continue
            kv = _parse_kv(block)
            if "num_leaves" not in kv:
                continue
            trees.append(_tree_from_kv(kv))
        return cls(trees, num_class=int(head.get("num_class", 1)),
                   objective_str=head.get("objective", "regression"),
                   init_score=0.0,
                   feature_names=head.get("feature_names", "").split()
                   or None,
                   feature_infos=head.get("feature_infos", "").split()
                   or None,
                   max_feature_idx=int(head.get("max_feature_idx", 0)),
                   device=device)

    @classmethod
    def load_native_model(cls, path: str,
                          device: DeviceLike = "cuda") -> "Booster":
        with open(path, "rb") as f:
            raw = f.read()
        try:
            text = raw.decode("utf-8")
        except UnicodeDecodeError as e:
            if b".digest.sha256=" not in raw[:len(DIGEST_HEADER) + 16]:
                raise ModelDigestError(
                    f"native model file {path!r} is not valid UTF-8 and "
                    "carries no digest header; refusing to load") from e
            # the digest check rejects the replacement characters
            text = raw.decode("utf-8", errors="replace")
        return cls.load_native_model_string(text, device=device)


class CompiledPredictor:
    """Margin scorer with the prediction path resolved once.

    :meth:`Booster.predict_margin` stacks (once per device), slices and
    checks on every call; this does it at construction: the backend (the
    native scorer on a CPU booster, the device walk on a CUDA one), the
    forest sliced to ``num_iteration`` or ``tree_range``, the class count
    and the init score.  Its margins are those of ``predict_margin`` bit
    for bit (the same walks and the same adds).

    A predictor is bound to the forest it was built from:
    :meth:`Booster.invalidate_cache` (needed after changing ``trees`` in
    place) bumps a token, and a stale predictor raises ``RuntimeError`` on
    its next call.  :meth:`Booster.extended` and model loads return new
    boosters, so a base model's predictors stay valid.
    """

    def __init__(self, booster: Booster,
                 num_iteration: Optional[int] = None,
                 backend: str = "auto",
                 tree_range: Optional[Tuple[int, int]] = None,
                 include_init_score: bool = True):
        if backend not in ("auto", "native", "jit"):
            raise ValueError(f"backend must be auto|native|jit, "
                             f"got {backend!r}")
        self._booster = booster
        self._token = booster._cache_token
        self._num_trees = len(booster.trees)
        self._K = booster.num_class
        self._init_score = booster.init_score if include_init_score \
            else 0.0
        self._device = resolve_device(booster.device)
        self.num_features = booster.max_feature_idx + 1
        self.num_iteration = num_iteration
        self.tree_range = tree_range
        self._forest = None
        self._mode = "empty"
        T = len(booster.trees)
        if tree_range is not None:
            # both walkers assign class = tree index % K, so bounds off a
            # num_class boundary would rotate the classes
            if num_iteration is not None:
                raise ValueError(
                    "pass num_iteration OR tree_range, not both")
            lo, hi = int(tree_range[0]), int(tree_range[1])
            if not 0 <= lo <= hi <= T:
                raise ValueError(
                    f"tree_range {tree_range} outside [0, {T}]")
            if lo % self._K or (hi % self._K and hi != T):
                raise ValueError(
                    f"tree_range {tree_range} must align to "
                    f"num_class={self._K} boundaries")
            sl = slice(lo, hi)
        else:
            use_t = T if num_iteration is None \
                else min(num_iteration * self._K, T)
            sl = slice(0, use_t)
        on_cpu = self._device.type == "cpu"
        if backend == "native" and not on_cpu:
            raise RuntimeError(
                "backend='native' requested but the native forest scorer "
                f"runs on the CPU and this booster is on {self._device}; "
                "use backend='auto' or 'jit', the device walk")
        if sl.stop > sl.start:
            if on_cpu and backend != "jit":
                self._forest = _slice_host(booster._host_stack(), sl)
                self._mode = "native"
            else:
                self._forest = _slice_forest(booster._stack(self._device),
                                             sl)
                self._mode = "jit"

    @property
    def mode(self) -> str:
        """The resolved backend: 'native' (the host scorer), 'jit' (the
        device walk) or 'empty'."""
        return self._mode

    def _check_fresh(self) -> None:
        b = self._booster
        if b._cache_token != self._token \
                or len(b.trees) != self._num_trees:
            raise RuntimeError(
                "stale CompiledPredictor: the bound Booster's forest "
                "changed after this predictor was built (invalidate_"
                "cache() was called or trees were added); rebuild with "
                "booster.predictor()")

    def __call__(self, X) -> torch.Tensor:
        """Raw margins on the booster's device, those of
        ``predict_margin`` bit for bit: ``(n,)`` float32 for
        single-class, ``(n, K)`` for multiclass."""
        self._check_fresh()
        shape = tuple(X.shape) if hasattr(X, "shape") else np.shape(X)
        if len(shape) != 2 or shape[1] < self.num_features:
            raise ValueError(
                f"Model uses feature index {self.num_features - 1} but "
                f"input has shape {shape}; expected (n, >= "
                f"{self.num_features})")
        if isinstance(X, np.ndarray) and not X.flags.writeable:
            X = X.copy()    # a wire block's view: torch shares only
            # writable arrays
        X = torch.as_tensor(X, device=self._device).to(torch.float32)
        if self._mode == "native":
            return _native_margins(self._forest, X, self._K,
                                   self._init_score)
        return _margins(self._forest, X, self._K, self._init_score)


def _slice_forest(s: dict, sl: slice) -> dict:
    """Trees ``sl`` of a stacked forest (:meth:`Booster._stack`)."""
    out = {k: v[sl] for k, v in s.items() if isinstance(v, torch.Tensor)}
    out.update(depth=s["depth"], has_cat=s["has_cat"])
    return out


def _slice_host(h: dict, sl: slice) -> dict:
    """Trees ``sl`` of the host stack (:meth:`Booster._host_stack`)."""
    out = {k: h[k][sl] for k, _ in native.FOREST_ARRAYS}
    out["has_cat"] = h["has_cat"]
    return out


def _native_margins(h: dict, X: torch.Tensor, K: int,
                    init_score: float) -> torch.Tensor:
    """Margins of the sliced host forest ``h`` over the CPU rows ``X``
    through the native scorer: tree outputs added in tree order into
    their class in float32, then the init score, as :func:`_margins`
    adds them."""
    Xh = np.ascontiguousarray(X.numpy(), np.float32)
    out = np.zeros((Xh.shape[0], K), np.float32)
    native.predict_forest(Xh, h, K, h["has_cat"], out)
    out += np.float32(init_score)
    t = torch.from_numpy(out)
    return t[:, 0] if K == 1 else t


def _leaves(s: dict, X: torch.Tensor) -> torch.Tensor:
    """``(T, n)`` leaf index of every row in every tree of the sliced
    forest ``s``: every tree's frontier advances one level per step."""
    n = X.shape[0]
    T = s["feat"].shape[0]
    Xt = X.T.contiguous()
    feat, thr, left, right = s["feat"], s["thr"], s["left"], s["right"]
    node = torch.where(s["single"][:, None],
                       torch.full((T, n), -1, device=X.device),
                       torch.zeros((T, n), dtype=torch.int64,
                                   device=X.device))
    for _ in range(s["depth"]):
        safe = node.clamp(min=0)
        x = Xt.gather(0, feat.gather(1, safe))
        t = thr.gather(1, safe)
        go_left = x <= t
        if s["has_cat"]:
            go_left = torch.where(
                s["is_cat"].gather(1, safe),
                _cat_go_left(x, t.to(torch.int32).to(torch.int64),
                             s["dleft"].gather(1, safe), s["cat_bnd"],
                             s["cat_words"]),
                go_left)
        nxt = torch.where(go_left, left.gather(1, safe),
                          right.gather(1, safe))
        node = torch.where(node < 0, node, nxt)
    return ~node


def _margins(s: Optional[dict], X: torch.Tensor, K: int,
             init_score: float) -> torch.Tensor:
    """Margins of the sliced forest ``s`` (None: no trees): each tree's
    leaf values added in tree order into its class (tree index % K) in
    float32, then the init score; ``(n,)`` when K is 1."""
    out = torch.zeros(X.shape[0], K, dtype=torch.float32, device=X.device)
    if s is not None:
        vals = s["leaf"].gather(1, _leaves(s, X))
        for t in range(vals.shape[0]):
            out[:, t % K] += vals[t]
    out += np.float32(init_score).item()
    return out[:, 0] if K == 1 else out


def _cat_go_left(x, j, dleft, cat_bnd, cat_words):
    """Raw-value categorical decision, the reference's rule: the value is
    truncated to int32 first; NaN routes by the node's default-left bit;
    a negative or out-of-range category routes right."""
    j = j.clamp(0, cat_bnd.shape[1] - 2)
    b0 = cat_bnd.gather(1, j)
    b1 = cat_bnd.gather(1, j + 1)
    xnan = torch.isnan(x)
    c = torch.where(xnan, -1.0, x).to(torch.int32).to(torch.int64)
    widx = b0 + (c >> 5)
    ok = (c >= 0) & (widx < b1)
    word = cat_words.gather(1, widx.clamp(0, cat_words.shape[1] - 1))
    bit = ((word >> (c & 31)) & 1).to(torch.bool)
    return torch.where(xnan, dleft, ok & bit)


def _tree_from_kv(kv: Dict[str, str]) -> HostTree:
    L = int(kv["num_leaves"])
    if L <= 1:
        return HostTree(
            split_feature=np.zeros(0, np.int32),
            threshold=np.zeros(0, np.float64),
            split_gain=np.zeros(0, np.float64),
            left_child=np.zeros(0, np.int32),
            right_child=np.zeros(0, np.int32),
            decision_type=np.zeros(0, np.int32),
            leaf_value=_parse_arr(kv["leaf_value"], np.float64),
            leaf_weight=np.zeros(1, np.float64),
            leaf_count=np.zeros(1, np.int64),
            internal_value=np.zeros(0, np.float64),
            internal_weight=np.zeros(0, np.float64),
            internal_count=np.zeros(0, np.int64),
            shrinkage=float(kv.get("shrinkage", 1.0)))
    num_cat = int(kv.get("num_cat", 0))
    return HostTree(
        split_feature=_parse_arr(kv["split_feature"], np.int32),
        threshold=_parse_arr(kv["threshold"], np.float64),
        split_gain=_parse_arr(kv.get("split_gain", "0"), np.float64),
        left_child=_parse_arr(kv["left_child"], np.int32),
        right_child=_parse_arr(kv["right_child"], np.int32),
        decision_type=_parse_arr(kv["decision_type"], np.int32),
        leaf_value=_parse_arr(kv["leaf_value"], np.float64),
        leaf_weight=_parse_arr(kv.get("leaf_weight", "0"), np.float64),
        leaf_count=_parse_arr(kv.get("leaf_count", "0"), np.int64),
        internal_value=_parse_arr(kv.get("internal_value", "0"), np.float64),
        internal_weight=_parse_arr(kv.get("internal_weight", "0"),
                                   np.float64),
        internal_count=_parse_arr(kv.get("internal_count", "0"), np.int64),
        shrinkage=float(kv.get("shrinkage", 1.0)),
        num_cat=num_cat,
        cat_boundaries=(_parse_arr(kv["cat_boundaries"], np.int64)
                        .astype(np.int32) if num_cat > 0
                        else np.zeros(1, np.int32)),
        cat_threshold=(_parse_arr(kv["cat_threshold"], np.int64)
                       .astype(np.uint32) if num_cat > 0
                       else np.zeros(0, np.uint32)))


def _arr_line(name: str, arr: np.ndarray) -> str:
    if arr.dtype.kind == "f":
        vals = " ".join(np.format_float_positional(
            v, precision=17, trim="0") for v in arr)
    else:
        vals = " ".join(str(int(v)) for v in arr)
    return f"{name}={vals}\n"


def _parse_kv(block: str) -> Dict[str, str]:
    out = {}
    for line in block.splitlines():
        if "=" in line:
            k, _, v = line.partition("=")
            out[k.strip()] = v.strip()
    return out


def _parse_arr(s: str, dtype) -> np.ndarray:
    if not s:
        return np.zeros(0, dtype)
    return np.array(s.split(), dtype=np.float64).astype(dtype)


def _param_from_str(s: str, key: str, default: float) -> float:
    m = re.search(rf"{key}:([0-9.eE+-]+)", s)
    return float(m.group(1)) if m else default
