"""Booster: the trained GBDT model container.

The port's counterpart of ``mmlspark_tpu/gbdt/booster.py``.  Models round
trip as LightGBM v3 *text* (``save_native_model_string`` /
``load_native_model_string``, byte-identical to the reference's, with the
same content-digest header on files), so a model saved by either package
loads in the other and in stock LightGBM.

Prediction walks every tree at once on the device: a ``(T, n)`` node
frontier advances one level per step for ``depth`` steps, with the
reference's float32 compares (thresholds rounded up to float32, NaN goes
right on numeric nodes) and its categorical bitset rule.  Tree outputs are
added in tree order in float32, then the init score, as the reference's
walkers add them, so margins agree bit for bit.
"""

from __future__ import annotations

import hashlib
import io
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .binning import BinMapper
from .objectives import sigmoid

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
    """Trim a grower ``TreeArrays`` (numeric splits) to its actual size
    with real thresholds."""
    num_leaves = int(tree.num_leaves)
    m = max(num_leaves - 1, 0)
    feat = np.asarray(tree.node_feat)[:m]
    bins = np.asarray(tree.node_bin)[:m]
    thr = np.array([mapper.bin_threshold_value(int(f), int(b))
                    for f, b in zip(feat, bins)], dtype=np.float64)
    # missing (NaN) routes right in training (the missing bin is the
    # trailing bin): 8 = missing:NaN, 2 = default-left (numerical)
    dt = np.where(mapper.has_missing[feat] if m else np.zeros(0, bool),
                  8, 2).astype(np.int32)
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

    # -- prediction ----------------------------------------------------------

    def _stack(self, dev: torch.device) -> dict:
        """The forest as padded ``(T, ...)`` tensors on ``dev``."""
        if dev in self._stacked:
            return self._stacked[dev]
        T = len(self.trees)
        m = max(max(len(t.split_feature) for t in self.trees), 1)
        L = max(max(t.num_leaves for t in self.trees), 1)

        def pad(arrs, width, dtype):
            out = np.zeros((T, width), dtype=dtype)
            for i, a in enumerate(arrs):
                out[i, :len(a)] = a
            return torch.as_tensor(out, device=dev)

        ncat = max(max(t.num_cat for t in self.trees), 1)
        words = max(max(len(t.cat_threshold) for t in self.trees), 1)
        s = {
            "feat": pad([t.split_feature for t in self.trees], m, np.int64),
            "thr": pad([_thr32(t) for t in self.trees], m, np.float32),
            "left": pad([t.left_child for t in self.trees], m, np.int64),
            "right": pad([t.right_child for t in self.trees], m, np.int64),
            "leaf": pad([t.leaf_value for t in self.trees], L, np.float32),
            "single": torch.as_tensor(
                [t.num_leaves <= 1 for t in self.trees], device=dev),
            "is_cat": pad([t.decision_type & 1 for t in self.trees], m,
                          np.bool_),
            "dleft": pad([(t.decision_type & 2) >> 1 for t in self.trees],
                         m, np.bool_),
            "cat_bnd": pad([t.cat_boundaries for t in self.trees],
                           ncat + 1, np.int64),
            "cat_words": pad([t.cat_threshold for t in self.trees], words,
                             np.int64),
            "depth": max(max(t.max_depth() for t in self.trees), 1),
            "has_cat": any(t.num_cat > 0 for t in self.trees),
        }
        self._stacked[dev] = s
        return s

    def predict_margin(self, X, num_iteration: Optional[int] = None,
                       device: Optional[DeviceLike] = None) -> torch.Tensor:
        """Raw margins on the device: ``(n,)`` float32 for single-class,
        ``(n, K)`` for multiclass.  ``X`` is a tensor (its device is used)
        or an array (moved to ``device``, default the booster's)."""
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
        X = torch.as_tensor(X, device=dev).to(torch.float32)
        n = X.shape[0]
        K = self.num_class
        out = torch.zeros(n, K, dtype=torch.float32, device=dev)
        if self.trees:
            T = len(self.trees)
            use_t = T if num_iteration is None \
                else min(num_iteration * K, T)
            vals = _walk(self._stack(dev), X, use_t)
            for t in range(use_t):
                out[:, t % K] += vals[t]
        out += np.float32(self.init_score).item()
        return out[:, 0] if K == 1 else out

    def predict(self, X, raw_score: bool = False,
                num_iteration: Optional[int] = None,
                device: Optional[DeviceLike] = None) -> torch.Tensor:
        m = self.predict_margin(X, num_iteration, device)
        if raw_score:
            return m
        obj = self.objective_str.split(" ")[0]
        if obj == "binary":
            sig = _param_from_str(self.objective_str, "sigmoid", 1.0)
            return sigmoid(sig * m)
        if obj in ("regression", "regression_l2", "l2"):
            return m
        raise NotImplementedError(
            f"output transform of objective {obj!r} is not ported yet; "
            "predict(raw_score=True) gives the margins")

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


def _walk(s: dict, X: torch.Tensor, use_t: int) -> torch.Tensor:
    """``(use_t, n)`` output of each of the first ``use_t`` trees for the
    rows of ``X``: every tree's frontier advances one level per step."""
    n = X.shape[0]
    Xt = X.T.contiguous()
    feat, thr = s["feat"][:use_t], s["thr"][:use_t]
    left, right = s["left"][:use_t], s["right"][:use_t]
    node = torch.where(s["single"][:use_t, None],
                       torch.full((use_t, n), -1, device=X.device),
                       torch.zeros((use_t, n), dtype=torch.int64,
                                   device=X.device))
    for _ in range(s["depth"]):
        safe = node.clamp(min=0)
        x = Xt.gather(0, feat.gather(1, safe))
        t = thr.gather(1, safe)
        go_left = x <= t
        if s["has_cat"]:
            go_left = torch.where(
                s["is_cat"][:use_t].gather(1, safe),
                _cat_go_left(x, t.to(torch.int32).to(torch.int64),
                             s["dleft"][:use_t].gather(1, safe),
                             s["cat_bnd"][:use_t], s["cat_words"][:use_t]),
                go_left)
        nxt = torch.where(go_left, left.gather(1, safe),
                          right.gather(1, safe))
        node = torch.where(node < 0, node, nxt)
    return s["leaf"][:use_t].gather(1, ~node)


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
