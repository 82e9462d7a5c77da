"""Seeded generators of the benchmark's inputs: tables, queries, request
pools, request sizes and random tree ensembles.

Everything a cell feeds the program is made here from ``--seed`` and the
configuration file, so the same seed gives the same inputs.  The
structure (column value grids, label weights, query sizes, request
sizes) is fixed by the configuration alone; the seed draws the rows and
the order.  Every seed therefore hands the program the same amount of
work, in another arrangement.

A column is a grid of ``levels`` float32 values with a probability for
each level.  Every level is common enough that the program's binning
sample holds it, so binning at ``max_bin`` keeps one bin a level and the
reference can take a row's bin as its level index: it never reads the
program's bin boundaries.  Codes are drawn as 16-bit uniforms through a
lookup table of the column's cumulative probabilities.
"""
from __future__ import annotations

import math
import statistics
from typing import List, NamedTuple, Optional

import numpy as np

LUT_BITS = 16
# the structure of a configuration (grids, label weights, sizes) comes
# from this stream, the rows from --seed
STRUCTURE_SEED = 20240229


class Table(NamedTuple):
    x: np.ndarray                 # [N, F] float32 raw values
    y: np.ndarray                 # [N] float32 labels
    codes: np.ndarray             # [F, N] uint8 level index of every value
    grids: List[np.ndarray]       # per column its sorted float32 levels
    query_boundaries: Optional[np.ndarray]   # [nq + 1] int64, or None


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator of ``seed`` (any whole number, large ones included)
    for one purpose, ``stream``."""
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed) % (1 << 63), int(stream)])))


def _normal_quantiles(levels: int) -> np.ndarray:
    nd = statistics.NormalDist()
    return np.array([nd.inv_cdf((k + 0.5) / levels) for k in range(levels)])


def column_specs(config: dict) -> list:
    """One dict a column, in column order, from the config's groups."""
    F = int(config["features"])
    specs = [None] * F
    for group in config["columns"]:
        for c in group["cols"]:
            if specs[c] is not None:
                raise ValueError("column %d in two groups" % c)
            specs[c] = group
    missing = [c for c in range(F) if specs[c] is None]
    if missing:
        raise ValueError("columns without a group: %s" % missing)
    return specs


def level_probs(group: dict) -> np.ndarray:
    """The probability of each level of a column of ``group``."""
    mass = group.get("mass", "equal")
    L = int(group["levels"])
    if mass == "equal":
        p = np.full(L, 1.0 / L)
    elif mass == "geometric":
        p = group["decay"] ** np.arange(L) + group["floor"]
    else:
        p = np.asarray(mass, np.float64)
        if p.size != L:
            raise ValueError("mass list of %d for %d levels" % (p.size, L))
    return p / p.sum()


def level_values(group: dict) -> np.ndarray:
    """Sorted distinct float32 values of the levels of ``group``."""
    v = group["values"]
    L = int(group["levels"])
    kind = v["kind"]
    if kind == "list":
        vals = np.asarray(v["list"], np.float64)
    elif kind == "normal":
        vals = v.get("loc", 0.0) + v.get("scale", 1.0) * _normal_quantiles(L)
    elif kind == "lognormal":
        vals = v.get("scale", 1.0) * np.exp(v["sigma"] * _normal_quantiles(L))
    elif kind == "uniform":
        lo, hi = v["low"], v["high"]
        vals = lo + (hi - lo) * (np.arange(L) + 0.5) / L
    elif kind == "index":
        vals = v.get("start", 0.0) + v.get("step", 1.0) * np.arange(L)
    else:
        raise ValueError("unknown value kind %r" % kind)
    vals = np.asarray(vals, np.float32)
    if vals.size != L or np.any(np.diff(vals) <= 0):
        raise ValueError("levels of %r are not %d distinct sorted values"
                         % (v, L))
    return vals


def _lut(p: np.ndarray) -> np.ndarray:
    """[2^16] uint8 code of each 16-bit uniform draw."""
    edges = np.cumsum(p) * (1 << LUT_BITS)
    u = np.arange(1 << LUT_BITS) + 0.5
    lut = np.searchsorted(edges, u, side="right")
    return np.minimum(lut, p.size - 1).astype(np.uint8)


def draw_codes(config: dict, rows: int, rng: np.random.Generator):
    """([F, rows] uint8 codes, grids) of the config's columns."""
    specs = column_specs(config)
    codes = np.empty((len(specs), rows), np.uint8)
    grids = []
    for j, group in enumerate(specs):
        if int(group["levels"]) > 256:
            raise ValueError("a column holds at most 256 levels")
        lut = _lut(level_probs(group))
        codes[j] = lut[rng.integers(0, 1 << LUT_BITS, rows, dtype=np.uint16)]
        grids.append(level_values(group))
    return codes, grids


def values_of(codes: np.ndarray, grids: List[np.ndarray]) -> np.ndarray:
    """[N, F] float32 raw values of [F, N] codes."""
    F, N = codes.shape
    x = np.empty((N, F), np.float32)
    for j in range(F):
        x[:, j] = grids[j][codes[j]]
    return x


def _centred(codes_row: np.ndarray, levels: int) -> np.ndarray:
    return (codes_row.astype(np.float32) + 0.5) / levels - 0.5


def query_sizes(config: dict) -> np.ndarray:
    """The fixed multiset of query lengths (documents a query): log-normal
    quantiles clipped to [1, max], scaled so they sum to ``rows``."""
    q = config["queries"]
    nq, rows = int(q["count"]), int(config["rows"])
    z = _normal_quantiles(nq)
    raw = np.exp(math.log(q["median"]) + q["sigma"] * z)
    sizes = np.clip(np.round(raw * rows / raw.sum()), 1,
                    q["max"]).astype(np.int64)
    # settle the rounding on the middle of the distribution
    diff = rows - int(sizes.sum())
    mid = np.argsort(np.abs(z))
    step = 1 if diff > 0 else -1
    i = 0
    while diff != 0:
        k = mid[i % nq]
        if 1 <= sizes[k] + step <= q["max"]:
            sizes[k] += step
            diff -= step
        i += 1
    return sizes


def make_table(config: dict, seed: int) -> Table:
    """The configuration's training table from ``seed``."""
    N = int(config["rows"])
    rng = rng_for(seed, 1)
    codes, grids = draw_codes(config, N, rng)
    x = values_of(codes, grids)
    lab = config["label"]
    srng = np.random.Generator(np.random.PCG64(STRUCTURE_SEED))
    inf = lab["informative"]
    levels = [int(column_specs(config)[c]["levels"]) for c in inf]
    amp = srng.uniform(0.5, 1.5, len(inf)).astype(np.float32)
    freq = srng.uniform(1.0, 3.0, len(inf)).astype(np.float32)
    latent = np.zeros(N, np.float32)
    for k, c in enumerate(inf):
        latent += amp[k] * np.sin(np.float32(math.pi) * freq[k]
                                  * _centred(codes[c], levels[k]))
    for a, b in lab.get("pairs", []):
        latent += 4.0 * (_centred(codes[a], levels[inf.index(a)])
                         * _centred(codes[b], levels[inf.index(b)]))
    latent += rng.logistic(0.0, lab["noise"], N).astype(np.float32)
    qb = None
    if "queries" in config:
        sizes = rng.permutation(query_sizes(config))
        qb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        qeff = rng.normal(0.0, lab["query_effect"], sizes.size)
        latent += np.repeat(qeff, sizes).astype(np.float32)
    if lab["kind"] == "binary":
        cut = np.quantile(latent, 1.0 - lab["positive_share"])
        y = (latent > cut).astype(np.float32)
    else:
        shares = np.asarray(lab["shares"], np.float64)
        cuts = np.quantile(latent, np.cumsum(shares)[:-1])
        y = np.searchsorted(cuts, latent).astype(np.float32)
    return Table(x, y, codes, grids, qb)


def make_pool(config: dict, seed: int, rows: int):
    """([rows, F] float32 request rows, [F, rows] codes, grids): rows of
    the configuration's shape for serving."""
    codes, grids = draw_codes(config, rows, rng_for(seed, 2))
    return values_of(codes, grids), codes, grids


def request_sizes(traffic: dict) -> np.ndarray:
    """The fixed multiset of request sizes: ``count`` log-uniform
    quantiles over [rows_min, rows_max]."""
    n = int(traffic["sizes"])
    lo, hi = math.log(traffic["rows_min"]), math.log(traffic["rows_max"])
    u = (np.arange(n) + 0.5) / n
    return np.round(np.exp(lo + (hi - lo) * u)).astype(np.int64)


def client_streams(traffic: dict, seed: int, pool_rows: int):
    """Per client, its list of (size, pool offset): the fixed sizes dealt
    round-robin after a shuffle by ``seed``."""
    rng = rng_for(seed, 3)
    sizes = rng.permutation(request_sizes(traffic))
    offs = rng.integers(0, pool_rows - sizes + 1)
    k = int(traffic["clients"])
    return [list(zip(sizes[c::k].tolist(), offs[c::k].tolist()))
            for c in range(k)]


class Ensemble(NamedTuple):
    """Random trees in the model text's node encoding (internal node s
    from the s-th split, leaves as ``~leaf``)."""
    split_feature: np.ndarray     # [T, L-1] int32 raw column
    threshold: np.ndarray         # [T, L-1] float64
    left_child: np.ndarray        # [T, L-1] int32
    right_child: np.ndarray       # [T, L-1] int32
    leaf_parent: np.ndarray       # [T, L] int32
    leaf_value: np.ndarray        # [T, L] float64


def random_ensemble(grids: List[np.ndarray], num_trees: int,
                    num_leaves: int, seed: int,
                    leaf_scale: float = 0.05) -> Ensemble:
    """``num_trees`` trees of ``num_leaves`` leaves grown leaf-wise at
    random: each split takes a leaf, a column and a cut between two of
    the column's levels, all uniform."""
    rng = rng_for(seed, 4)
    T, L, F = num_trees, num_leaves, len(grids)
    pick = rng.random((T, L - 1))
    feat = rng.integers(0, F, (T, L - 1))
    cut = rng.random((T, L - 1))
    values = rng.normal(0.0, leaf_scale, (T, L))
    mids = [(g[:-1].astype(np.float64) + g[1:].astype(np.float64)) / 2.0
            for g in grids]
    sf = feat.astype(np.int32)
    thr = np.empty((T, L - 1), np.float64)
    lc = np.empty((T, L - 1), np.int32)
    rc = np.empty((T, L - 1), np.int32)
    lp = np.empty((T, L), np.int32)
    for t in range(T):
        parent = [-1]                      # leaf -> its parent node
        side = [0]                         # 0 left, 1 right of the parent
        for s in range(L - 1):
            leaf = int(pick[t, s] * (s + 1))
            m = mids[sf[t, s]]
            thr[t, s] = m[int(cut[t, s] * m.size)]
            p = parent[leaf]
            if p >= 0:
                (lc if side[leaf] == 0 else rc)[t, p] = s
            lc[t, s], rc[t, s] = ~leaf, ~(s + 1)
            parent[leaf], side[leaf] = s, 0
            parent.append(s)
            side.append(1)
        lp[t] = parent
    return Ensemble(sf, thr, lc, rc, lp, values)


def model_text(ens: Ensemble, num_features: int) -> str:
    """The ensemble as LightGBM model text (binary, raw scores)."""
    out = ["gbdt", "num_class=1", "label_index=0",
           "max_feature_idx=%d" % (num_features - 1), "sigmoid=1.0", ""]
    T, L = ens.leaf_value.shape
    for t in range(T):
        out += ["Tree=%d" % t, "num_leaves=%d" % L,
                "split_feature=" + " ".join(map(str, ens.split_feature[t])),
                "split_gain=" + " ".join(["1"] * (L - 1)),
                "threshold=" + " ".join(map(repr, ens.threshold[t].tolist())),
                "left_child=" + " ".join(map(str, ens.left_child[t])),
                "right_child=" + " ".join(map(str, ens.right_child[t])),
                "leaf_parent=" + " ".join(map(str, ens.leaf_parent[t])),
                "leaf_value=" + " ".join(map(repr,
                                             ens.leaf_value[t].tolist())),
                "", ""]
    return "\n".join(out) + "\n"
