"""Host-side classification of winner disagreements between two
nearest-triangle sweeps over the same rays (ops/trace_kernel against
ops/intersect._intersect_tri_raw, both float32 Moller-Trumbore).

Two float32 programs that fuse the same formula differently can pick a
different winner for a handful of rays, in exactly two benign ways,
each verified per ray in float64:

  * ULP TIE: both winners sit at the same t to ~7 significant digits
    (duplicated tessellation edges, shared vertices);
  * KNIFE EDGE: one winner is a hit whose exact u, v, u+v or |det| lies
    within rounding of an accept boundary, so one program accepts it
    and the other returns the next-nearest hit (or a miss).

Any mismatch that fits neither class is counted as unexplained.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _tuvd(o, d, v0, v1, v2):
    """float64 (t, u, v, det) of one ray against one triangle, or None
    for a degenerate pair."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = np.cross(d, e2)
    det = float(np.dot(e1, p))
    if abs(det) < 1e-12:
        return None
    tv = o - v0
    q = np.cross(tv, e1)
    return (float(np.dot(e2, q)) / det, float(np.dot(tv, p)) / det,
            float(np.dot(d, q)) / det, det)


def _edge_margin(r):
    """Distance of (u, v, det) from the nearest accept boundary, and the
    float32 rounding band it must fall in to count as a knife edge."""
    _, u, v, det = r
    edge = min(abs(u), abs(v), abs(1.0 - u - v), abs(1.0 - u),
               abs(1.0 - v), abs(abs(det) - 1e-6) * 1e3)
    return edge, max(1e-5, 5e-7 / max(abs(det), 1e-12))


def classify_mismatches(orig, d, v0, v1, v2, idx_a, idx_b) -> Dict:
    """Compare per-ray winners idx_a / idx_b ((N,) i32, -1 = miss) over
    rays orig/d (N,3) and triangles v0/v1/v2 (F,3), all host arrays.
    Returns counts {rays, mismatched, agree_frac, ulp_tie, knife_edge,
    unexplained} and the largest relative t gap among ULP ties."""
    idx_a = np.asarray(idx_a).reshape(-1)
    idx_b = np.asarray(idx_b).reshape(-1)
    mism = np.flatnonzero(idx_a != idx_b)
    out = {"rays": int(idx_a.size), "mismatched": int(mism.size),
           "agree_frac": 1.0 - mism.size / max(idx_a.size, 1),
           "ulp_tie": 0, "knife_edge": 0, "unexplained": 0,
           "max_rel_t_tie": 0.0}
    if not mism.size:
        return out
    o = np.asarray(orig, np.float64)[mism]
    dd = np.asarray(d, np.float64)[mism]
    v0, v1, v2 = (np.asarray(a, np.float64) for a in (v0, v1, v2))

    def at(fi, k):
        return None if fi < 0 else _tuvd(o[k], dd[k], v0[fi], v1[fi], v2[fi])

    for k, ray in enumerate(mism):
        ra, rb = at(int(idx_a[ray]), k), at(int(idx_b[ray]), k)
        if ra is not None and rb is not None:
            rel = abs(ra[0] - rb[0]) / max(abs(rb[0]), 1e-12)
            if rel <= 1e-4:
                out["ulp_tie"] += 1
                out["max_rel_t_tie"] = max(out["max_rel_t_tie"], rel)
                continue
        # knife edge: the nearer of the two winners sits on an accept
        # boundary (the other program rejected it and went farther)
        near = [r for r in (ra, rb) if r is not None]
        near.sort(key=lambda r: r[0])
        if near:
            edge, tol = _edge_margin(near[0])
            if edge <= tol:
                out["knife_edge"] += 1
                continue
        out["unexplained"] += 1
    return out
