"""A tiny per-sample numpy re-statement of the reference FTRL algorithm.

Written independently from the C++ (no code copied) purely as a test oracle:
sequential, sample-at-a-time FTRL exactly as the reference's single-threaded
semantics (reference: src/model/ftrl_model.cpp, src/model/fm.cpp,
src/model/ffm.cpp).  Used to prove the batched device step reproduces the
reference trajectory at batch size 1.
"""

from __future__ import annotations

import numpy as np


def closed_form(n, z, alpha, beta, l1, l2):
    n = np.asarray(n, np.float32)
    z = np.asarray(z, np.float32)
    sgn = np.where(z > 0, 1.0, -1.0).astype(np.float32)
    w = -(z - sgn * l1) / (l2 + (beta + np.sqrt(n)) / alpha)
    return np.where(np.abs(z) <= l1, np.float32(0.0), w).astype(np.float32)


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class Oracle:
    """model_type in {"LR", "FM", "FFM"}; factors use keep_init semantics when
    vec_init is provided, reference semantics (f(n,z) always) otherwise."""

    def __init__(
        self,
        model_type: str,
        n_feats: int,
        n_fields: int = 1,
        n_factors: int = 0,
        alpha: float = 1e-4,
        beta: float = 1.0,
        l1: float = 0.1,
        l2: float = 5.0,
        vec_init: np.ndarray | None = None,
    ):
        self.mt = model_type
        self.hp = (alpha, beta, l1, l2)
        self.alpha = alpha
        self.n_feats = n_feats
        self.n_fields = n_fields
        self.k = n_factors
        self.bias_n = np.float32(0.0)
        self.bias_z = np.float32(0.0)
        self.lin_n = np.zeros(n_feats, np.float32)
        self.lin_z = np.zeros(n_feats, np.float32)
        d = (n_fields if model_type == "FFM" else 1) * n_factors
        self.vec_n = np.zeros((n_feats, d), np.float32)
        self.vec_z = np.zeros((n_feats, d), np.float32)
        self.vec_init = vec_init  # [n_feats, d] or None

    # weights derived exactly like the batched build
    def _lin_w(self, ids):
        return closed_form(self.lin_n[ids], self.lin_z[ids], *self.hp)

    def _vec_w(self, i):
        w = closed_form(self.vec_n[i], self.vec_z[i], *self.hp)
        if self.vec_init is not None:
            untouched = (self.vec_n[i] == 0) & (self.vec_z[i] == 0)
            w = np.where(untouched, self.vec_init[i], w)
        return w

    def _bias_w(self):
        return closed_form(self.bias_n, self.bias_z, *self.hp)

    def logit(self, fields, ids, vals):
        ids = np.asarray(ids)
        vals = np.asarray(vals, np.float32)
        res = self._bias_w() + np.dot(self._lin_w(ids), vals)
        if self.mt == "FM":
            v = np.stack([self._vec_w(i) for i in ids])  # [m, k]
            vx = v * vals[:, None]
            s = vx.sum(0)
            res += 0.5 * float((s * s).sum() - (vx * vx).sum())
        elif self.mt == "FFM":
            m = len(ids)
            for a in range(m):
                va = self._vec_w(ids[a]).reshape(self.n_fields, self.k)
                for b in range(a + 1, m):
                    vb = self._vec_w(ids[b]).reshape(self.n_fields, self.k)
                    dot = float(np.dot(va[fields[b]], vb[fields[a]]))
                    res += dot * vals[a] * vals[b]
        return float(res)

    def train(self, fields, ids, vals, y):
        """One per-sample step; returns the pre-update logit."""
        fields = np.asarray(fields)
        ids = np.asarray(ids)
        vals = np.asarray(vals, np.float32)
        logit = self.logit(fields, ids, vals)
        g = np.float32(sigmoid(logit) - y)

        # linear + bias
        w = self._lin_w(ids)
        for t, i in enumerate(ids):
            gi = g * vals[t]
            si = (np.sqrt(self.lin_n[i] + gi * gi) - np.sqrt(self.lin_n[i])) / self.alpha
            self.lin_z[i] += gi - si * w[t]
            self.lin_n[i] += gi * gi
        bw = self._bias_w()
        sb = (np.sqrt(self.bias_n + g * g) - np.sqrt(self.bias_n)) / self.alpha
        self.bias_z += g - sb * bw
        self.bias_n += g * g

        if self.mt == "FM":
            v = np.stack([self._vec_w(i) for i in ids])
            s_vx = (v * vals[:, None]).sum(0)
            for t, i in enumerate(ids):
                gv = g * (vals[t] * s_vx - v[t] * vals[t] * vals[t])
                sv = (np.sqrt(self.vec_n[i] + gv * gv) - np.sqrt(self.vec_n[i])) / self.alpha
                self.vec_z[i] += gv - sv * v[t]
                self.vec_n[i] += gv * gv
        elif self.mt == "FFM":
            # batched-within-sample semantics (matches the batched build): grads on
            # each slot summed over partners before one accumulator step.
            m = len(ids)
            v = np.stack([self._vec_w(i) for i in ids]).reshape(
                m, self.n_fields, self.k
            )
            gv = np.zeros_like(v)
            for a in range(m):
                for b in range(m):
                    if a == b:
                        continue
                    # grad on a's slot (field_b) from partner b
                    gv[a, fields[b]] += g * v[b, fields[a]] * vals[a] * vals[b]
            for t, i in enumerate(ids):
                gvf = gv[t].reshape(-1)
                wv = self._vec_w(i)
                sv = (np.sqrt(self.vec_n[i] + gvf * gvf) - np.sqrt(self.vec_n[i])) / self.alpha
                self.vec_z[i] += gvf - sv * wv
                self.vec_n[i] += gvf * gvf
        return logit
