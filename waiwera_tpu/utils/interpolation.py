"""1-D interpolation tables with linear / step / pchip variants and
endpoint / integration averaging over an interval.

Functional JAX counterpart of the reference's interpolation module
(/root/reference/src/interpolation.F90:25-33,140-175): tables are static
(data fixed at construction, baked into the jitted program as constants),
evaluation points are traced. Out-of-range evaluation clamps to the end
values, matching the reference's coordinate ``find`` behaviour.

Used by source/boundary/rock table controls, table relative
permeability / capillary pressure curves, and initial conditions.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

Array = jnp.ndarray

INTERP_LINEAR = "linear"
INTERP_STEP = "step"
INTERP_PCHIP = "pchip"
AVERAGING_ENDPOINT = "endpoint"
AVERAGING_INTEGRATE = "integrate"


def _pchip_derivatives(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Fritsch-Carlson monotone cubic derivative estimates (per column).

    x: [n], y: [n, m] -> d: [n, m]
    """
    n = len(x)
    if n == 1:
        return np.zeros_like(y)
    h = np.diff(x)[:, None]  # [n-1, 1]
    delta = np.diff(y, axis=0) / h  # [n-1, m]
    d = np.zeros_like(y)
    if n == 2:
        d[0] = delta[0]
        d[1] = delta[0]
        return d
    # interior points: weighted harmonic mean where slopes agree in sign
    h0 = h[:-1]
    h1 = h[1:]
    w1 = 2 * h1 + h0
    w2 = h1 + 2 * h0
    with np.errstate(divide="ignore", invalid="ignore"):
        dk = (w1 + w2) / (w1 / delta[:-1] + w2 / delta[1:])
    sign_ok = (np.sign(delta[:-1]) * np.sign(delta[1:])) > 0
    d[1:-1] = np.where(sign_ok, np.nan_to_num(dk), 0.0)

    # endpoints: one-sided three-point estimate, clipped for monotonicity
    def _end(h_a, h_b, del_a, del_b):
        dd = ((2 * h_a + h_b) * del_a - h_a * del_b) / (h_a + h_b)
        dd = np.where(np.sign(dd) != np.sign(del_a), 0.0, dd)
        lim = np.abs(3 * del_a)
        dd = np.where(
            (np.sign(del_a) != np.sign(del_b)) & (np.abs(dd) > lim),
            3 * del_a,
            dd,
        )
        return dd

    d[0] = _end(h[0], h[1], delta[0], delta[1])
    d[-1] = _end(h[-1], h[-2], delta[-1], delta[-2])
    return d


def _eval_knots(x: Array, y: Array, deriv, interpolation: str, xi):
    """Interpolate table (x [n], y [n, m]) at xi (any shape) ->
    [..., m]. End-clamped, like the reference's coordinate find."""
    n = x.shape[0]
    m = y.shape[1]
    if n == 1:
        return jnp.broadcast_to(y[0], jnp.shape(xi) + (m,))
    xc = jnp.clip(xi, x[0], x[-1])
    k = jnp.clip(jnp.searchsorted(x, xc, side="right") - 1, 0, n - 2)
    x0 = x[k]
    x1 = x[k + 1]
    h = x1 - x0
    s = (xc - x0) / jnp.where(h > 0, h, 1.0)
    y0 = y[k]
    y1 = y[k + 1]
    if interpolation == INTERP_STEP:
        ks = jnp.clip(
            jnp.searchsorted(x, xc, side="right") - 1, 0, n - 1
        )
        return y[ks]
    if interpolation == INTERP_PCHIP:
        d = deriv
        d0 = d[k] * h[..., None]
        d1 = d[k + 1] * h[..., None]
        s_ = s[..., None]
        h00 = (1 + 2 * s_) * (1 - s_) ** 2
        h10 = s_ * (1 - s_) ** 2
        h01 = s_ * s_ * (3 - 2 * s_)
        h11 = s_ * s_ * (s_ - 1)
        return h00 * y0 + h10 * d0 + h01 * y1 + h11 * d1
    return y0 + s[..., None] * (y1 - y0)


def _integral_knots(x: Array, y: Array, deriv, interpolation: str, a, b):
    """Definite integral of each column over [a, b] (a <= b), with
    end-clamped extension outside the knots."""
    n = x.shape[0]
    if n == 1:
        return (b - a)[..., None] * y[0]
    lo = jnp.minimum(b, x[0]) - jnp.minimum(a, x[0])
    hi = jnp.maximum(b, x[-1]) - jnp.maximum(a, x[-1])
    total = lo[..., None] * y[0] + hi[..., None] * y[-1]
    ac = jnp.clip(a, x[0], x[-1])
    bc = jnp.clip(b, x[0], x[-1])
    x0 = x[:-1]
    x1 = x[1:]
    hseg = x1 - x0
    hsafe = jnp.where(hseg > 0, hseg, 1.0)
    s0 = jnp.clip((ac[..., None] - x0) / hsafe, 0.0, 1.0)
    s1 = jnp.clip((bc[..., None] - x0) / hsafe, 0.0, 1.0)
    h = hseg[..., None]  # [nseg, 1]
    y0 = y[:-1]
    y1 = y[1:]
    if interpolation == INTERP_STEP:
        seg = (s1 - s0)[..., None] * h * y0
    elif interpolation == INTERP_PCHIP:
        d = deriv
        d0 = d[:-1] * h
        d1 = d[1:] * h

        def anti(s):
            s = s[..., None]
            s2 = s * s
            s3 = s2 * s
            s4 = s2 * s2
            H00 = s - s3 + s4 / 2.0
            H10 = s2 / 2.0 - 2.0 * s3 / 3.0 + s4 / 4.0
            H01 = s3 - s4 / 2.0
            H11 = s4 / 4.0 - s3 / 3.0
            return H00 * y0 + H10 * d0 + H01 * y1 + H11 * d1

        seg = h * (anti(s1) - anti(s0))
    else:
        seg = (
            (s1 - s0)[..., None]
            * h
            * (y0 + 0.5 * (s0 + s1)[..., None] * (y1 - y0))
        )
    return total + jnp.sum(seg, axis=-2)


class InterpolationTable:
    """Static 1-D table y(x) with vectorised evaluation and interval
    averaging.

    ``data`` is [n, 1 + m]: first column is the coordinate, remaining
    columns the values. Rows are sorted by coordinate at construction.
    """

    def __init__(
        self,
        data,
        interpolation: str = INTERP_LINEAR,
        averaging: str = AVERAGING_INTEGRATE,
    ):
        data = np.asarray(data, dtype=np.float64)
        if data.ndim == 1:
            data = data[None, :]
        order = np.argsort(data[:, 0], kind="stable")
        data = data[order]
        self.x = data[:, 0]
        self.y = data[:, 1:]
        self.n = len(self.x)
        self.dim = self.y.shape[1]
        self.interpolation = interpolation
        self.averaging = averaging
        if interpolation == INTERP_PCHIP:
            self.deriv = _pchip_derivatives(self.x, self.y)
        else:
            self.deriv = None

    # -- evaluation --------------------------------------------------

    def __call__(self, xi) -> Array:
        """Interpolate all columns at xi (any shape); returns
        [..., dim]."""
        xi = jnp.asarray(xi, jnp.float64)
        return _eval_knots(
            jnp.asarray(self.x),
            jnp.asarray(self.y),
            None if self.deriv is None else jnp.asarray(self.deriv),
            self.interpolation,
            xi,
        )

    def component(self, xi, index: int = 0) -> Array:
        return self(xi)[..., index]

    # -- interval averaging -----------------------------------------

    def integral(self, a, b) -> Array:
        """Definite integral of each column over [a, b] (a <= b),
        with end-clamped extension outside the table."""
        a = jnp.asarray(a, jnp.float64)
        b = jnp.asarray(b, jnp.float64)
        return _integral_knots(
            jnp.asarray(self.x),
            jnp.asarray(self.y),
            None if self.deriv is None else jnp.asarray(self.deriv),
            self.interpolation,
            a,
            b,
        )

    def average(self, a, b) -> Array:
        """Average of each column over interval [a, b].

        'endpoint' averages the two endpoint evaluations; 'integrate'
        uses the exact integral (interpolation.F90:140-175). A
        zero-length interval degenerates to point evaluation.
        """
        a = jnp.asarray(a, jnp.float64)
        b = jnp.asarray(b, jnp.float64)
        if self.averaging == AVERAGING_ENDPOINT:
            return 0.5 * (self(a) + self(b))
        length = b - a
        point = self(a)
        nonzero = jnp.abs(length) > 0.0
        safe = jnp.where(nonzero, length, 1.0)
        avg = self.integral(jnp.minimum(a, b), jnp.maximum(a, b)) / jnp.abs(
            safe
        )[..., None]
        return jnp.where(nonzero[..., None], avg, point)

    def inverse(self, yi, index: int = 0) -> Array:
        """Inverse interpolation of one column (assumed monotone):
        find x such that y[index](x) = yi, linear variant only."""
        yv = jnp.asarray(self.y[:, index])
        x = jnp.asarray(self.x)
        yi = jnp.asarray(yi, jnp.float64)
        increasing = bool(self.y[-1, index] >= self.y[0, index])
        yq = yv if increasing else -yv
        ti = yi if increasing else -yi
        k = jnp.clip(jnp.searchsorted(yq, ti, side="right") - 1, 0, self.n - 2)
        y0 = yv[k]
        y1 = yv[k + 1]
        s = jnp.where(jnp.abs(y1 - y0) > 0, (yi - y0) / (y1 - y0), 0.0)
        s = jnp.clip(s, 0.0, 1.0)
        return x[k] + s * (x[k + 1] - x[k])


class StackedTables:
    """k tables evaluated batched: one vmapped pass instead of k
    Python-loop evaluations with .at[i].set (which would otherwise
    unroll into the traced residual).

    Tables are padded to a common knot count by appending knots a tiny
    (1e-12-relative) epsilon past the last coordinate with the last
    value repeated (and pchip derivative 0), so padded evaluation and
    integration reproduce the single-table end-clamping to machine
    precision. All tables must share the interpolation variant and
    value dimension; averaging may differ per table (endpoint vs
    integrate handled by a row mask).
    """

    def __init__(self, tables):
        tables = list(tables)
        if not tables:
            raise ValueError("empty table stack")
        interp = tables[0].interpolation
        dim = tables[0].dim
        for t in tables:
            if t.interpolation != interp or t.dim != dim:
                raise ValueError(
                    "stacked tables must share interpolation and dim"
                )
        self.k = len(tables)
        self.dim = dim
        self.interpolation = interp
        n = max(max(t.n for t in tables), 2)
        xs = np.zeros((self.k, n))
        ys = np.zeros((self.k, n, dim))
        ds = np.zeros((self.k, n, dim)) if interp == INTERP_PCHIP else None
        for i, t in enumerate(tables):
            xs[i, : t.n] = t.x
            ys[i, : t.n] = t.y
            if ds is not None and t.deriv is not None:
                ds[i, : t.n] = t.deriv
            if t.n < n:
                eps = max(abs(t.x[-1]) * 1e-12, 1e-30)
                pad = t.x[-1] + eps * np.arange(1, n - t.n + 1)
                xs[i, t.n :] = pad
                ys[i, t.n :] = t.y[-1]
        self.x = jnp.asarray(xs)
        self.y = jnp.asarray(ys)
        self.deriv = None if ds is None else jnp.asarray(ds)
        self.endpoint_mask = jnp.asarray(
            [t.averaging == AVERAGING_ENDPOINT for t in tables]
        )

    def __call__(self, xi) -> Array:
        """xi: [k] (one abscissa per table) -> [k, dim]."""
        xi = jnp.asarray(xi, jnp.float64)
        fn = lambda x, y, d, v: _eval_knots(x, y, d, self.interpolation, v)
        if self.deriv is None:
            return jax.vmap(lambda x, y, v: fn(x, y, None, v))(
                self.x, self.y, xi
            )
        return jax.vmap(fn)(self.x, self.y, self.deriv, xi)

    def average(self, a, b) -> Array:
        """Average over [a, b] (scalars, shared by all rows) ->
        [k, dim]; per-row endpoint/integrate averaging."""
        a = jnp.asarray(a, jnp.float64)
        b = jnp.asarray(b, jnp.float64)
        av = jnp.broadcast_to(a, (self.k,))
        bv = jnp.broadcast_to(b, (self.k,))
        end = 0.5 * (self(av) + self(bv))
        lo = jnp.minimum(a, b)
        hi = jnp.maximum(a, b)

        def integ(x, y, d):
            return _integral_knots(
                x, y, d, self.interpolation, lo, hi
            )

        if self.deriv is None:
            ints = jax.vmap(lambda x, y: integ(x, y, None))(self.x, self.y)
        else:
            ints = jax.vmap(integ)(self.x, self.y, self.deriv)
        length = hi - lo
        nonzero = length > 0.0
        mean = ints / jnp.where(nonzero, length, 1.0)
        point = self(av)
        integrated = jnp.where(nonzero, mean, point)
        return jnp.where(self.endpoint_mask[:, None], end, integrated)


class SparseTableUpdate:
    """Applies batched table evaluations to a subset of rows of a
    dense per-item array: out = base with out[idx] <- tables(t0, t1).

    idx rows not covered keep their constant `base` values. Grouping
    is by (interpolation, dim): tables of different variants go in
    separate stacks built by `build_sparse_updates`.
    """

    def __init__(self, indices, stack: StackedTables):
        self.indices = jnp.asarray(np.asarray(indices, np.int64), jnp.int32)
        self.stack = stack

    def average_into(self, base: Array, t0, t1, column: int = 0) -> Array:
        vals = self.stack.average(t0, t1)[:, column]
        return base.at[self.indices].set(vals)

    def eval_into(self, base: Array, xi: Array, column: int = 0) -> Array:
        """xi: full-length per-item abscissae; rows idx are replaced by
        their table evaluated at xi[idx]."""
        vals = self.stack(xi[self.indices])[:, column]
        return base.at[self.indices].set(vals)


def build_sparse_updates(tables_by_index):
    """[(index, table), ...] -> list of SparseTableUpdate, grouped so
    each group's tables share interpolation variant and dim."""
    groups = {}
    for i, t in tables_by_index:
        if t is None:
            continue
        groups.setdefault((t.interpolation, t.dim), []).append((i, t))
    out = []
    for (_, _), items in groups.items():
        idx = [i for i, _ in items]
        out.append(
            SparseTableUpdate(idx, StackedTables([t for _, t in items]))
        )
    return out


def from_json(data, spec: dict | None = None) -> InterpolationTable:
    """Build a table from JSON-style data ([[x, y...], ...]) plus an
    optional spec with 'interpolation' and 'averaging' keys."""
    spec = spec or {}
    return InterpolationTable(
        data,
        interpolation=spec.get("interpolation", INTERP_LINEAR),
        averaging=spec.get("averaging", AVERAGING_INTEGRATE),
    )
