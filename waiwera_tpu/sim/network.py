"""Source network: controls, separators, groups and reinjectors.

JAX counterpart of the reference's source network subsystem
(source_control.F90, separator.F90, source_network_node.F90,
source_network_group.F90, source_network_reinjector.F90,
source_network.F90, source_setup.F90). The reference updates the
network mutably inside every RHS evaluation via list traversals and MPI
reductions; here the whole update is a pure jnp function of the fluid
state, traced into the residual:

- per-source controls (rate/enthalpy/rate-factor tables, deliverability,
  recharge/injectivity, direction) are vectorised over sources;
- separators are closed-form (steam fraction from enthalpy at separator
  pressure, separator.F90:141-166), with stage reference enthalpies
  precomputed on host;
- groups and reinjectors are tiny scalar DAGs, unrolled in Python in a
  host-precomputed topological order (replacing dag.F90 + MPI gathers);
- group scaling / reinjection rates are wrapped in stop_gradient so the
  AD block Jacobian keeps only cell-local source derivatives (the
  reference similarly treats network couplings via extra FD sparsity,
  flow_simulation.F90:3023-3084; lagging them preserves the exact
  residual).

Deliverability (source_control.F90:359-403):
  q = -PI * permeability_factor * sum_p mobility_p * (P - Pref)
with PI from value/table or computed from an initial rate
(:408-470), and Pref constant, 'initial', or a table vs
time/enthalpy/pressure. Recharge (:516-577): q = -coeff * (P - Pref).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from waiwera_tpu.sim.sources import SourceArrays, source_inflows  # noqa: F401
from waiwera_tpu.utils.interpolation import (
    InterpolationTable,
    from_json as table_from_json,
)

Array = jnp.ndarray

# flow types (separator.F90:30-31)
FLOW_TOTAL, FLOW_WATER, FLOW_STEAM = 0, 1, 2
# directions (source_control.F90:38-40)
DIR_BOTH, DIR_PRODUCTION, DIR_INJECTION = 0, 1, 2
# reference pressure coordinate (source_control.F90:41-43)
PREF_TIME, PREF_ENTHALPY, PREF_PRESSURE, PREF_INITIAL = 0, 1, 2, 3

DEFAULT_PRODUCTIVITY = 1.0e-11
DEFAULT_REFERENCE_PRESSURE = 1.0e5
DEFAULT_RECHARGE_COEFFICIENT = 1.0e-2
DEFAULT_SEPARATOR_PRESSURE = 0.55e6
DEFAULT_INJECTION_ENTHALPY = 83.9e3
RATE_TOL = 1.0e-9
LIMIT_SMALL = 1.0e-6


def _direction_from_str(s) -> int:
    s = str(s).lower()
    if s in ("production", "out"):
        return DIR_PRODUCTION
    if s in ("injection", "in"):
        return DIR_INJECTION
    return DIR_BOTH


def _scalar_or_table(value, spec, default):
    """Returns (const_value, table_or_None)."""
    if value is None:
        return float(default), None
    if isinstance(value, (int, float)):
        return float(value), None
    return 0.0, table_from_json(value, spec)


def _flash_stage(h, hw_ref, hs_ref):
    """One separator flash stage (separator.F90:141-166): steam
    fraction from the inflow enthalpy against the stage's saturated
    water/steam reference enthalpies, plus the stage's outflow
    water/steam enthalpies. Shared by the scalar per-node separator
    (_Separator.separate) and the stacked per-source vectorised path
    (SourceNetwork._separated)."""
    sf = jnp.where(
        h <= hw_ref,
        0.0,
        jnp.where(
            h <= hs_ref,
            (h - hw_ref)
            / jnp.where(hs_ref > hw_ref, hs_ref - hw_ref, 1.0),
            1.0,
        ),
    )
    hs = jnp.where(h <= hw_ref, 0.0, jnp.where(h <= hs_ref, hs_ref, h))
    hw = jnp.where(h <= hw_ref, h, jnp.where(h <= hs_ref, hw_ref, 0.0))
    return sf, hw, hs


def _flash_out_enthalpy(steam_mass, steam_energy):
    """Mass-weighted steam enthalpy over accumulated stages, zero for
    negligible rates (separator.F90:215-260)."""
    nz = jnp.abs(steam_mass) > RATE_TOL
    return jnp.where(
        nz, steam_energy / jnp.where(nz, steam_mass, 1.0), 0.0
    )


@dataclass
class _Separator:
    """Host-side separator stage data (pressures + reference
    enthalpies precomputed from the water thermodynamics,
    separator.F90:113-136)."""

    on: bool = False
    pressures: List[float] = field(default_factory=list)
    ref_water_h: List[float] = field(default_factory=list)
    ref_steam_h: List[float] = field(default_factory=list)

    @staticmethod
    def build(pressures, thermo) -> "_Separator":
        if pressures is None:
            return _Separator()
        pressures = [float(p) for p in np.atleast_1d(pressures)]
        if any(p <= 0 for p in pressures):
            return _Separator()
        sep = _Separator(on=True, pressures=pressures)
        for p in pressures:
            pa = jnp.asarray([p])
            ts, _ = thermo.saturation_temperature(pa)
            dw, uw, _ = thermo.water_properties(pa, ts)
            ds, us, _ = thermo.steam_properties(pa, ts)
            sep.ref_water_h.append(float(uw[0] + p / dw[0]))
            sep.ref_steam_h.append(float(us[0] + p / ds[0]))
        return sep

    def separate(self, q, h):
        """(q, h) -> (qw, hw, qs, hs); rates keep the sign of q
        (separator.F90:141-166, multi-stage :215-260)."""
        if not self.on:
            z = jnp.zeros_like(q)
            return z, z, z, z
        steam_mass = jnp.zeros_like(q)
        steam_energy = jnp.zeros_like(q)
        for hw_ref, hs_ref in zip(self.ref_water_h, self.ref_steam_h):
            sf, hw, hs = _flash_stage(h, hw_ref, hs_ref)
            qs = sf * q
            steam_mass = steam_mass + qs
            steam_energy = steam_energy + qs * hs
            q = (1.0 - sf) * q
            h = hw
        return q, h, steam_mass, _flash_out_enthalpy(
            steam_mass, steam_energy
        )


@dataclass
class _Limiter:
    """Flow limits by type; None = unlimited. Each entry is
    (constant, table_or_None)."""

    total: Optional[Tuple[float, Optional[InterpolationTable]]] = None
    water: Optional[Tuple[float, Optional[InterpolationTable]]] = None
    steam: Optional[Tuple[float, Optional[InterpolationTable]]] = None

    @staticmethod
    def parse(cfg, spec) -> Optional["_Limiter"]:
        if not cfg:
            return None
        lim = _Limiter()
        if "limit" in cfg:
            ftype = str(cfg.get("type", "total")).lower()
            setattr(lim, ftype if ftype in ("water", "steam") else "total",
                    _scalar_or_table(cfg["limit"], spec, 1.0))
        for key in ("total", "water", "steam"):
            if key in cfg:
                setattr(lim, key, _scalar_or_table(cfg[key], spec, 1.0))
        return lim

    def limits_at(self, t0, t1):
        out = {}
        for ft, entry in (
            (FLOW_TOTAL, self.total),
            (FLOW_WATER, self.water),
            (FLOW_STEAM, self.steam),
        ):
            if entry is None:
                continue
            const, tab = entry
            out[ft] = tab.average(t0, t1)[0] if tab is not None else const

        return out

    @staticmethod
    def separator_pressure(cfg):
        """A water/steam limiter with separator_pressure implies a
        separator on the node (source_setup.F90:2255-2310)."""
        if not cfg:
            return None
        ftype = str(cfg.get("type", "")).lower()
        typed = ("water" in cfg) or ("steam" in cfg) or ftype in (
            "water", "steam"
        )
        if typed and "separator_pressure" in cfg:
            return cfg["separator_pressure"]
        return None


def _limit_scale(rates: Dict[int, Array], limits: Dict[int, Array]):
    """min over limited flow types of (limit/|rate|), 1 if under
    (source_network_node.F90:247-300)."""
    scale = None
    for ft, limit in limits.items():
        r = jnp.abs(rates[ft])
        s = jnp.where(
            r > limit,
            jnp.where(r > LIMIT_SMALL, limit / jnp.maximum(r, LIMIT_SMALL),
                      1.0),
            1.0,
        )
        scale = s if scale is None else jnp.minimum(scale, s)
    return scale


@dataclass
class _SourceSpec:
    """Per-source host data (one per cell for multi-cell specs)."""

    name: str = ""
    cell: int = 0
    inj_component: int = 1
    prod_component: int = 0
    rate_specified: bool = False
    base_rate: float = 0.0
    rate_table: Optional[InterpolationTable] = None
    enthalpy_specified: bool = False
    base_enthalpy: float = DEFAULT_INJECTION_ENTHALPY
    enthalpy_table: Optional[InterpolationTable] = None
    rate_factor_table: Optional[InterpolationTable] = None
    direction: int = DIR_BOTH
    # deliverability
    deliv: bool = False
    deliv_pi: float = DEFAULT_PRODUCTIVITY
    deliv_pi_table: Optional[InterpolationTable] = None
    deliv_pi_from_rate: bool = False
    deliv_pref_mode: int = PREF_TIME
    deliv_pref: float = DEFAULT_REFERENCE_PRESSURE
    deliv_pref_table: Optional[InterpolationTable] = None
    deliv_threshold: float = -1.0
    # recharge / injectivity
    recharge: bool = False
    recharge_coeff: float = DEFAULT_RECHARGE_COEFFICIENT
    recharge_coeff_table: Optional[InterpolationTable] = None
    recharge_pref_mode: int = PREF_TIME
    recharge_pref: float = DEFAULT_REFERENCE_PRESSURE
    recharge_pref_table: Optional[InterpolationTable] = None
    # separator / limiter
    separator: _Separator = field(default_factory=_Separator)
    limiter: Optional[_Limiter] = None
    # tracer injection rates, one entry (const, table) per tracer
    tracer_rates: List[Tuple[float, Optional[InterpolationTable]]] = field(
        default_factory=list
    )


@dataclass
class _Group:
    name: str
    members: List[str]
    separator: _Separator
    limiter: Optional[_Limiter]
    scaling: str  # 'uniform' | 'progressive'
    descendant_sources: List[int] = field(default_factory=list)
    member_descendants: List[List[int]] = field(default_factory=list)


@dataclass
class _ReinjectorOutput:
    target: str  # source or reinjector name
    flow_type: int  # FLOW_WATER or FLOW_STEAM
    kind: str  # 'rate' | 'proportion' | 'remaining'
    value: float = 0.0
    table: Optional[InterpolationTable] = None
    enthalpy: float = -1.0  # <0: use input enthalpy


@dataclass
class _Reinjector:
    name: str
    input: Optional[str]  # node name; None for overflow-fed
    outputs: List[_ReinjectorOutput]
    overflow: Optional[str]  # name of overflow reinjector


class NodeFlows:
    """Per-node scalar flows during an update."""

    __slots__ = ("q", "h", "qw", "hw", "qs", "hs")

    def __init__(self, q, h, qw, hw, qs, hs):
        self.q, self.h = q, h
        self.qw, self.hw, self.qs, self.hs = qw, hw, qs, hs


class SourceNetwork:
    """Parses the JSON 'source' + 'network' sections and provides the
    pure update function `flows(fluid, t0, t1)`.

    Counterpart of source_setup.F90 + source_network.F90; update order
    follows source_network_update (source_network.F90:91-127):
    separators -> source controls -> groups -> network controls
    (limiters) -> reinjector capacities -> reinjector distribution.
    """

    def __init__(self, specs: List[dict], network_cfg: dict, mesh, eos,
                 thermo, tracer_names=(), zones=None):
        self.eos = eos
        self.thermo = thermo
        self.isothermal = eos.isothermal
        self.tracer_names = [str(n).lower() for n in tracer_names]
        self.specs: List[_SourceSpec] = []
        self.names: List[str] = []
        cells_list = []

        for i, spec in enumerate(specs):
            cells = (
                [int(spec["cell"])]
                if "cell" in spec and spec["cell"] is not None
                else [int(c) for c in np.atleast_1d(spec.get("cells") or [])]
            )
            # zone-based placement (source_setup.F90:250-345,
            # setup_sources.rst "zones"): a source is added to each
            # cell of every listed zone, in addition to any cells
            znames = spec.get("zones", []) or []
            if isinstance(znames, str):
                znames = [znames]
            for zn in znames:
                if not zones or zn not in zones:
                    raise ValueError(
                        f"source {i}: unknown zone {zn!r}"
                    )
                cells.extend(int(c) for c in np.asarray(zones[zn]))
            if not cells:
                raise ValueError(f"source {i}: no cell given")
            ispec = {
                "interpolation": spec.get("interpolation", "linear"),
                "averaging": spec.get("averaging", "integrate"),
            }
            for c in cells:
                s = _SourceSpec()
                s.name = spec.get("name", f"source {i}")
                s.cell = c
                self._parse_source(s, spec, ispec)
                self.specs.append(s)
                self.names.append(s.name)
                cells_list.append(c)

        ns = len(self.specs)
        self.num_sources = ns
        self.arrays = SourceArrays(
            cell=jnp.asarray(np.asarray(cells_list, np.int64), jnp.int32),
            injection_component=jnp.asarray(
                [s.inj_component for s in self.specs], jnp.int32
            ),
            production_component=jnp.asarray(
                [s.prod_component for s in self.specs], jnp.int32
            ),
            volume=jnp.asarray(mesh.cell_volume[np.asarray(cells_list)]),
        )
        self.direction = np.asarray([s.direction for s in self.specs],
                                    np.int32)
        self.rate_specified = np.asarray(
            [s.rate_specified for s in self.specs], bool
        )
        self.enthalpy_specified = np.asarray(
            [s.enthalpy_specified for s in self.specs], bool
        )
        self.deliv_mask = np.asarray([s.deliv for s in self.specs], bool)
        self.recharge_mask = np.asarray([s.recharge for s in self.specs],
                                        bool)
        self.has_deliv = bool(self.deliv_mask.any())
        self.has_recharge = bool(self.recharge_mask.any())
        self.has_separators = any(s.separator.on for s in self.specs)
        self.has_limiters = any(s.limiter is not None for s in self.specs)
        # values filled by finalize()
        self._pi_from_rate = np.zeros(ns)
        self._pref_initial = np.full(ns, DEFAULT_REFERENCE_PRESSURE)

        self._parse_network(network_cfg or {})
        self.has_network = bool(self.groups or self.reinjectors)
        self._build_stacks()

    def _build_stacks(self):
        """Precompute batched table stacks so `flows` is fully
        vectorised over sources: no Python .at[i] loops in the traced
        path (pathological jaxpr growth at production well counts)."""
        from waiwera_tpu.utils.interpolation import build_sparse_updates

        specs = self.specs
        ns = self.num_sources
        self._base_rate = np.asarray([s.base_rate for s in specs])
        self._base_enthalpy = np.asarray([s.base_enthalpy for s in specs])
        self._upd_rate = build_sparse_updates(
            [(i, s.rate_table) for i, s in enumerate(specs)]
        )
        self._upd_enthalpy = build_sparse_updates(
            [(i, s.enthalpy_table) for i, s in enumerate(specs)]
        )
        self._upd_rate_factor = build_sparse_updates(
            [(i, s.rate_factor_table) for i, s in enumerate(specs)]
        )
        self._deliv_pi_base = np.asarray(
            [
                self._pi_from_rate[i] if s.deliv_pi_from_rate else s.deliv_pi
                for i, s in enumerate(specs)
            ]
        )
        self._upd_deliv_pi = build_sparse_updates(
            [(i, s.deliv_pi_table) for i, s in enumerate(specs)]
        )
        self._recharge_coeff_base = np.asarray(
            [s.recharge_coeff for s in specs]
        )
        self._upd_recharge_coeff = build_sparse_updates(
            [(i, s.recharge_coeff_table) for i, s in enumerate(specs)]
        )
        # reference pressures per prefix: constant base (PREF_INITIAL
        # substituted at trace time from finalize()), then batched
        # table updates split by abscissa kind
        self._pref_updates = {}
        for prefix in ("deliv", "recharge"):
            by_mode = {PREF_TIME: [], PREF_ENTHALPY: [], PREF_PRESSURE: []}
            for i, s in enumerate(specs):
                tab = getattr(s, f"{prefix}_pref_table")
                mode = getattr(s, f"{prefix}_pref_mode")
                if tab is not None and mode in by_mode:
                    by_mode[mode].append((i, tab))
            self._pref_updates[prefix] = {
                m: build_sparse_updates(lst) for m, lst in by_mode.items()
            }
        # separators: stages stacked to [ns, max_stages]
        max_st = max((len(s.separator.pressures) for s in specs), default=0)
        max_st = max(max_st, 1)
        sep_hw = np.zeros((ns, max_st))
        sep_hs = np.ones((ns, max_st))
        sep_stage = np.zeros((ns, max_st), bool)
        for i, s in enumerate(specs):
            st = len(s.separator.pressures)
            if s.separator.on and st:
                sep_hw[i, :st] = s.separator.ref_water_h
                sep_hs[i, :st] = s.separator.ref_steam_h
                sep_stage[i, :st] = True
        self._sep_hw = jnp.asarray(sep_hw)
        self._sep_hs = jnp.asarray(sep_hs)
        self._sep_stage = jnp.asarray(sep_stage)
        self._sep_on = jnp.asarray(
            np.asarray([s.separator.on for s in specs], bool)
        )
        # per-source limiters: [ns, 3] constants (inf = unlimited) +
        # batched table updates into the flattened [ns*3] array
        lim_const = np.full((ns, 3), np.inf)
        lim_tabs = []
        for i, s in enumerate(specs):
            if s.limiter is None:
                continue
            for ft, entry in (
                (FLOW_TOTAL, s.limiter.total),
                (FLOW_WATER, s.limiter.water),
                (FLOW_STEAM, s.limiter.steam),
            ):
                if entry is None:
                    continue
                const, tab = entry
                if tab is None:
                    lim_const[i, ft] = const
                else:
                    lim_const[i, ft] = 0.0
                    lim_tabs.append((i * 3 + ft, tab))
        self._lim_const = lim_const
        self._upd_limits = build_sparse_updates(lim_tabs)
        self._lim_any = np.isfinite(lim_const).any(axis=1)
        # tracer injection rates: [ns, nt] constants + flat updates
        nt = len(self.tracer_names)
        tr_const = np.zeros((ns, max(nt, 1)))
        tr_tabs = []
        for i, s in enumerate(specs):
            for k, (c, tab) in enumerate(s.tracer_rates):
                tr_const[i, k] = c
                if tab is not None:
                    tr_tabs.append((i * max(nt, 1) + k, tab))
        self._tracer_const = tr_const
        self._upd_tracer = build_sparse_updates(tr_tabs)

    # -- parsing ------------------------------------------------------

    def _parse_source(self, s: _SourceSpec, spec: dict, ispec: dict):
        eos = self.eos
        npv = eos.num_primary_variables
        comp = int(spec.get("component", 0))
        s.inj_component = comp if comp > 0 else 1
        s.prod_component = comp
        if "direction" in spec:
            s.direction = _direction_from_str(spec["direction"])

        if "rate" in spec and spec["rate"] is not None:
            s.rate_specified = True
            r = spec["rate"]
            if isinstance(r, (list, np.ndarray)):
                s.rate_table = table_from_json(r, ispec)
            else:
                s.base_rate = float(r)
        if "enthalpy" in spec and spec["enthalpy"] is not None:
            s.enthalpy_specified = True
            h = spec["enthalpy"]
            if isinstance(h, (list, np.ndarray)):
                s.enthalpy_table = table_from_json(h, ispec)
            else:
                s.base_enthalpy = float(h)
        if "rate_factor" in spec and spec["rate_factor"] is not None:
            s.rate_factor_table = table_from_json(spec["rate_factor"], ispec)

        deliv = spec.get("deliverability")
        if deliv is not None:
            s.deliv = True
            s.rate_specified = True
            if not isinstance(deliv, dict):
                deliv = {}
            s.deliv_threshold = float(deliv.get("threshold", -1.0))
            self._parse_pref(s, deliv, "deliv", ispec)
            prod = deliv.get("productivity")
            if prod is None:
                s.deliv_pi_from_rate = s.rate_specified
                s.deliv_pi = DEFAULT_PRODUCTIVITY
            elif isinstance(prod, dict):
                s.deliv_pi_table = table_from_json(
                    prod.get("time", prod), ispec
                )
            else:
                s.deliv_pi = float(prod)

        rech = spec.get("recharge", spec.get("injectivity"))
        if rech is not None:
            s.recharge = True
            s.rate_specified = True
            if not isinstance(rech, dict):
                rech = {}
            self._parse_pref(s, rech, "recharge", ispec)
            coeff = rech.get("coefficient")
            if coeff is None:
                s.recharge_coeff = DEFAULT_RECHARGE_COEFFICIENT
            elif isinstance(coeff, (list, np.ndarray)):
                s.recharge_coeff_table = table_from_json(coeff, ispec)
            else:
                s.recharge_coeff = float(coeff)

        sep_p = None
        sep_cfg = spec.get("separator")
        if sep_cfg is not None:
            if isinstance(sep_cfg, bool):
                sep_p = [DEFAULT_SEPARATOR_PRESSURE] if sep_cfg else None
            elif isinstance(sep_cfg, dict):
                sep_p = sep_cfg.get("pressure", DEFAULT_SEPARATOR_PRESSURE)
        lim_cfg = spec.get("limiter")
        if sep_p is None and lim_cfg:
            sep_p = _Limiter.separator_pressure(lim_cfg)
        s.separator = _Separator.build(sep_p, self.thermo)
        s.limiter = _Limiter.parse(lim_cfg, ispec)

        # tracer injection rates (source_setup get_tracer_injection_rate):
        # scalar (all tracers), list per tracer, or {name: rate}; each
        # entry may be a time table
        nt = len(self.tracer_names)
        s.tracer_rates = [(0.0, None)] * nt
        tcfg = spec.get("tracer")
        if tcfg is not None and nt:
            def entry(v):
                if isinstance(v, (list, np.ndarray)) and np.ndim(v) == 2:
                    return (0.0, table_from_json(v, ispec))
                return (float(v), None)

            if isinstance(tcfg, dict):
                for name, v in tcfg.items():
                    if str(name).lower() in self.tracer_names:
                        k = self.tracer_names.index(str(name).lower())
                        s.tracer_rates[k] = entry(v)
            elif isinstance(tcfg, (list, np.ndarray)) and np.ndim(tcfg) == 1:
                for k, v in enumerate(tcfg):
                    if k < nt:
                        s.tracer_rates[k] = entry(v)
            else:
                s.tracer_rates = [entry(tcfg)] * nt

    def _parse_pref(self, s: _SourceSpec, cfg: dict, prefix: str,
                    ispec: dict):
        """Reference pressure: scalar, 'initial', or table vs
        time/enthalpy/pressure (source_setup.F90:2667-2740)."""
        p = cfg.get("pressure")
        mode, const, table = PREF_TIME, DEFAULT_REFERENCE_PRESSURE, None
        if p is None:
            pass
        elif isinstance(p, str):
            mode = PREF_INITIAL
        elif isinstance(p, dict):
            if "enthalpy" in p:
                mode = PREF_ENTHALPY
                table = table_from_json(p["enthalpy"], ispec)
            elif "pressure" in p:
                mode = PREF_PRESSURE
                table = table_from_json(p["pressure"], ispec)
            else:
                table = table_from_json(p.get("time"), ispec)
        elif isinstance(p, (list, np.ndarray)):
            table = table_from_json(p, ispec)
        else:
            const = float(p)
        setattr(s, f"{prefix}_pref_mode", mode)
        setattr(s, f"{prefix}_pref", const)
        setattr(s, f"{prefix}_pref_table", table)

    def _parse_network(self, cfg: dict):
        self.groups: List[_Group] = []
        self.reinjectors: List[_Reinjector] = []
        ispec = {"interpolation": "linear", "averaging": "integrate"}

        raw_groups = cfg.get("group", []) or []
        if isinstance(raw_groups, dict):
            raw_groups = [raw_groups]
        group_specs = {}
        for g in raw_groups:
            sep_p = None
            sep_cfg = g.get("separator")
            if sep_cfg is not None:
                if isinstance(sep_cfg, bool):
                    sep_p = [DEFAULT_SEPARATOR_PRESSURE] if sep_cfg else None
                elif isinstance(sep_cfg, dict):
                    sep_p = sep_cfg.get("pressure",
                                        DEFAULT_SEPARATOR_PRESSURE)
            lim_cfg = g.get("limiter")
            if sep_p is None and lim_cfg:
                sep_p = _Limiter.separator_pressure(lim_cfg)
            grp = _Group(
                name=g.get("name", f"group {len(group_specs)}"),
                members=[str(m) for m in np.atleast_1d(g.get("in", []))],
                separator=_Separator.build(sep_p, self.thermo),
                limiter=_Limiter.parse(lim_cfg, ispec),
                scaling=str(g.get("scaling", "uniform")).lower(),
            )
            group_specs[grp.name] = grp

        # topological order (members before the group; dag.F90 analogue)
        placed = set()
        order: List[_Group] = []
        pending = list(group_specs.values())
        while pending:
            progressed = False
            rest = []
            for g in pending:
                deps = [m for m in g.members if m in group_specs]
                if all(d in placed for d in deps):
                    order.append(g)
                    placed.add(g.name)
                    progressed = True
                else:
                    rest.append(g)
            if not progressed:
                raise ValueError("cyclic source network group structure")
            pending = rest
        self.groups = order

        # descendant source indices per group (for scaling)
        name_to_idx: Dict[str, List[int]] = {}
        for i, nm in enumerate(self.names):
            name_to_idx.setdefault(nm, []).append(i)
        group_desc: Dict[str, List[int]] = {}
        for g in self.groups:
            desc: List[int] = []
            per_member: List[List[int]] = []
            for m in g.members:
                if m in group_desc:
                    mm = list(group_desc[m])
                elif m in name_to_idx:
                    mm = list(name_to_idx[m])
                else:
                    raise ValueError(f"unknown network node {m!r}")
                per_member.append(mm)
                desc.extend(mm)
            g.descendant_sources = desc
            g.member_descendants = per_member
            group_desc[g.name] = desc

        raw_re = cfg.get("reinject", []) or []
        if isinstance(raw_re, dict):
            raw_re = [raw_re]
        rein_specs: Dict[str, _Reinjector] = {}
        for r in raw_re:
            outputs = []
            for key, ftype in (("water", FLOW_WATER), ("steam", FLOW_STEAM)):
                for o in r.get(key, []) or []:
                    out = _ReinjectorOutput(
                        target=str(o["out"]), flow_type=ftype,
                        kind="remaining",
                    )
                    if "rate" in o:
                        v = o["rate"]
                        out.kind = "rate"
                        if isinstance(v, (list, np.ndarray)):
                            out.table = table_from_json(v, ispec)
                        else:
                            out.value = float(v)
                    elif "proportion" in o:
                        v = o["proportion"]
                        out.kind = "proportion"
                        if isinstance(v, (list, np.ndarray)):
                            out.table = table_from_json(v, ispec)
                        else:
                            out.value = float(v)
                    if "enthalpy" in o:
                        out.enthalpy = float(o["enthalpy"])
                    outputs.append(out)
            rj = _Reinjector(
                name=r.get("name", f"reinjector {len(rein_specs)}"),
                input=r.get("in"),
                outputs=outputs,
                overflow=r.get("overflow"),
            )
            rein_specs[rj.name] = rj

        # order reinjectors so upstream (overflow feeders) come first
        placed = set()
        order_r: List[_Reinjector] = []
        pending_r = list(rein_specs.values())
        # dependency: rj depends on any reinjector whose overflow == rj
        # or whose outputs target rj
        feeders: Dict[str, List[str]] = {r.name: [] for r in pending_r}
        for r in pending_r:
            if r.overflow and r.overflow in rein_specs:
                feeders[r.overflow].append(r.name)
            for o in r.outputs:
                if o.target in rein_specs:
                    feeders[o.target].append(r.name)
        while pending_r:
            progressed = False
            rest = []
            for r in pending_r:
                if all(f in placed for f in feeders[r.name]):
                    order_r.append(r)
                    placed.add(r.name)
                    progressed = True
                else:
                    rest.append(r)
            if not progressed:
                raise ValueError("cyclic reinjector structure")
            pending_r = rest
        self.reinjectors = order_r
        self._name_to_idx = name_to_idx

    # -- initial-state-dependent setup --------------------------------

    def finalize(self, fluid0):
        """Computes PI-from-rate and 'initial' reference pressures from
        the initial fluid state (source_setup.F90:2893-2917,
        source_control.F90:408-470)."""
        cells = np.asarray(self.arrays.cell)
        P0 = np.asarray(fluid0.pressure)[cells]
        mob = np.asarray(fluid0.mobility())[cells].sum(axis=1)
        pf = np.asarray(fluid0.permeability_factor)[cells]
        self._pref_initial = P0.copy()
        for i, s in enumerate(self.specs):
            if s.deliv and s.deliv_pi_from_rate:
                pref = (
                    P0[i]
                    if s.deliv_pref_mode == PREF_INITIAL
                    else (
                        float(s.deliv_pref_table(0.0)[0])
                        if s.deliv_pref_table is not None
                        and s.deliv_pref_mode == PREF_TIME
                        else s.deliv_pref
                    )
                )
                factor = mob[i] * (P0[i] - pref) * pf[i]
                rate = s.base_rate
                if s.rate_table is not None:
                    rate = float(s.rate_table(0.0)[0])
                if abs(factor) > 1e-9:
                    self._pi_from_rate[i] = abs(rate) / factor
                else:
                    self._pi_from_rate[i] = DEFAULT_PRODUCTIVITY
        self._deliv_pi_base = np.asarray(
            [
                self._pi_from_rate[i] if s.deliv_pi_from_rate else s.deliv_pi
                for i, s in enumerate(self.specs)
            ]
        )

    # -- the pure update ----------------------------------------------

    def flows(self, fluid, t0, t1, collect=None):
        """Returns (rate [ns], enthalpy [ns]): signed source rates and
        effective (injection or flowing) enthalpies. Pass a dict as
        `collect` to capture intermediate node flows (separated
        water/steam, groups, reinjectors) for output."""
        from waiwera_tpu.sim.sources import gather_cell_state

        return self.flows_from_state(
            gather_cell_state(fluid, self.arrays.cell), t0, t1,
            collect=collect,
        )

    def flows_from_state(self, state, t0, t1, collect=None):
        """The network update on a gathered per-source cell state
        (SourceCellState). Fully vectorised over sources: per-source
        controls are batched table stacks
        (utils.interpolation.StackedTables); no Python loop is traced
        except the tiny group/reinjector DAG."""
        ns = self.num_sources
        q = jnp.asarray(self._base_rate)
        h_inj = jnp.asarray(self._base_enthalpy)
        for upd in self._upd_rate:
            q = upd.average_into(q, t0, t1)
        for upd in self._upd_enthalpy:
            h_inj = upd.average_into(h_inj, t0, t1)

        P = state.pressure
        pf = state.permeability_factor
        if self.isothermal:
            h_flow = jnp.zeros(ns)
        else:
            frac = state.phase_flow_fractions
            h_flow = jnp.sum(frac * state.specific_enthalpy, axis=-1)

        if self.has_deliv:
            mob_tot = jnp.sum(state.mobility, axis=-1)
            pi = jnp.asarray(self._deliv_pi_base)
            for upd in self._upd_deliv_pi:
                pi = upd.average_into(pi, t0, t1)
            pref = self._reference_pressure("deliv", t0, t1, h_flow, P)
            qd = -pi * pf * mob_tot * (P - pref)
            q = jnp.where(jnp.asarray(self.deliv_mask), qd, q)

        if self.has_recharge:
            coeff = jnp.asarray(self._recharge_coeff_base)
            for upd in self._upd_recharge_coeff:
                coeff = upd.average_into(coeff, t0, t1)
            pref_r = self._reference_pressure("recharge", t0, t1, h_flow, P)
            qr = -coeff * (P - pref_r)
            q = jnp.where(jnp.asarray(self.recharge_mask), qr, q)

        if self._upd_rate_factor:
            factor = jnp.ones(ns)
            for upd in self._upd_rate_factor:
                factor = upd.average_into(factor, t0, t1)
            q = q * factor

        # direction control (source_control.F90:597-619)
        direction = jnp.asarray(self.direction)
        q = jnp.where((direction == DIR_PRODUCTION) & (q > 0.0), 0.0, q)
        q = jnp.where((direction == DIR_INJECTION) & (q < 0.0), 0.0, q)

        h_eff = jnp.where(q >= 0.0, h_inj, h_flow)

        if not (self.has_separators or self.has_limiters
                or self.has_network):
            if collect is not None:
                z = jnp.zeros(ns)
                collect["separated"] = (z, z, z, z)
            return q, h_eff

        # separated flows per source
        qw, hw, qs, hs = self._separated(q, h_eff)

        # per-source limiters, vectorised (source_network_node.F90:
        # 247-300): limit = inf where unlimited
        if self.has_limiters:
            limits = jnp.asarray(self._lim_const).reshape(-1)
            for upd in self._upd_limits:
                limits = upd.average_into(limits, t0, t1)
            limits = limits.reshape(ns, 3)
            rates = jnp.stack([q, qw, qs], axis=1)  # [ns, 3]
            r = jnp.abs(rates)
            s = jnp.where(
                (r > limits) & jnp.isfinite(limits),
                jnp.where(
                    r > LIMIT_SMALL,
                    limits / jnp.maximum(r, LIMIT_SMALL),
                    1.0,
                ),
                1.0,
            )
            scale = jnp.min(s, axis=1)
            scale = jnp.where(jnp.asarray(self._lim_any), scale, 1.0)
            q = q * scale
            qw = qw * scale
            qs = qs * scale

        if self.has_network:
            q, h_eff, qw, hw, qs, hs = self._network_update(
                q, h_eff, qw, hw, qs, hs, t0, t1, collect=collect
            )

        self._last_separated = (qw, hw, qs, hs)
        if collect is not None:
            collect["separated"] = (qw, hw, qs, hs)
        return q, h_eff

    def tracer_injection(self, t0, t1):
        """[ns, nt] tracer injection rates over the interval."""
        nt = len(self.tracer_names)
        out = jnp.asarray(self._tracer_const).reshape(-1)
        for upd in self._upd_tracer:
            out = upd.average_into(out, t0, t1)
        return out.reshape(self.num_sources, -1)[:, :nt]

    def _reference_pressure(self, prefix, t0, t1, h_flow, P):
        pref = jnp.asarray(
            np.where(
                np.asarray(
                    [
                        getattr(s, f"{prefix}_pref_mode") == PREF_INITIAL
                        for s in self.specs
                    ],
                    bool,
                ),
                self._pref_initial,
                np.asarray(
                    [getattr(s, f"{prefix}_pref") for s in self.specs]
                ),
            )
        )
        upd = self._pref_updates[prefix]
        for u in upd[PREF_TIME]:
            pref = u.average_into(pref, t0, t1)
        for u in upd[PREF_ENTHALPY]:
            pref = u.eval_into(pref, h_flow)
        for u in upd[PREF_PRESSURE]:
            pref = u.eval_into(pref, P)
        return pref

    def _separated(self, q, h):
        """Per-source separated water/steam flows, vectorised over
        sources and stacked stages; zero when not producing or no
        separator (source_network_node.F90:116-158,
        separator.F90:141-166, multi-stage :215-260)."""
        ns = self.num_sources
        z = jnp.zeros(ns)
        if not self.has_separators:
            return z, z, z, z
        q_in, h_in = q, h
        steam_mass = z
        steam_energy = z
        qr, hr = q, h
        for st in range(self._sep_hw.shape[1]):
            active = self._sep_stage[:, st]
            hw_ref = self._sep_hw[:, st]
            hs_ref = self._sep_hs[:, st]
            sf = jnp.where(
                hr <= hw_ref,
                0.0,
                jnp.where(
                    hr <= hs_ref,
                    (hr - hw_ref)
                    / jnp.where(hs_ref > hw_ref, hs_ref - hw_ref, 1.0),
                    1.0,
                ),
            )
            hs_st = jnp.where(
                hr <= hw_ref, 0.0, jnp.where(hr <= hs_ref, hs_ref, hr)
            )
            hw_st = jnp.where(
                hr <= hw_ref, hr, jnp.where(hr <= hs_ref, hw_ref, 0.0)
            )
            sf = jnp.where(active, sf, 0.0)
            qs_st = sf * qr
            steam_mass = steam_mass + qs_st
            steam_energy = steam_energy + qs_st * hs_st
            qr = (1.0 - sf) * qr
            hr = jnp.where(active, hw_st, hr)
        hs_out = jnp.where(
            jnp.abs(steam_mass) > RATE_TOL,
            steam_energy
            / jnp.where(jnp.abs(steam_mass) > RATE_TOL, steam_mass, 1.0),
            0.0,
        )
        keep = self._sep_on & (q_in < 0.0)
        qw = jnp.where(keep, qr, 0.0)
        hw = jnp.where(keep, hr, 0.0)
        qs = jnp.where(keep, steam_mass, 0.0)
        hs = jnp.where(keep, hs_out, 0.0)
        return qw, hw, qs, hs

    # -- groups + reinjectors (lagged in the Jacobian) ----------------

    def _network_update(self, q, h, qw, hw, qs, hs, t0, t1,
                        collect=None):
        sg = jax.lax.stop_gradient
        nodes: Dict[str, NodeFlows] = {}

        def group_sums(g: _Group):
            ii = jnp.asarray(g.descendant_sources, jnp.int32)
            tq = jnp.sum(q[ii])
            tqh = jnp.sum(q[ii] * h[ii])
            gh = jnp.where(jnp.abs(tq) > RATE_TOL, tqh
                           / jnp.where(jnp.abs(tq) > RATE_TOL, tq, 1.0), 0.0)
            if g.separator.on:
                gqw, ghw, gqs, ghs = g.separator.separate(tq, gh)
                producing = tq < 0.0
                return NodeFlows(
                    tq, gh,
                    jnp.where(producing, gqw, 0.0),
                    jnp.where(producing, ghw, 0.0),
                    jnp.where(producing, gqs, 0.0),
                    jnp.where(producing, ghs, 0.0),
                )
            # no group separator: sum input nodes' separated flows
            # (source_network_group.F90:309-371)
            gqw = jnp.sum(qw[ii])
            gqs = jnp.sum(qs[ii])
            wqh = jnp.sum(qw[ii] * hw[ii])
            sqh = jnp.sum(qs[ii] * hs[ii])
            ghw = jnp.where(jnp.abs(gqw) > RATE_TOL, wqh
                            / jnp.where(jnp.abs(gqw) > RATE_TOL, gqw,
                                        1.0), 0.0)
            ghs = jnp.where(jnp.abs(gqs) > RATE_TOL, sqh
                            / jnp.where(jnp.abs(gqs) > RATE_TOL, gqs,
                                        1.0), 0.0)
            return NodeFlows(tq, gh, gqw, ghw, gqs, ghs)

        # groups in topological order with limit scaling
        for g in self.groups:
            nf = group_sums(g)
            if g.limiter is not None:
                limits = g.limiter.limits_at(t0, t1)
                if limits:
                    if g.scaling == "progressive":
                        scale_members = self._progressive_scales(
                            g, q, qw, qs, limits
                        )
                    else:
                        s_g = _limit_scale(
                            {FLOW_TOTAL: nf.q, FLOW_WATER: nf.qw,
                             FLOW_STEAM: nf.qs},
                            limits,
                        )
                        scale_members = [
                            s_g for _ in g.member_descendants
                        ]
                    # apply member scales to descendant sources
                    full = jnp.ones(self.num_sources)
                    for mm, sc in zip(g.member_descendants, scale_members):
                        ii = jnp.asarray(mm, jnp.int32)
                        full = full.at[ii].set(sg(sc))
                    q = q * full
                    qw = qw * full
                    qs = qs * full
                    nf = group_sums(g)
            nodes[g.name] = nf

        # reinjectors (source_network_reinjector.F90:1014-1290)
        if self.reinjectors:
            capacity_w: Dict[str, Array] = {}
            capacity_s: Dict[str, Array] = {}
            rein_in: Dict[str, Tuple] = {}
            rate_specified = jnp.asarray(self.rate_specified)
            # capacities: downstream-last ordering works because
            # chained targets appear later in self.reinjectors
            for r in reversed(self.reinjectors):
                cw = jnp.asarray(0.0)
                cs = jnp.asarray(0.0)
                cw_unrated = False
                cs_unrated = False
                for o in r.outputs:
                    if o.target in self._name_to_idx:
                        i = self._name_to_idx[o.target][0]
                        if self.specs[i].rate_specified:
                            tgt_cap = jnp.abs(q[i])
                        else:
                            tgt_cap = None
                    elif o.target in capacity_w:
                        tgt_cap = (
                            capacity_w[o.target]
                            if o.flow_type == FLOW_WATER
                            else capacity_s[o.target]
                        )
                    else:
                        tgt_cap = None
                    if o.flow_type == FLOW_WATER:
                        if tgt_cap is None:
                            cw_unrated = True
                        else:
                            cw = cw + tgt_cap
                    else:
                        if tgt_cap is None:
                            cs_unrated = True
                        else:
                            cs = cs + tgt_cap
                capacity_w[r.name] = jnp.asarray(-1.0) if cw_unrated else cw
                capacity_s[r.name] = jnp.asarray(-1.0) if cs_unrated else cs

            for r in self.reinjectors:
                if r.input is not None:
                    if r.input in nodes:
                        src = nodes[r.input]
                        in_qw = jnp.abs(src.qw)
                        in_hw = src.hw
                        in_qs = jnp.abs(src.qs)
                        in_hs = src.hs
                    else:
                        ii = jnp.asarray(
                            self._name_to_idx[r.input], jnp.int32
                        )
                        in_qw = jnp.abs(jnp.sum(qw[ii]))
                        in_hw = hw[ii][0]
                        in_qs = jnp.abs(jnp.sum(qs[ii]))
                        in_hs = hs[ii][0]
                elif r.name in rein_in:
                    in_qw, in_hw, in_qs, in_hs = rein_in[r.name]
                else:
                    z = jnp.asarray(0.0)
                    in_qw, in_hw, in_qs, in_hs = z, z, z, z

                balance = {FLOW_WATER: in_qw, FLOW_STEAM: in_qs}
                in_h = {FLOW_WATER: in_hw, FLOW_STEAM: in_hs}
                in_rate = {FLOW_WATER: in_qw, FLOW_STEAM: in_qs}
                out_tot = {FLOW_WATER: jnp.asarray(0.0),
                           FLOW_STEAM: jnp.asarray(0.0)}
                for o in r.outputs:
                    if o.kind == "rate":
                        req = (
                            o.table.average(t0, t1)[0]
                            if o.table is not None
                            else jnp.asarray(o.value)
                        )
                    elif o.kind == "proportion":
                        prop = (
                            o.table.average(t0, t1)[0]
                            if o.table is not None
                            else jnp.asarray(o.value)
                        )
                        req = prop * in_rate[o.flow_type]
                    else:
                        req = jnp.asarray(-1.0)
                    # node limit (source_network_reinjector.F90:199-215,
                    # 433-457): a rated target caps the request; an
                    # unrated request takes the target's capacity
                    cap = None
                    if o.target in self._name_to_idx:
                        i = self._name_to_idx[o.target][0]
                        if self.specs[i].rate_specified:
                            cap = jnp.abs(q[i])
                    elif o.target in capacity_w:
                        c = (
                            capacity_w[o.target]
                            if o.flow_type == FLOW_WATER
                            else capacity_s[o.target]
                        )
                        cap = jnp.where(c >= 0.0, c, jnp.inf)
                    if cap is not None:
                        req = jnp.where(
                            cap < jnp.inf,
                            jnp.where(req < 0.0, cap,
                                      jnp.minimum(req, cap)),
                            req,
                        )
                    bal = balance[o.flow_type]
                    rate_out = jnp.where(req < 0.0, bal,
                                         jnp.minimum(req, bal))
                    balance[o.flow_type] = jnp.maximum(bal - rate_out, 0.0)
                    out_tot[o.flow_type] = out_tot[o.flow_type] + rate_out
                    h_out = (
                        jnp.asarray(o.enthalpy)
                        if o.enthalpy > 0.0
                        else in_h[o.flow_type]
                    )
                    if o.target in self._name_to_idx:
                        for i in self._name_to_idx[o.target]:
                            q = q.at[i].set(sg(rate_out))
                            if not self.specs[i].enthalpy_specified:
                                h = h.at[i].set(sg(h_out))
                    else:
                        prev = rein_in.get(
                            o.target,
                            (jnp.asarray(0.0),) * 4,
                        )
                        if o.flow_type == FLOW_WATER:
                            rein_in[o.target] = (
                                prev[0] + rate_out, h_out, prev[2], prev[3]
                            )
                        else:
                            rein_in[o.target] = (
                                prev[0], prev[1], prev[2] + rate_out, h_out
                            )
                if r.overflow is not None:
                    prev = rein_in.get(r.overflow, (jnp.asarray(0.0),) * 4)
                    rein_in[r.overflow] = (
                        prev[0] + balance[FLOW_WATER], in_hw,
                        prev[2] + balance[FLOW_STEAM], in_hs,
                    )
                if collect is not None:
                    # reference reinjector output fields
                    # (setup_output.rst, source_network_reinjector.F90)
                    collect.setdefault("reinject", {})[r.name] = {
                        "water_rate": in_qw,
                        "water_enthalpy": in_hw,
                        "steam_rate": in_qs,
                        "steam_enthalpy": in_hs,
                        "output_water_rate": out_tot[FLOW_WATER],
                        "output_steam_rate": out_tot[FLOW_STEAM],
                        "output_rate": out_tot[FLOW_WATER]
                        + out_tot[FLOW_STEAM],
                        "overflow_water_rate": balance[FLOW_WATER],
                        "overflow_steam_rate": balance[FLOW_STEAM],
                    }

        if collect is not None:
            collect["group"] = {name: nf for name, nf in nodes.items()}
        return q, h, qw, hw, qs, hs

    def _progressive_scales(self, g: _Group, q, qw, qs, limits):
        """Per-member scale factors limiting members progressively in
        order (source_network_group.F90:676-764,
        utils.F90:607-647)."""
        rates = {FLOW_TOTAL: q, FLOW_WATER: qw, FLOW_STEAM: qs}
        member_scale = [jnp.asarray(1.0) for _ in g.member_descendants]
        for ft, limit in limits.items():
            a = jnp.stack(
                [
                    jnp.abs(jnp.sum(rates[ft][jnp.asarray(mm, jnp.int32)]))
                    for mm in g.member_descendants
                ]
            )
            total_over = jnp.sum(a) > limit
            prev = jnp.cumsum(a) - a
            node_limit = jnp.clip(limit - prev, 0.0, a)
            s = jnp.where(
                a > node_limit,
                jnp.where(a > LIMIT_SMALL, node_limit
                          / jnp.maximum(a, LIMIT_SMALL), 1.0),
                1.0,
            )
            s = jnp.where(total_over, s, 1.0)
            member_scale = [
                jnp.minimum(ms, s[k]) for k, ms in enumerate(member_scale)
            ]
        return member_scale
