"""Configuration schema: every option the framework understands.

Capability parity with the reference's config/config-format.json +
common/configuration_schema.py (same section/field names so reference .ini
files load unchanged), expressed Python-natively as Field descriptors
instead of a JSON document + code generation.
"""

import ast
import math
import operator
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence


class ConfigurationError(ValueError):
    pass


# --- Safe arithmetic evaluation of option values (reference common/eval_expr.py)

_BIN_OPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.Pow: operator.pow,
    ast.Mod: operator.mod,
    ast.FloorDiv: operator.floordiv,
}
_UNARY_OPS = {ast.USub: operator.neg, ast.UAdd: operator.pos}
_NAMES = {"pi": math.pi, "e": math.e, "inf": math.inf}


def eval_expr(text: str) -> float:
    """Evaluate a numeric arithmetic expression safely (+-*/%**, pi, e)."""

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return node.value
        if isinstance(node, ast.BinOp) and type(node.op) in _BIN_OPS:
            return _BIN_OPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARY_OPS:
            return _UNARY_OPS[type(node.op)](ev(node.operand))
        if isinstance(node, ast.Name) and node.id in _NAMES:
            return _NAMES[node.id]
        raise ConfigurationError(f"Unsupported expression element: {ast.dump(node)}")

    return ev(ast.parse(text.strip(), mode="eval"))


# --- Field types


def _parse_bool(text: str) -> bool:
    t = text.strip().lower()
    if t in ("1", "true", "yes", "on"):
        return True
    if t in ("0", "false", "no", "off"):
        return False
    raise ConfigurationError(f"Not a boolean: {text!r}")


def _parse_list(elem_parser: Callable) -> Callable:
    def parse(text: str):
        t = text.strip().strip("[]")
        if not t:
            return []
        return [elem_parser(x.strip()) for x in t.split(",")]

    return parse


PARSERS = {
    "int": lambda t: int(eval_expr(t)),
    "float": lambda t: float(eval_expr(t)),
    "angle": lambda t: float(eval_expr(t)),
    "bool": _parse_bool,
    "str": lambda t: t.strip().lower(),
    "case-str": lambda t: t.strip(),
    "list-int": _parse_list(lambda t: int(eval_expr(t))),
    "list-float": _parse_list(lambda t: float(eval_expr(t))),
}


_REQUIRED = object()


@dataclass(frozen=True)
class Field:
    section: str
    name: str
    type: str
    default: Any = _REQUIRED
    choices: Optional[Sequence] = None
    min: Optional[float] = None
    max: Optional[float] = None
    doc: str = ""
    required_if: Optional[Callable[[dict], bool]] = None  # else optional

    @property
    def required(self) -> bool:
        return self.default is _REQUIRED and self.required_if is None

    def parse(self, text: str):
        value = PARSERS[self.type](text)
        if self.choices is not None and value not in self.choices:
            raise ConfigurationError(f"[{self.section}] {self.name}={value!r} not in {list(self.choices)}")
        if self.min is not None and value < self.min:
            raise ConfigurationError(f"[{self.section}] {self.name}={value} below minimum {self.min}")
        if self.max is not None and value > self.max:
            raise ConfigurationError(f"[{self.section}] {self.name}={value} above maximum {self.max}")
        return value


def _f(*args, **kwargs) -> Field:
    return Field(*args, **kwargs)


EXP_SOLVERS = [
    "pmex", "kiops", "kiops_jit", "exode", "pmex_ne", "pmex_1s", "pmex_ne1s", "kiops_ne",
    "cwy_1s", "cwy_ne", "cwy_ne1s", "dcgs2", "icwy_1s", "icwy_ne", "icwy_ne1s", "icwy_neiop",
]
EXODE_METHODS = ["BS3(2)", "DP5(4)", "M4(3)", "KC3(2)", "EXLRK3(2)", "EXLRK4(3)", "F14(12)", "DP8(7)", "F10(8)"]

SCHEMA: List[Field] = [
    # General
    _f("General", "equations", "str", choices=["euler", "shallow_water"], doc="Equation system to solve"),
    _f("General", "depth_approx", "str", "shallow", choices=["deep", "shallow"],
       doc="3D atmosphere depth approximation"),
    # System
    _f("System", "desired_device", "str", "tpu", choices=["cpu", "tpu", "cuda"],
       doc="Compute device ('cuda' accepted for reference-config compatibility; maps to the JAX default)"),
    _f("System", "cuda_devices", "list-int", [], doc="Ignored (reference compatibility)"),
    _f("System", "distribute", "str", "auto", choices=["auto", "off", "gspmd", "shard_map"],
       doc="Multi-device execution (parallel/mesh.py). 'auto': when more than one device is "
           "visible, shard the element grid over a (panel, y, x) mesh — explicit cubed-sphere "
           "runs take the hand-scheduled shard_map tile step on 6*N^2-device meshes, everything "
           "else (exponential/implicit solvers included) runs GSPMD-partitioned by XLA. The "
           "analogue of the reference's mpirun -n 6N^2 launch, but any device count works. "
           "'off': single-device/replicated. 'gspmd'/'shard_map': force that path"),
    _f("System", "precision", "str", "float64", choices=["float32", "float64"],
       doc="State/compute dtype. float64 matches the reference bit-for-bit; float32 is the "
           "TPU-native operating point (enables the fused Pallas pipelines; the 3D Euler model "
           "adds a well-balanced offset around the initial state to absorb the f32 hydrostatic "
           "cancellation error)"),
    # Test case
    _f("Test_case", "case_number", "int", -1, doc="Test-case identifier (Williamson/DCMIP/bubble numbering)"),
    _f("Test_case", "matsuno_wave_type", "str", "rossby", choices=["rossby", "eig", "wig"]),
    _f("Test_case", "matsuno_amp", "float", 1e-5),
    _f("Test_case", "bubble_theta", "float", 303.15),
    _f("Test_case", "bubble_rad", "float", 250.0),
    # Time integration
    _f("Time_integration", "dt", "float", min=0.0, doc="Time step (s)"),
    _f("Time_integration", "t_end", "float", doc="End time (s)"),
    _f("Time_integration", "time_integrator", "str", doc="Stepping scheme (epi2/3/.., srerk3/6, tvdrk3, ros2, ...)"),
    _f("Time_integration", "tolerance", "float", 1e-7, doc="Iterative solver tolerance"),
    _f("Time_integration", "starting_step", "int", 0, doc="Resume from this step's saved state"),
    _f("Time_integration", "exponential_solver", "str", "pmex", choices=EXP_SOLVERS),
    _f("Time_integration", "exode_method", "case-str", "BS3(2)",
       choices=EXODE_METHODS + [m.lower() for m in EXODE_METHODS]),
    _f("Time_integration", "exode_controller", "case-str", ""),
    _f("Time_integration", "krylov_size", "int", 1, min=0),
    _f("Time_integration", "jacobian_method", "str", "jvp", choices=["jvp", "complex", "fd"],
       doc="Jacobian action: exact forward-mode AD (jvp, default) or finite differences; "
           "'complex' is accepted for reference compatibility and maps to jvp"),
    _f("Time_integration", "linear_solver", "str", "auto",
       choices=["auto", "fgmres", "fgmres_jit", "fgmres_jit_1s", "gcrot"]),
    _f("Time_integration", "device_step_chunk", "int", 1, min=1,
       doc="Run up to N equal timesteps per device dispatch (ONE XLA program "
           "per chunk: lax.scan over the whole step for Epi/kiops_jit, over "
           "the fused Pallas stage chain for explicit schemes). Outputs, "
           "checkpoints and stats land exactly on their configured steps; "
           "solver stats/NaN checks are per CHUNK in between. TPU-native "
           "extension (no reference equivalent): amortizes the per-step "
           "host dispatch latency"),
    _f("Time_integration", "mixed_precision_krylov", "bool", False,
       doc="Run the Epi/Ros2 Krylov hot loop (Arnoldi matvec + basis) in "
           "float32 via a perturbation-form companion RHS around the "
           "initial state, keeping controllers/residuals float64 "
           "(~4-10x per step on TPU; cubed-sphere models, device-resident "
           "solvers only)"),
    _f("Time_integration", "verbose_solver", "int", 0),
    _f("Time_integration", "gmres_restart", "int", 20, min=1),
    # Spatial discretization
    _f("Spatial_discretization", "num_solpts", "int", min=1),
    _f("Spatial_discretization", "num_elements_horizontal", "int", min=1),
    _f("Spatial_discretization", "num_elements_vertical", "int", 1, min=1),
    _f("Spatial_discretization", "filter_apply", "bool", False),
    _f("Spatial_discretization", "filter_order", "int", 16),
    _f("Spatial_discretization", "filter_cutoff", "float", 0.25),
    _f("Spatial_discretization", "expfilter_apply", "bool", False),
    _f("Spatial_discretization", "expfilter_order", "int", 0),
    _f("Spatial_discretization", "expfilter_cutoff", "float", 0.0),
    _f("Spatial_discretization", "expfilter_strength", "float", 0.0),
    _f("Spatial_discretization", "apply_sponge", "bool", False),
    _f("Spatial_discretization", "sponge_tscale", "float", 1.0),
    _f("Spatial_discretization", "sponge_zscale", "float", 0.0),
    # Grid
    _f("Grid", "grid_type", "str", choices=["cubed_sphere", "cartesian2d"]),
    _f("Grid", "discretization", "str", "dg", choices=["dg", "fv"]),
    _f("Grid", "lambda0", "angle", 0.0),
    _f("Grid", "phi0", "angle", 0.0),
    _f("Grid", "alpha0", "angle", 0.0),
    _f("Grid", "ztop", "float", 0.0),
    _f("Grid", "x0", "float", 0.0),
    _f("Grid", "x1", "float", 0.0),
    _f("Grid", "z0", "float", 0.0),
    _f("Grid", "z1", "float", 0.0),
    # Preconditioning
    _f("Preconditioning", "preconditioner", "str", "none", choices=["none", "fv", "fv-mg", "p-mg", "lu", "ilu"]),
    _f("Preconditioning", "precond_flux", "str", "ausm", choices=["ausm", "upwind", "rusanov"]),
    _f("Preconditioning", "num_mg_levels", "int", 1, min=1),
    _f("Preconditioning", "precond_tolerance", "float", 0.1),
    _f("Preconditioning", "num_pre_smoothe", "int", 1, min=0),
    _f("Preconditioning", "num_post_smoothe", "int", 1, min=0),
    _f("Preconditioning", "mg_smoother", "str", "exp", choices=["exp", "kiops", "erk3", "erk1", "ark3"]),
    _f("Preconditioning", "exp_smoothe_spectral_radii", "list-float", [2.0]),
    _f("Preconditioning", "exp_smoothe_num_iters", "list-int", [4]),
    _f("Preconditioning", "mg_solve_coarsest", "bool", False),
    _f("Preconditioning", "kiops_dt_factor", "float", 1.1),
    _f("Preconditioning", "verbose_precond", "int", 0),
    _f("Preconditioning", "dg_to_fv_interp", "str", "lagrange", choices=["l2-norm", "lagrange"]),
    _f("Preconditioning", "pseudo_cfl", "float", 1.0),
    _f("Preconditioning", "precond_filter_apply", "bool", False),
    # Output
    _f("Output_options", "stat_freq", "int", 0, doc="Blockstats every N steps (0=off)"),
    _f("Output_options", "output_freq", "int", 0, doc="Field output every N steps (0=off)"),
    _f("Output_options", "save_state_freq", "int", 0, doc="Checkpoint every N steps (0=off)"),
    _f("Output_options", "store_solver_stats", "bool", False),
    _f("Output_options", "rhs_timing_freq", "int", 0,
       doc="Sample per-stage RHS timings into the solver-stats rhs_timing "
           "table every N steps (0=off; needs store_solver_stats)"),
    _f("Output_options", "output_dir", "case-str", "results"),
    _f("Output_options", "base_output_file", "case-str", "out"),
    _f("Output_options", "solver_stats_file", "case-str", "solver_stats.db"),
    _f("Output_options", "store_total_time", "bool", False),
    _f("Output_options", "output_format", "str", "netcdf", choices=["netcdf", "none"]),
]


def schema_documentation(fmt: str = "text") -> str:
    """Render the option reference (the reference's --config-options dump)."""
    lines = []
    section = None
    for f in SCHEMA:
        if f.section != section:
            section = f.section
            lines.append(f"\n[{section}]" if fmt == "text" else f"\n## {section}\n")
        desc = f" — {f.doc}" if f.doc else ""
        default = "" if f.default is _REQUIRED else f" (default: {f.default!r})"
        extra = f" choices={list(f.choices)}" if f.choices else ""
        if fmt == "text":
            lines.append(f"  {f.name}: {f.type}{default}{extra}{desc}")
        else:
            lines.append(f"- `{f.name}` ({f.type}){default}{extra}{desc}")
    return "\n".join(lines)
