"""Typed configuration object parsed from INI files.

Capability parity with the reference's common/configuration.py
(Configuration): reads the same INI files, validates against the schema,
exposes every option as a typed attribute, and keeps the raw file content
for embedding into checkpoints (output/state.py there).
"""

import configparser
from typing import Dict, Optional

from .schema import SCHEMA, ConfigurationError, Field


class Configuration:
    # Typed attributes (generated from the schema at runtime; listed here
    # for discoverability / IDEs)
    equations: str
    depth_approx: str
    desired_device: str
    precision: str
    case_number: int
    dt: float
    t_end: float
    time_integrator: str
    tolerance: float
    starting_step: int
    exponential_solver: str
    krylov_size: int
    jacobian_method: str
    linear_solver: str
    verbose_solver: int
    gmres_restart: int
    num_solpts: int
    num_elements_horizontal: int
    num_elements_vertical: int
    grid_type: str
    lambda0: float
    phi0: float
    alpha0: float
    ztop: float
    preconditioner: str
    stat_freq: int
    output_freq: int
    save_state_freq: int
    store_solver_stats: bool
    rhs_timing_freq: int
    output_dir: str

    def __init__(self, ini_text: str, strict: bool = False):
        """strict=True additionally rejects options absent from the schema
        (the reference ignores unknown keys; so do we by default)."""
        self.raw_text = ini_text
        parser = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
        parser.read_string(ini_text)

        # Case-insensitive section lookup (reference configs use exact names,
        # but be forgiving).
        sections: Dict[str, Dict[str, str]] = {}
        for sec in parser.sections():
            sections[sec.lower()] = {k.lower(): v for k, v in parser.items(sec)}

        seen = set()
        for f in SCHEMA:
            sec = sections.get(f.section.lower(), {})
            key = f.name.lower()
            if key in sec:
                value = f.parse(sec[key])
                seen.add((f.section.lower(), key))
            elif f.required:
                raise ConfigurationError(f"Missing required option [{f.section}] {f.name}")
            else:
                value = f.default if not isinstance(f.default, list) else list(f.default)
            setattr(self, f.name, value)

        if strict:
            known = {(f.section.lower(), f.name.lower()) for f in SCHEMA}
            for sec_name, options in sections.items():
                for key in options:
                    if (sec_name, key) not in known:
                        raise ConfigurationError(f"Unknown option [{sec_name}] {key}")

        self._validate_cross_field()

        # Compatibility mappings.
        if self.jacobian_method == "complex":
            # The reference's complex-step trick is replaced by exact
            # forward-mode AD (SURVEY.md §2.1).
            self.jacobian_method = "jvp"

    def _validate_cross_field(self):
        if self.grid_type == "cubed_sphere" and self.equations == "euler":
            if self.ztop <= 0.0:
                raise ConfigurationError("3D Euler on the cubed sphere requires ztop > 0")
        if self.grid_type == "cartesian2d":
            if self.x1 <= self.x0 or self.z1 <= self.z0:
                raise ConfigurationError("cartesian2d grid requires x1 > x0 and z1 > z0")

    def state_id_params(self) -> tuple:
        """Parameters that identify a compatible saved state (reference
        output_manager.py:78-97 hashes dt, total elements, num_solpts)."""
        return (
            self.dt,
            self.num_elements_horizontal,
            self.num_elements_vertical,
            self.num_solpts,
            self.equations,
            self.case_number,
        )

    def __repr__(self) -> str:
        fields = ", ".join(f"{f.name}={getattr(self, f.name)!r}" for f in SCHEMA[:8])
        return f"Configuration({fields}, ...)"


def load_configuration(path: str, strict: bool = False) -> Configuration:
    with open(path, "r", encoding="utf-8") as fh:
        return Configuration(fh.read(), strict=strict)
