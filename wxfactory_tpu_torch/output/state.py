"""Checkpoint state files.

Same on-disk format as the reference (output/state.py:9-33): a numpy .npy
payload, a version line, then the full configuration INI text — so states
written by either implementation can be inspected/compared with the same
tooling (reference scripts/compare_states.py).

The array payload uses the reference's panel-major layout (6, nvar, ...);
the in-memory global layout here is (nvar, 6, ...), converted on the way
in/out.
"""

import io
from typing import Optional, Tuple

import numpy as np

from ..config import Configuration

STATE_VERSION = "1.0"


def to_file_layout(q: np.ndarray) -> np.ndarray:
    """(nvar, 6, ...) -> (6, nvar, ...) reference cube layout."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(q), 0, 1))


def from_file_layout(q: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(np.asarray(q), 1, 0))


def save_state(state: np.ndarray, config: Configuration, path: str, panel_major: bool = True) -> None:
    """Write a state file. `state` is the global (nvar, 6, ...) array (or any
    array if panel_major=False, e.g. the cartesian grid)."""
    payload = to_file_layout(state) if panel_major else np.asarray(state)
    with open(path, "wb+") as fh:
        np.save(fh, payload)
        fh.write(bytes(f"{STATE_VERSION}\n", "utf-8"))
        fh.write(bytes(config.raw_text, "utf-8"))


def load_state(
    path: str, panel_major: bool = True, parse_config: bool = True
) -> Tuple[np.ndarray, Optional[Configuration], str]:
    """Read a state file; returns (state, config, version). The state comes
    back in the in-memory (nvar, 6, ...) layout when panel_major. With
    ``parse_config=False`` the third-party config text is returned raw
    (states written by other tools may not validate against the schema)."""
    with open(path, "rb") as fh:
        payload = np.load(fh)
        version = str(fh.readline(), "utf-8").strip()
        config_text = str(fh.read(), "utf-8").strip()
    config = Configuration(config_text) if (config_text and parse_config) else config_text or None
    state = from_file_layout(payload) if panel_major else payload
    return state, config, version
