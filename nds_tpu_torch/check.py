"""Argument and build validation of the phase CLIs: the port of
nds_tpu/check.py (reference: nds/check.py check_version :38-44,
check_build :47-66, get_abs_path :69-85, valid_range :88-106,
parallel_value_type :109-123, get_dir_size :126-134,
check_json_summary_folder :136-145, check_query_subset_exists :147-152),
re-targeted at the port's own native generator."""

from __future__ import annotations

import argparse
import os
import sys

MIN_PYTHON = (3, 8)


def check_version():
    if sys.version_info < MIN_PYTHON:
        raise RuntimeError(
            f"Python {MIN_PYTHON[0]}.{MIN_PYTHON[1]}+ required, found {sys.version}"
        )


def get_abs_path(input_path: str) -> str:
    """Expand a relative path against this package's datagen directory so the
    generator binaries can be addressed from any CWD."""
    if os.path.isabs(input_path):
        return input_path
    return os.path.join(os.path.dirname(__file__), "datagen", input_path)


def check_build():
    """Build the port's native generator on demand and return its path (the
    reference requires a manual `make`; the port self-builds)."""
    from .datagen.build import ensure_built

    return ensure_built()


def valid_range(range_str: str, parallel: int):
    """Validate a --range 'start,end' against the chunk count."""
    try:
        start, end = (int(x) for x in range_str.split(","))
    except Exception as exc:
        raise argparse.ArgumentTypeError(
            f"--range must be 'start,end' integers, got {range_str!r}"
        ) from exc
    if not (1 <= start <= end <= parallel):
        raise argparse.ArgumentTypeError(
            f"--range {range_str} invalid: need 1 <= start <= end <= parallel({parallel})"
        )
    return start, end


def parallel_value_type(s: str) -> int:
    v = int(s)
    if v < 2:
        raise argparse.ArgumentTypeError("--parallel must be >= 2")
    return v


def scale_of(s: str) -> float:
    """Scale factor; fractional scales < 1 are allowed for smoke tests."""
    v = float(s)
    if v <= 0:
        raise argparse.ArgumentTypeError("scale must be > 0")
    return v


def get_dir_size(start_path: str) -> int:
    total = 0
    for dirpath, _dirnames, filenames in os.walk(start_path):
        for f in filenames:
            fp = os.path.join(dirpath, f)
            if not os.path.islink(fp):
                total += os.path.getsize(fp)
    return total


def check_json_summary_folder(folder: str):
    """Create the summary folder if needed; refuse to clobber a non-empty one
    (the user must clean it)."""
    if not folder:
        return folder
    try:
        if os.path.exists(folder):
            if os.listdir(folder):
                raise argparse.ArgumentTypeError(
                    f"json summary folder {folder!r} exists and is not empty"
                )
        else:
            os.makedirs(folder)
    except OSError as exc:  # an existing file, permissions, ...
        raise argparse.ArgumentTypeError(
            f"json summary folder {folder!r} unusable: {exc}"
        ) from exc
    return folder


def check_query_subset_exists(queries: dict, subset: list) -> bool:
    missing = [q for q in subset if q not in queries]
    if missing:
        raise Exception(f"queries not found in stream: {missing}")
    return True
