"""Argument validation of the Power Run's CLI: the subset of nds_tpu/check.py
that power.py and cli/power.py use (reference: nds/check.py check_version
:38-44, check_json_summary_folder :136-145, check_query_subset_exists
:147-152)."""

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
