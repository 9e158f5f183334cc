"""Snapshot rollback CLI of the port (reference: nds/nds_rollback.py
__main__ :54-60; the arguments of nds_tpu/cli/rollback.py):

    python -m nds_tpu_torch.cli.rollback <warehouse_path> <timestamp>
        [--device DEV]

Restores the maintenance-mutated fact tables to their last snapshot at or
before <timestamp> ('YYYY-mm-dd HH:MM:SS[.f]'). The session runs on the
card (`--device` names another, e.g. `cpu`).
"""

import argparse

from ..check import check_version
from ..maintenance import rollback


def main(argv=None):
    check_version()
    parser = argparse.ArgumentParser()
    parser.add_argument("warehouse_path", help="lakehouse warehouse root")
    parser.add_argument("timestamp", help="timestamp to roll back to")
    parser.add_argument(
        "--device", help="the session's device (default: the card, cuda)"
    )
    args = parser.parse_args(argv)
    rollback(args.warehouse_path, args.timestamp, device=args.device)


if __name__ == "__main__":
    main()
