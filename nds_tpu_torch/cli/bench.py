"""Whole-benchmark CLI of the port (reference: nds/nds_bench.py __main__
:500-506; the arguments of nds_tpu/cli/bench.py):

    python -m nds_tpu_torch.cli.bench <bench.yml> [--resume]
        [--fault_spec SPEC] [--device DEV]

The device phases run on the card (`--device` names another, e.g. `cpu`).
"""

import argparse
import os

from ..check import check_version
from ..full_bench import get_yaml_params, run_full_bench


def main(argv=None):
    check_version()
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "yaml_config", help="yaml config file for the benchmark"
    )
    parser.add_argument(
        "--resume",
        action="store_true",
        help="resume from the bench_state.json checkpoint: phases recorded "
        "as completed are skipped (no manual skip: editing)",
    )
    parser.add_argument(
        "--fault_spec",
        help="fault-injection spec, e.g. 'oom:query5;crash:power_test' "
        "(exported as NDS_FAULT_SPEC so phase subprocesses inherit it)",
    )
    parser.add_argument(
        "--device",
        help="the device phases' device (default: the card, cuda)",
    )
    args = parser.parse_args(argv)
    if args.fault_spec:
        # env, not conf: phases are subprocess boundaries and must inherit
        os.environ["NDS_FAULT_SPEC"] = args.fault_spec
    params = get_yaml_params(args.yaml_config)
    run_full_bench(params, resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
