"""Query-stream generation CLI of the port (the arguments of
nds_tpu/cli/gen_query_stream.py; the templates default to the port's own
nds_tpu_torch/datagen/templates/):

    python -m nds_tpu_torch.cli.gen_query_stream --scale S --output_dir DIR
        [--template_dir DIR] [--streams N] [--rngseed N] [--template queryK.tpl]

Counterpart of the reference's stream generator (reference:
nds/nds_gen_query_stream.py — generate_query_streams :42-89, single-template
mode :115-119, seedable --rngseed per TPC-DS 4.3.1).
"""

from __future__ import annotations

import argparse

from ..datagen import query_streams


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate TPC-DS-style permuted query streams"
    )
    parser.add_argument("--template_dir", default=None,
                        help="directory containing queryN.tpl templates "
                        "(default: the package's own templates/)")
    parser.add_argument("--scale", type=float, required=True,
                        help="benchmark scale factor (parameters scale with it)")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--streams", type=int, default=1,
                        help="number of streams (query_0.sql .. query_{n-1}.sql)")
    parser.add_argument("--rngseed", type=int, default=19620718,
                        help="random seed; TPC-DS 4.3.1 requires the load-test "
                        "end timestamp for a compliant run")
    parser.add_argument("--template", default=None,
                        help="generate a single query from this template "
                        "(e.g. query3.tpl)")
    args = parser.parse_args(argv)

    if args.template:
        path = query_streams.generate_single(
            args.output_dir, args.template, args.scale, args.rngseed,
            args.template_dir,
        )
        print(f"wrote {path}")
    else:
        qnums = query_streams.generate_streams(
            args.output_dir, args.streams, args.scale, args.rngseed,
            args.template_dir,
        )
        print(
            f"wrote {args.streams} stream(s) x {len(qnums)} queries to "
            f"{args.output_dir}"
        )


if __name__ == "__main__":
    main()
