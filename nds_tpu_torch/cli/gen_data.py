"""Data-generation CLI of the port (a copy of nds_tpu/cli/gen_data.py that
runs the port's own generator, built from nds_tpu_torch/datagen/native/).

    python -m nds_tpu_torch.cli.gen_data [local|cluster] --scale S
        --data_dir DIR [--parallel N] [--range a,b] [--update N]
        [--table T] [--seed N] [--overwrite_output] [--hosts F]
        [--retries N]

Counterpart of the reference's generator driver (reference:
nds/nds_gen_data.py — generate_data_local :183-244, generate_data_hdfs
:130-180, merge/move helpers :85-127). Local mode fans out one ndsgen
process per chunk; cluster mode fans chunks across hosts over ssh onto a
shared filesystem, replacing the reference's Hadoop-MapReduce wrapper
(reference: nds/tpcds-gen/.../GenTable.java:188-209) with direct process
fan-out.

Output layout (identical to the reference's):
  data_dir/<table>/<table>_<child>_<parallel>.dat
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

from .. import check
from ..schema import get_maintenance_schemas, get_schemas

SOURCE_TABLE_NAMES = sorted(get_schemas().keys())
MAINTENANCE_TABLE_NAMES = sorted(get_maintenance_schemas().keys())


def _chunk_cmds(binary, args, children):
    cmds = []
    for i in children:
        cmd = [binary, "-scale", str(args.scale), "-dir", args.data_dir,
               "-parallel", str(args.parallel), "-child", str(i), "-seed", str(args.seed)]
        if args.update:
            cmd += ["-update", str(args.update)]
        if args.table:
            cmd += ["-table", args.table]
        cmds.append(cmd)
    return cmds


def _layout_tables(args, children):
    """Move chunk files into per-table subdirectories."""
    names = MAINTENANCE_TABLE_NAMES if args.update else SOURCE_TABLE_NAMES
    for table in names:
        table_dir = os.path.join(args.data_dir, table)
        os.makedirs(table_dir, exist_ok=True)
        for i in children:
            src = os.path.join(args.data_dir, f"{table}_{i}_{args.parallel}.dat")
            if os.path.exists(src):
                shutil.move(src, table_dir)


def _guard_output_dir(args):
    """Refuse to mix chunk sets: non-empty target needs --overwrite_output,
    and a full (non --range) rerun wipes stale content first."""
    os.makedirs(args.data_dir, exist_ok=True)
    if check.get_dir_size(args.data_dir) > 0:
        if not args.overwrite_output:
            raise Exception(
                f"There's already data in {args.data_dir}. Use '--overwrite_output' to overwrite.")
        if not args.range:
            for entry in os.listdir(args.data_dir):
                path = os.path.join(args.data_dir, entry)
                shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)


def _wait_all(procs, what):
    """Wait for every child before raising, so a failed chunk can't leave
    siblings racing a subsequent --overwrite_output rerun."""
    failed = []
    for p in procs:
        p.wait()
        if p.returncode != 0:
            failed.append(p.returncode)
    if failed:
        raise Exception(f"{what} failed with return code(s) {failed}")


def _write_dbgen_version(args):
    """One-row version/audit table (reference: dsdgen emits dbgen_version,
    moved into place by nds_gen_data.py:50-51). Not emitted for refresh
    (--update) sets, matching the reference's source-table list."""
    if args.update:
        return
    import datetime

    now = datetime.datetime.now()
    d = os.path.join(args.data_dir, "dbgen_version")
    os.makedirs(d, exist_ok=True)
    cmdline = f"-scale {args.scale} -parallel {args.parallel}"
    row = (
        f"1.0.0|{now:%Y-%m-%d}|{now:%H:%M:%S}|{cmdline}|\n"
    )
    with open(os.path.join(d, "dbgen_version_1_1.dat"), "w") as f:
        f.write(row)


def generate_data_local(args, children):
    binary = check.check_build()
    _guard_output_dir(args)
    procs = [subprocess.Popen(cmd) for cmd in _chunk_cmds(binary, args, children)]
    _wait_all(procs, "ndsgen")
    _layout_tables(args, children)
    _write_dbgen_version(args)
    subprocess.run(["du", "-h", "-d1", args.data_dir])


def _spawn_on_host(host, cmd):
    """Launch one chunk command, locally or through ssh. Split out so tests
    can observe/replace the launch mechanism without a real cluster."""
    if host in ("localhost", "127.0.0.1"):
        return subprocess.Popen(cmd)
    return subprocess.Popen(["ssh", host] + cmd)


def generate_data_cluster(args, children):
    """Fan chunks across hosts over ssh; every host writes to the shared
    data_dir (NFS/GCS-fuse). Hosts file: one hostname per line.

    A chunk whose process exits non-zero (host down, ssh hiccup, OOM) is
    retried up to --retries times, each attempt rotated to the next host in
    the list so a single dead host can't wedge the run — the elastic-recovery
    counterpart of MapReduce task retries in the reference's Hadoop wrapper
    (reference: nds/tpcds-gen/.../GenTable.java:140-167, where MR re-executes
    failed map tasks)."""
    binary = check.check_build()
    with open(args.hosts) as f:
        hosts = [h.strip() for h in f if h.strip() and not h.strip().startswith("#")]
    if not hosts:
        raise Exception(f"no hosts in {args.hosts}")
    _guard_output_dir(args)
    # pending: chunk index (within this run's command list) -> attempt count
    cmds = _chunk_cmds(binary, args, children)
    attempts = {n: 0 for n in range(len(cmds))}
    pending = list(attempts)
    while pending:
        procs = {}
        for n in pending:
            host = hosts[(n + attempts[n]) % len(hosts)]
            attempts[n] += 1
            procs[n] = (host, _spawn_on_host(host, cmds[n]))
        failed = []
        for n, (host, p) in procs.items():
            p.wait()
            if p.returncode != 0:
                failed.append((n, host, p.returncode))
        pending = []
        for n, host, rc in failed:
            if attempts[n] <= args.retries:
                print(f"chunk {n + 1}/{len(cmds)} failed on {host} "
                      f"(rc={rc}); retry {attempts[n]}/{args.retries}",
                      file=sys.stderr)
                pending.append(n)
            else:
                raise Exception(
                    f"chunk {n + 1}/{len(cmds)} failed on {host} (rc={rc}) "
                    f"after {args.retries} retries")
    _layout_tables(args, children)
    _write_dbgen_version(args)


def generate_data(args):
    check.check_version()
    if args.table:
        valid = set(MAINTENANCE_TABLE_NAMES if args.update else SOURCE_TABLE_NAMES)
        if args.table not in valid:
            raise Exception(f"unknown table {args.table!r}; expected one of {sorted(valid)}")
    range_start, range_end = 1, args.parallel
    if args.range:
        range_start, range_end = check.valid_range(args.range, args.parallel)
    children = range(range_start, range_end + 1)
    if args.type == "local":
        generate_data_local(args, children)
    else:
        generate_data_cluster(args, children)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate TPC-DS-shaped raw data (pipe-delimited)")
    parser.add_argument("type", choices=["local", "cluster"], nargs="?", default="local",
                        help="generate on this host or fan out across a host list")
    parser.add_argument("--scale", type=check.scale_of, required=True,
                        help="volume of data to generate in GB (fractional allowed for smoke tests)")
    parser.add_argument("--parallel", type=check.parallel_value_type, default=2,
                        help="generate data in <n> chunks")
    parser.add_argument("--data_dir", required=True, help="target directory for generated data")
    parser.add_argument("--range", help="generate only chunks 'start,end' of the parallel set")
    parser.add_argument("--update", type=int, help="generate refresh set <n> (maintenance/throughput)")
    parser.add_argument("--table", help="generate only this table")
    parser.add_argument("--seed", type=int, default=19620718, help="RNG seed")
    parser.add_argument("--overwrite_output", action="store_true",
                        help="overwrite existing data in data_dir")
    parser.add_argument("--hosts", default="hosts.txt", help="hosts file for cluster mode")
    parser.add_argument("--retries", type=int, default=2,
                        help="cluster mode: retry a failed chunk up to <n> times on rotated hosts")
    args = parser.parse_args(argv)
    generate_data(args)


if __name__ == "__main__":
    main()
