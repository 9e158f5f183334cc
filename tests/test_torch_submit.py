"""The port's launcher `nds-tpu-torch-submit` and its templates
(nds_tpu_torch/templates/*_gpu*.template) against the JAX package's
`nds-tpu-submit` and templates/*.template.

Each template pair is sourced by its launcher in front of a probe module
that prints its argv: the port's template gives the JAX template's flags,
first, so that the user's flags win (argparse keeps the last occurrence).
`explain` runs the port's explain CLI on the CPU; each verb whose module
the port has not ported exits non-zero naming its ROADMAP.md item; and no
template or verb names the JAX package.

Tolerance: exact (argv lists, exit codes, strings).
"""

import argparse
import json
import os
import re
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER = os.path.join(REPO, "nds-tpu-torch-submit")
TEMPLATE_DIR = os.path.join(REPO, "nds_tpu_torch", "templates")

#: the port's template -> the JAX package's template it counts for
TEMPLATES = {
    "base_gpu.template": "base.template",
    "convert_submit_gpu.template": "convert_submit_tpu.template",
    "maintenance_gpu.template": "maintenance_tpu.template",
    "power_run_gpu.template": "power_run_tpu.template",
    "power_run_gpu_lakehouse.template": "power_run_tpu_lakehouse.template",
}

#: the verbs the port had not ported -> the ROADMAP.md item that ports them
#: (`profile` was ported by item 12a, `serve`, `catalog` and `route` by item
#: 12b, `lint` by item 15: ONCE_UNPORTED_VERBS, each with flags its --help
#: shows)
UNPORTED_VERBS = {"profile": "12a", "lint": 15, "serve": "12b",
                  "catalog": "12b", "route": "12b"}
ONCE_UNPORTED_VERBS = {"profile": ("--critical-path", "--check"),
                       "lint": ("--write-lock-order", "--list-rules"),
                       "serve": ("--stream", "--device"),
                       "catalog": ("--recover_only",),
                       "route": ("--mesh_replica",)}

PROBE = "import json, sys\nprint(json.dumps(sys.argv[1:]))\n"


def _launch(launcher, *args, env=None, cwd=REPO):
    return subprocess.run(["bash", launcher, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


@pytest.fixture
def probe(tmp_path):
    (tmp_path / "argv_probe.py").write_text(PROBE)
    return {"PYTHONPATH": str(tmp_path) + os.pathsep
            + os.environ.get("PYTHONPATH", "")}


def test_every_template_has_its_counterpart():
    assert sorted(os.listdir(TEMPLATE_DIR)) == sorted(TEMPLATES)
    assert sorted(TEMPLATES.values()) == sorted(
        os.listdir(os.path.join(REPO, "templates")))


@pytest.mark.parametrize("template", sorted(TEMPLATES))
@pytest.mark.parametrize("knobs", [
    {}, {"NDS_PROPERTY_FILE": "engine.properties"},
    {"NDS_MESH_DEVICES": "4"},
    {"NDS_PROPERTY_FILE": "p.properties", "NDS_MESH_DEVICES": "2"}])
def test_template_flags_come_first_and_match_jax(probe, template, knobs):
    user = ["--input_format", "csv", "--output_format", "json", "pos"]
    env = {**probe, "NDS_PROPERTY_FILE": "", "NDS_MESH_DEVICES": "", **knobs}
    got = _launch(LAUNCHER, os.path.join(TEMPLATE_DIR, template),
                  "argv_probe", *user, env=env)
    want = _launch(os.path.join(REPO, "nds-tpu-submit"),
                   os.path.join(REPO, "templates", TEMPLATES[template]),
                   "argv_probe", *user, env=env)
    assert got.returncode == want.returncode == 0, (got.stderr, want.stderr)
    argv = json.loads(got.stdout)
    assert argv == json.loads(want.stdout)
    assert argv[len(argv) - len(user):] == user  # the template's flags first
    # the user's flags win where a template sets the same one
    ap = argparse.ArgumentParser()
    for flag in ("--input_format", "--output_format", "--output_mode",
                 "--property_file", "--mesh_devices"):
        ap.add_argument(flag)
    ap.add_argument("pos")
    ns = ap.parse_args(argv)
    assert (ns.input_format, ns.output_format) == ("csv", "json")


def test_template_reaches_the_ports_cli(tmp_path):
    """The power template's --mesh_devices reaches the port's power CLI,
    which raises naming ROADMAP.md item 13."""
    stream = tmp_path / "query_0.sql"
    stream.write_text("-- start query 1 in stream 0 using template "
                      "query96.tpl\nselect 1;\n-- end query 1 in stream 0 "
                      "using template query96.tpl\n")
    r = _launch(LAUNCHER, os.path.join(TEMPLATE_DIR, "power_run_gpu.template"),
                "nds_tpu_torch.cli.power", str(tmp_path / "wh"), str(stream),
                str(tmp_path / "time.csv"), "--device", "cpu",
                env={"NDS_MESH_DEVICES": "2", "NDS_PROPERTY_FILE": ""})
    assert r.returncode != 0
    assert "item 13" in r.stderr, r.stderr[-2000:]


def test_explain_verb_runs_on_the_cpu():
    r = _launch(LAUNCHER, "explain", "--query", "96", "--scale", "1",
                "--budget", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "verdict" in r.stdout.lower(), r.stdout[-2000:]


@pytest.mark.parametrize("verb", sorted(UNPORTED_VERBS))
def test_unported_verb_names_its_item(verb):
    if verb in ONCE_UNPORTED_VERBS:
        # ported: the verb runs the port's CLI, as the reference's does
        r = _launch(LAUNCHER, verb, "--help")
        assert r.returncode == 0, r.stderr[-2000:]
        for flag in ONCE_UNPORTED_VERBS[verb]:
            assert flag in r.stdout, (verb, flag)
        return
    r = _launch(LAUNCHER, verb, "--help")
    assert r.returncode != 0
    assert f"ROADMAP.md queue 1 item {UNPORTED_VERBS[verb]} " in r.stderr, (
        r.stderr)
    assert r.stdout == ""


def test_no_template_or_verb_names_the_jax_package():
    texts = [open(LAUNCHER).read()] + [
        open(os.path.join(TEMPLATE_DIR, t)).read() for t in TEMPLATES]
    for text in texts:
        code = "\n".join(line for line in text.splitlines()
                         if not line.lstrip().startswith("#"))
        assert not re.search(r"\bnds_tpu\.", code), code
    modules = re.findall(r"python -m (\S+)", texts[0])
    assert modules == ["nds_tpu_torch.cli.explain", "nds_tpu_torch.cli.cache",
                       "nds_tpu_torch.cli.lint", "nds_tpu_torch.cli.profile",
                       '"nds_tpu_torch.cli.$verb"', '"$MODULE"'], modules
