"""PyTorch port: the command line (``…_torch/cli.py``) against the repo's
``cli.py`` on the same argv and the same files.

The reference runs every case in one subprocess (JAX on the CPU with 8
devices, as ``tests/conftest.py`` sets it up), started before the port's
cases and read after them; the port runs each case in this process with
``main(argv, device="cpu")``.  Per case:

- the lines equal the reference's, except the ``wall_s`` value, the
  ``--time`` line's numbers and the world-size suffix of ``algo`` under
  ``--distributed`` (``@mesh<N>``);
- counts and offsets equal ``conformance/oracle.find_all``.

The corpora: ``gen_english(50_000, seed=31)`` and a dense text of ``a``
and ``e`` (1.2 MB, so a 1 MiB stream takes two chunks).  The cases cover
every flag of ``cli.py`` and carry over the reference's own CLI cases
(``tests/test_aux.py`` and ``tests/test_streaming.py``).
"""

import _torch_threads  # noqa: F401

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest

import cli as ref_cli
from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch import cli
from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.io import (
    gen_english,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, D, M = "{corpus}", "{dense}", "{manifest}"
ALGOS = ("naive", "rabin_karp", "kmp", "boyer_moore")
# A clock that reads 0 and then 1 us: wall = 1e-6 s in the --time line.
CLOCK = [0.0, 1e-6]


def _dense() -> bytes:
    rng = np.random.default_rng(37)
    return np.where(rng.random(1_200_000) < 0.1, ord("a"), ord("e")).astype(
        np.uint8).tobytes()


def _corpus() -> bytes:
    return gen_english(50_000, seed=31)


# name: argv from the corpus (patterns sliced from it)
CASES = {
    **{f"algo-{a}": (lambda d, a=a: [a, C, "the"])
       for a in (*ALGOS, "rk", "bm")},
    "json": lambda d: ["kmp", C, d[2000:2016].decode(), "--json"],
    "count-only": lambda d: ["naive", C, "fox", "--count-only"],
    "offsets-all": lambda d: ["bm", C, "lazy", "--offsets", "-1"],
    "offsets-3": lambda d: ["rk", C, "the", "--offsets", "3"],
    "offsets-all-json": lambda d: ["naive", C, "and", "--offsets", "-1", "--json"],
    "offsets-3-json": lambda d: ["kmp", C, "dog", "--offsets", "3", "--json"],
    "hex-pattern": lambda d: ["bm", C, d[100:106].hex(), "--hex-pattern", "--json"],
    # tests/test_aux.py: test_cli_hex_pattern
    "hex-pattern-count": lambda d: ["bm", C, d[100:106].hex(), "--hex-pattern",
                                    "--count-only"],
    "rk-list-pselect": lambda d: ["rk", C, "the", "fox", "and", d[3000:3016].decode(),
                                  "--json"],
    "rk-list-groups": lambda d: ["rk", C, "the", "fox", "and", "--multi-gather",
                                 "groups", "--json"],
    "rk-list-blocks": lambda d: ["rk", C, "the", "fox", "dog", "--multi-gather",
                                 "blocks"],
    # tests/test_aux.py: test_cli_multi_pattern_json
    "rk-list-latin1": lambda d: ["rk", C, d[10:20].decode("latin1"),
                                 d[500:510].decode("latin1"), "--json"],
    "bm-list": lambda d: ["bm", C, "the", "quick", "--json", "--offsets", "5"],
    **{f"nib-{a}": (lambda d, a=a: [a, C, "the", "--emission", "nib", "--json"])
       for a in ALGOS},
    "nib-rk-list": lambda d: ["rk", C, "the", "fox", "--emission", "nib", "--json"],
    **{f"bm-probes-{p}": (lambda d, p=p: ["bm", C, d[4000:4012].decode(), "--bm-probes",
                                          p, "--json"])
       for p in ("table_gs", "table_gs1", "table", "table_dyn", "static")},
    "kmp-long-ripple": lambda d: ["kmp", C, d[1000:1040].decode(), "--kmp-long",
                                  "ripple", "--json"],
    "kmp-long-screen": lambda d: ["kmp", C, d[1000:1040].decode(), "--kmp-long",
                                  "screen"],
    "dense-capacity-16": lambda d: ["bm", D, "aa", "--capacity", "16", "--json"],
    "dense-capacity-16-drain": lambda d: ["naive", D, "aa", "--capacity", "16",
                                          "--drain", "--json", "--offsets", "-1"],
    "capacity-0": lambda d: ["bm", C, "the", "--capacity", "0", "--json"],
    "capacity-0-text": lambda d: ["kmp", C, "the", "--capacity", "0"],
    # tests/test_aux.py: test_cli_emission_probe_drain_flags
    "emission-probe-drain": lambda d: ["bm", C, "e", "--capacity", "256", "--drain",
                                       "--offsets", "-1", "--json", "--emission", "nib",
                                       "--bm-probes", "static"],
    "stream-manifest": lambda d: ["rk", D, "aae", "eaa", "--stream", "--chunk-mb", "1",
                                  "--manifest", M, "--json"],
    "stream-resume": lambda d: ["rk", D, "aae", "eaa", "--stream", "--chunk-mb", "1",
                                "--manifest", M, "--resume", "--json"],
    # tests/test_streaming.py: test_cli_stream_drain
    "stream-drain": lambda d: ["naive", D, "aa", "--stream", "--chunk-mb", "1",
                               "--capacity", "16", "--drain", "--json", "--offsets", "-1"],
    # tests/test_streaming.py: test_cli_stream_and_count_only
    "stream-count-only": lambda d: ["naive", C, "the", "--stream", "--chunk-mb", "1",
                                    "--count-only"],
    # tests/test_streaming.py: test_cli_basic
    "stream-basic-kmp": lambda d: ["kmp", C, "quick", "--stream", "--chunk-mb", "1",
                                   "--json"],
    # tests/test_aux.py: test_cli_time_flag
    "time": lambda d: ["naive", C, "the", "--time", "--count-only"],
    "time-clock": lambda d: ["rk", C, "the", "fox", "--time", "--count-only"],
    "multihost": lambda d: ["rk", C, "the", "fox", "--multihost", "--capacity", "16",
                            "--json"],
    "stream-multihost": lambda d: ["kmp", D, "aa", "--stream", "--multihost",
                                   "--chunk-mb", "1", "--json", "--offsets", "5"],
    "distributed": lambda d: ["kmp", C, "the", "--distributed", "--json"],
    "distributed-list": lambda d: ["rk", C, "the", "fox", "--distributed", "--capacity",
                                   "16"],
    "distributed-drain": lambda d: ["naive", D, "aa", "--distributed", "--capacity", "16",
                                    "--drain", "--count-only"],
}
FAKE_CLOCK = {"time-clock"}

REF_RUNNER = r"""
import contextlib, io, json, sys, time, traceback, types
import jax
jax.config.update("jax_platforms", "cpu")
import cli
cases, out_path = json.load(open(sys.argv[1])), sys.argv[2]
res = {}
for name, argv, clock in cases:
    cli.time = types.SimpleNamespace(perf_counter=iter(clock).__next__) if clock else time
    o, e = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
            rc = cli.main(argv)
    except Exception:
        rc = traceback.format_exc()
    res[name] = [rc, o.getvalue(), e.getvalue()]
with open(out_path, "w") as f:
    json.dump(res, f)
"""


def _argv(name: str, data: bytes, paths: dict) -> list:
    return [a.format(**paths) if a in (C, D, M) else a for a in CASES[name](data)]


def run_port(argv, clock=None) -> tuple:
    """(rc, stdout, stderr) of the port's ``main(argv, device="cpu")``."""
    o, e = io.StringIO(), io.StringIO()
    saved = cli.time
    if clock:
        cli.time = types.SimpleNamespace(perf_counter=iter(clock).__next__)
    try:
        with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
            rc = cli.main(argv, device="cpu")
    finally:
        cli.time = saved
    return rc, o.getvalue(), e.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    data, dense = _corpus(), _dense()
    (d / "corpus.bin").write_bytes(data)
    (d / "dense.bin").write_bytes(dense)
    paths = {"corpus": str(d / "corpus.bin"), "dense": str(d / "dense.bin")}
    ref_cases = [(n, _argv(n, data, {**paths, "manifest": str(d / "ref.man")}),
                  CLOCK if n in FAKE_CLOCK else None) for n in CASES]
    (d / "cases.json").write_text(json.dumps(ref_cases))
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_RUNNER, str(d / "cases.json"), str(d / "ref.json")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        port = {}
        for n in CASES:
            argv = _argv(n, data, {**paths, "manifest": str(d / "port.man")})
            port[n] = (argv, run_port(argv, CLOCK if n in FAKE_CLOCK else None))
        _out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err.decode()[-3000:]
    refs = json.loads((d / "ref.json").read_text())
    texts = {paths["corpus"]: data, paths["dense"]: dense}
    return port, refs, texts, d


def normalized(line: str):
    """A line without what may differ: ``wall_s``, and the world size in
    an ``algo`` of ``@mesh<N>``."""
    try:
        row = json.loads(line)
    except ValueError:
        return re.sub(r"@mesh\d+: ", "@mesh: ", line)
    if isinstance(row, dict):
        row.pop("wall_s")
        row["algo"] = re.sub(r"@mesh\d+$", "@mesh", row["algo"])
    return row


@pytest.mark.parametrize("name", list(CASES))
def test_cli_lines_equal_the_reference(name, runs):
    port, refs, _texts, _d = runs
    _argv_, (rc, out, err) = port[name]
    ref_rc, ref_out, ref_err = refs[name]
    assert ref_rc == 0 and rc == 0, ref_rc
    assert out.strip(), "no output"
    assert ([normalized(x) for x in out.splitlines()]
            == [normalized(x) for x in ref_out.splitlines()])
    if "--time" in _argv_:
        assert "GB/s" in err and "GB/s" in ref_err
        if name in FAKE_CLOCK:
            assert err == ref_err
    else:
        assert err == ref_err == ""


@pytest.mark.parametrize("name", list(CASES))
def test_cli_counts_and_offsets_equal_the_oracle(name, runs):
    port, _refs, texts, _d = runs
    argv, (_rc, out, _err) = port[name]
    args = cli.build_parser().parse_args(argv)
    text = texts[args.textfile]
    pats = [bytes.fromhex(p) if args.hex_pattern else p.encode() for p in args.pattern]
    plain_multihost = args.multihost and not args.stream
    cap = 65536 if plain_multihost else args.capacity
    if plain_multihost:
        pats = pats[:1]
    lines = out.splitlines()
    assert len(lines) == len(pats)
    for pat, line in zip(pats, lines):
        want = find_all(text, pat)
        if args.json:
            row = json.loads(line)
            assert row["count"] == len(want) and row["n_bytes"] == len(text)
            assert row["pattern"] == pat.decode("utf-8", "replace")
            offs = row["offsets"]
            k = len(want) if args.offsets < 0 else min(args.offsets, len(want))
            if cap == 0:
                assert offs == [] and row["overflow"] == bool(want)
            elif args.drain or len(want) <= cap:
                assert offs == want[:k] and not row["overflow"]
            else:
                assert row["overflow"]
                if not args.stream:  # a stream keeps each chunk's first ones
                    assert offs == want[: len(offs)] and len(offs) == min(k, cap)
        elif args.count_only:
            assert int(line) == len(want)
        else:
            got = re.search(r": pattern (.*): (\d+) match\(es\)", line)
            assert got.group(1) == repr(pat) and int(got.group(2)) == len(want)
            if want and cap:
                shown = json.loads(line.split(" at ", 1)[1].split(" ...")[0])
                k = min(len(want), cap) if args.offsets < 0 else min(args.offsets,
                                                                     len(want), cap)
                assert shown == want[:k]


def test_multihost_takes_the_first_pattern_and_the_default_config(runs):
    """Reference behaviour the port mirrors (cli.py:151-158): ``--multihost``
    without ``--stream`` matches ``patterns[0]`` only and drops the config
    flags: capacity 16 is ignored, so 231 matches do not overflow."""
    port, _refs, texts, _d = runs
    argv, (_rc, out, _err) = port["multihost"]
    (row,) = [json.loads(x) for x in out.splitlines()]
    want = find_all(texts[argv[1]], b"the")
    assert row["pattern"] == "the" and row["count"] == len(want) > 16
    assert not row["overflow"] and row["offsets"] == want[:20]
    assert row["algo"] == "rk@hosts1"


def test_time_counts_the_first_result_times_the_results(runs):
    """Reference behaviour the port mirrors (cli.py:181-185): ``--time``
    reports ``results[0].n * len(results)`` bytes, here 2 x 50,000 bytes
    in the fake clock's 1 us."""
    port, refs, _texts, _d = runs
    _argv_, (_rc, _out, err) = port["time-clock"]
    assert err == "0.000s  100.00 GB/s\n" == refs["time-clock"][2]


def test_resume_reads_the_finished_manifest(runs):
    """A resume from a finished manifest (1.2 MB in 1 MiB chunks: two)
    prints what the run that wrote it printed."""
    port, _refs, _texts, d = runs
    with open(d / "port.man") as f:
        assert json.load(f)["next_chunk"] == 2
    rows = [[normalized(x) for x in port[n][1][1].splitlines()]
            for n in ("stream-manifest", "stream-resume")]
    assert rows[0] == rows[1]


def _actions(parser):
    return {a.dest: a for a in parser._actions}


def test_build_parser_has_the_reference_flags():
    """The same flags, defaults, choices, types and help; only the program
    name, the description and ``--multihost``'s help (which names the
    process group) differ."""
    mine, ref = _actions(cli.build_parser()), _actions(ref_cli.build_parser())
    assert mine.keys() == ref.keys()
    for dest, a in ref.items():
        b = mine[dest]
        for attr in ("option_strings", "default", "choices", "type", "nargs", "const",
                     "metavar", "required"):
            assert getattr(a, attr) == getattr(b, attr), (dest, attr)
        assert type(a) is type(b), dest
        if dest != "multihost":
            assert a.help == b.help, dest


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    import torch

    path = tmp_path / "c.bin"
    path.write_bytes(b"abcabc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--stream"], ["--distributed"], ["--multihost"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["bm", str(path), "bc", *extra])
    assert run_port(["bm", str(path), "bc", "--count-only"])[1] == "2\n"
