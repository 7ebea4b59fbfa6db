#!/usr/bin/env python3
"""A/B timing of the port's scan kernels on one NVIDIA GPU.

    python3 kernel_ab.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Times the scans of ``csrc/swar.cu`` (K1 ``screen_cand_bsums``, K2
``naive_nib``, K3 ``naive_bsums``, K7/K8 ``screened_nib`` and
``screened_bsums``, K11a ``screen_cand_nibsums``), of ``csrc/rk_roll.cu``
(K5 ``rk_candidate_bsums``, K10b ``rk_candidate_nib``, K6
``rk_candidate_pmask``, K10c ``rk_candidate_bmask``) and of
``csrc/shift_and.cu`` (K4 ``kmp_bsums``, K10a ``kmp_nib``, and K9: the
same wrappers on the composed-4 step at m=16 and m=256 (K = 8) and with
the compare-B lookup at m=16 per byte and composed, ``STEP_PATH`` set on
each checkout's own module around its calls), K11d ``gather_verify``
(cap_g 4096, 1024 and 2048 on the groups of K11a's candidates), and the
paths that run them, in each OTHER_CHECKOUT (a tree holding the port, for example
a parent commit unpacked with ``git archive``) against this checkout, in
turns X, this, this, X within one process.  Each checkout's port is loaded
under its own module name (the port imports itself only relatively) and
builds its kernels from its own ``csrc/``.  All run on the same inputs: 256 MiB of
``gen_english`` seed 42 with the bench pattern ``"quick brown fox "`` (K7
under its 'table_gs' probes, K8 under 'table_dyn''s), a 509-byte slice of
it and BASELINE config 2's eight patterns (``chip_smoke.py`` (e)'s cases),
64- and 256-byte slices for K4/K10a (K = 2 and 8 state words), the first
64 MiB of it with the dense pattern ``"e "`` (every warp takes the verify
chains), and config 2's 1 GB text.

Each checkout's SWAR and Shift-AND kernels are listed first with their
registers and shared memory (ptxas) and their SASS instruction count
(``cuobjdump -sass``).
Before timing, every case's output in X, kernels and paths, must equal
this checkout's bit for bit.  Per turn: each kernel's device time per
launch from torch.profiler and its CUDA event time
(``chip_smoke.kernel_device_ms``, ``cuda_ms``); on the device-resident
256 MiB text ``BoyerMooreMatcher.run`` under sparse, 'nib' and
``bm_screen='fused'``, ``NaiveMatcher.run`` under 'nib',
``exp.proto_kernels.gv_offsets`` (cap_g 4096), ``RabinKarpMatcher.run``
and ``KMPMatcher.run`` under sparse and 'nib', and on the device-resident
1 GB text config 2's ``RabinKarpMultiMatcher.run`` under sparse 'pselect'
(K6), 'groups' (K10c) and 'nib' (K10b): host-clock passes ending in a
synchronize, device time and events per run from torch.profiler and its
split by event name, idle share of the median pass.  Prints the card's
name and power limit, one line per measurement, and a JSON summary as the
last line; exits 2 without CUDA.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

HERE = Path(__file__).resolve().parent


def load_port(root: Path, alias: str):
    """The port package of checkout ``root`` as module ``alias``."""
    init = root / cs.PKG / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


class Port:
    """One checkout's port: its kernels built, its modules at hand."""

    def __init__(self, root: Path, alias: str):
        load_port(root, alias)
        sub = lambda name: importlib.import_module(f"{alias}.{name}")  # noqa: E731
        self.build = sub("utils.cuda_build")
        self.libs = self.build.build_all()
        self.rk = sub("kernels.rk_roll")
        self.shift_and = sub("kernels.shift_and")
        self.swar = sub("kernels.swar")
        self.proto = sub("exp.proto_kernels")
        self.algos = sub("models.algorithms")
        self.multi = sub("models.multi")
        self.config = sub("utils.config")
        self.name = alias


def largest_loop(body: str) -> str:
    """The largest loop of a kernel's SASS ``body`` (a backward branch and
    the instructions up to its target) that reads shared memory, or the
    largest loop where none does: its instructions, LDS and SHFL.  (A
    compare-B prologue's loop has none and can be the longer.)"""
    ins = [(int(a, 16), op) for a, op in re.findall(
        r"/[*]([0-9a-f]{4,})[*]/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)[^;]*;", body)]
    spans = [(int(t, 16), a) for a, t in re.findall(
        r"/[*]([0-9a-f]{4,})[*]/\s+(?:@!?U?P\w+\s+)?BRA\s+0x([0-9a-f]+)", body)]
    spans = [(lo, int(hi, 16)) for lo, hi in spans if lo <= int(hi, 16)]
    if not spans:
        return "no loop"
    loops = [[op.split(".")[0] for a, op in ins if lo <= a <= hi] for lo, hi in spans]
    ops = max(loops, key=lambda ops: ("LDS" in ops, len(ops)))
    return f"loop {len(ops)} ({ops.count('LDS')} LDS, {ops.count('SHFL')} SHFL)"


def kernel_name(readable: str) -> str:
    """A demangled kernel's name with its template arguments (nested
    brackets such as ``<unnamed>`` included), namespaces dropped."""
    found = re.search(r"\w+_kernel", readable)
    name, depth = found.group(0), 0
    for i in range(found.end(), len(readable) if readable[found.end():][:1] == "<" else 0):
        depth += {"<": 1, ">": -1}.get(readable[i], 0)
        if depth == 0:
            name += readable[found.end():i + 1]
            break
    return re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", name)


def sass_report(port: Port, names=("swar", "shift_and")) -> list[str]:
    """Per kernel of ``port``'s libraries ``names``: its registers and
    shared memory (ptxas), its SASS instruction count (``cuobjdump -sass``,
    from the toolkit beside nvcc) and its largest loop's, named with its
    template arguments (``cu++filt``)."""
    bin_dir = Path(port.build.find_nvcc()).parent
    out = []
    for name in names:
        lib = port.libs[name]
        used, entry = {}, None
        for line in port.build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "ptxas info" in line and "Used" in line and entry:
                used[entry] = line.split(":", 1)[1].strip()
        sass = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", str(lib)],
                              capture_output=True, text=True, check=True).stdout
        parts = [part.split("\n", 1) for part in re.split(r"\n\s*Function : ", sass)[1:]]
        plain = subprocess.run([str(bin_dir / "cu++filt")], capture_output=True, text=True,
                               check=True, input="\n".join(p[0].strip() for p in parts)
                               ).stdout.splitlines()
        for (mangled, body), readable in zip(parts, plain):
            kernel = kernel_name(readable)
            out.append(f"{name} {kernel}: {len(re.findall(r'/[*][0-9a-f]{4}[*]/', body))} "
                       f"SASS instructions, {largest_loop(body)}; "
                       f"{used.get(mangled.strip(), '')}")
    return out


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.models.base import (
        to_device,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.kernels import (
        swar,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.ops import (
        tables,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu_torch.utils.io import (
        gen_english,
        pad_to_multiple,
    )

    smi = cs.nvidia_smi()
    print(f"nvidia-smi: {smi}")
    dev = torch.device("cuda")
    this = Port(HERE, "port_this")
    others = [Port(Path(p).resolve(), f"port_{i}") for i, p in enumerate(sys.argv[1:])]
    roots = {this.name: str(HERE), **{o.name: str(Path(p).resolve())
                                     for o, p in zip(others, sys.argv[1:])}}
    for port in (this, *others):
        for line in sass_report(port):
            print(f"{roots[port.name]} {line}")

    text = gen_english(256 * cs.MIB, seed=42)
    n = len(text)
    pat, p509 = b"quick brown fox ", text[123457 : 123457 + 509]
    padded = to_device(pad_to_multiple(np.frombuffer(text, np.uint8), 2 * cs.MIB), dev)
    region = padded.view(torch.int32)
    big = gen_english(cs.CONFIG2_BYTES, seed=2)
    nb = len(big)
    c2_pats = cs.config2_patterns(big)
    big_dev = to_device(pad_to_multiple(np.frombuffer(big, np.uint8), 2 * cs.MIB), dev)
    big_region = big_dev.view(torch.int32)
    base = int(tables.RK_BASE)
    u8 = lambda b: np.frombuffer(b, np.uint8)  # noqa: E731
    tgt = lambda pats: torch.tensor(  # noqa: E731
        [int(tables.rk_hash(u8(p), tables.rk_constants(len(p), base))) for p in pats],
        device=dev)
    t16, t509, t8 = tgt([pat]), tgt([p509]), tgt(cs.config2_patterns(text))
    tbig = tgt(c2_pats)
    bt = {m: torch.from_numpy(this.shift_and.b_table(u8(p))).to(dev)
          for m, p in ((16, pat), (64, text[123457 : 123457 + 64]), (256, p509[:256]))}
    dense, dpat = text[: 64 * cs.MIB], b"e "
    dense_region = to_device(np.frombuffer(dense, np.uint8), dev).view(torch.int32)

    def swar_args(words, length: int, p: bytes) -> dict:
        """K1-K3's, K7's ('table_gs' probes) and K8's ('table_dyn')
        arguments over the kernel region of ``words``, as the matchers pass
        them."""
        P, M = (torch.from_numpy(a).to(dev) for a in swar.pattern_words(u8(p)))
        _, cut = swar.kernel_region(4 * words.numel(), len(p),
                                    this.config.MatchConfig().pallas_chunk_bytes)
        lim = min(length - len(p), cut - 1)
        return {"own": (words, lim, P, M),
                "K7": (words, lim, P, M, swar.static_probes_from_table(
                    swar.probe_table(u8(p), use_gs=True))),
                "K8": (words, lim, P, M, swar.static_probes_from_table(
                    swar.probe_table(u8(p))))}

    sw, sd = swar_args(region, n, pat), swar_args(dense_region, len(dense), dpat)
    cases = {  # name: (module, wrapper name, arguments, profiler event name)
        "K1 m=16": ("swar", "screen_cand_bsums", sw["K7"], "_kernel"),
        "K2 m=16": ("swar", "naive_nib", sw["own"], "_kernel"),
        "K3 m=16": ("swar", "naive_bsums", sw["own"], "_kernel"),
        "K7 nib m=16": ("swar", "screened_nib", sw["K7"], "_kernel"),
        "K7 bsums m=16": ("swar", "screened_bsums", sw["K7"], "_kernel"),
        "K8 nib m=16": ("swar", "screened_nib", sw["K8"], "_kernel"),
        "K11a m=16": ("swar", "screen_cand_nibsums", sw["K7"], "_kernel"),
        "K2 dense m=2": ("swar", "naive_nib", sd["own"], "_kernel"),
        "K3 dense m=2": ("swar", "naive_bsums", sd["own"], "_kernel"),
        "K7 nib dense m=2": ("swar", "screened_nib", sd["K7"], "_kernel"),
        "K7 bsums dense m=2": ("swar", "screened_bsums", sd["K7"], "_kernel"),
        "K5 m=16": ("rk", "rk_candidate_bsums", (region, n - 16, t16, 16, base), "rk_"),
        "K5 m=509": ("rk", "rk_candidate_bsums", (region, n - 509, t509, 509, base), "rk_"),
        "K5 k=8 m=16": ("rk", "rk_candidate_bsums", (region, n - 16, t8, 16, base), "rk_"),
        "K10b m=16": ("rk", "rk_candidate_nib", (region, n - 16, t16, 16, base), "rk_"),
        "K10b m=509": ("rk", "rk_candidate_nib", (region, n - 509, t509, 509, base), "rk_"),
        "K10b k=8 m=16": ("rk", "rk_candidate_nib", (region, n - 16, t8, 16, base), "rk_"),
        "K10b 1 GB k=8 m=16": ("rk", "rk_candidate_nib",
                               (big_region, nb - 16, tbig, 16, base), "rk_"),
        "K6 k=8 m=16": ("rk", "rk_candidate_pmask", (region, n - 16, t8, 16, base), "rk_"),
        "K6 1 GB k=8 m=16": ("rk", "rk_candidate_pmask",
                             (big_region, nb - 16, tbig, 16, base), "rk_"),
        "K10c k=8 m=16": ("rk", "rk_candidate_bmask", (region, n - 16, t8, 16, base), "rk_"),
        "K10c 1 GB k=8 m=16": ("rk", "rk_candidate_bmask",
                               (big_region, nb - 16, tbig, 16, base), "rk_"),
        **{f"K4 m={m}": ("shift_and", "kmp_bsums", (region, n - m, t, m), "kmp_")
           for m, t in bt.items()},
        **{f"K10a m={m}": ("shift_and", "kmp_nib", (region, n - m, t, m), "kmp_")
           for m, t in bt.items()},
    }
    # K9: each wrapper on the composed step and with compare-B's pat_key,
    # under the step path given last (set on each checkout's own module).
    for fn, tag in (("kmp_bsums", "bsums"), ("kmp_nib", "nib")):
        for what, m, step, key in (("composed m=16", 16, "composed", None),
                                   ("composed m=256", 256, "composed", None),
                                   ("compare-B m=16", 16, "perbyte", pat),
                                   ("compare-B composed m=16", 16, "composed", pat)):
            args = (region, n - m, bt[m], m)
            cases[f"K9 {tag} {what}"] = ("shift_and", fn, args, "kmp_", {"pat_key": key}, step)
    # K11d at each cap_g on the groups of K11a's candidates.
    bs_a = swar.screen_cand_nibsums(*sw["K7"])[0]
    for c in (4096, 1024, 2048):
        g8 = this.proto.group_ids(bs_a, c)
        cases[f"K11d cap_g={c}"] = ("swar", "gather_verify", (region, g8, *sw["own"][1:]),
                                    "_kernel")

    def wrapper(port, case):
        mod, fn, *_rest = cases[case]
        return getattr(getattr(port, mod), fn)

    def call(port, case):
        _mod, _fn, args, _event, *opt = cases[case]
        kw, step = opt if opt else ({}, None)
        if step is None:
            return wrapper(port, case)(*args, **kw)
        old, port.shift_and.STEP_PATH = port.shift_and.STEP_PATH, step
        try:
            return wrapper(port, case)(*args, **kw)
        finally:
            port.shift_and.STEP_PATH = old

    def paths_of(port) -> dict:
        """name: (device-resident call, iterations, profiled runs)."""
        cfg = port.config.MatchConfig()
        c2 = cfg.replace(capacity=524288, verify_capacity=524288)
        multi = port.multi.RabinKarpMultiMatcher
        run = lambda mt, t, length: lambda: mt.run(t, length)  # noqa: E731
        bm = lambda c: run(port.algos.BoyerMooreMatcher(pat, c, device=dev),  # noqa: E731
                           padded, n)
        return {
            "Boyer-Moore sparse run": (bm(cfg), 10, 10),
            "Boyer-Moore nib run": (bm(cfg.replace(emission="nib")), 10, 10),
            "Boyer-Moore fused run": (bm(cfg.replace(bm_screen="fused")), 10, 10),
            "naive nib run": (run(port.algos.NaiveMatcher(
                pat, cfg.replace(emission="nib"), device=dev), padded, n), 10, 10),
            "gv_offsets cap_g=4096": (lambda: port.proto.gv_offsets(
                region, n, sw["K7"][2], 16, sw["K7"][4], 4096, cfg.capacity), 10, 10),
            "Rabin-Karp sparse run": (run(port.algos.RabinKarpMatcher(
                pat, cfg, device=dev), padded, n), 10, 10),
            "Rabin-Karp nib run": (run(port.algos.RabinKarpMatcher(
                pat, cfg.replace(emission="nib"), device=dev), padded, n), 10, 10),
            "KMP sparse run": (run(port.algos.KMPMatcher(pat, cfg, device=dev), padded, n),
                               10, 10),
            "KMP nib run": (run(port.algos.KMPMatcher(
                pat, cfg.replace(emission="nib"), device=dev), padded, n), 10, 10),
            "config 2 pselect run": (run(multi(c2_pats, c2, device=dev), big_dev, nb), 3, 3),
            "config 2 groups run": (run(multi(c2_pats, c2.replace(multi_gather="groups"),
                                              device=dev), big_dev, nb), 3, 3),
            "config 2 nib run": (run(multi(c2_pats, c2.replace(emission="nib"), device=dev),
                                     big_dev, nb), 3, 3),
        }

    paths = {port.name: paths_of(port) for port in (this, *others)}

    def same(a, b) -> bool:
        """Tensors, numbers and nested sequences of them equal bit for bit."""
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return a == b

    for o in others:
        for case in cases:
            a, b = call(o, case), call(this, case)
            assert same(a, b), f"{o.name} {case}"
            del a, b
            torch.cuda.empty_cache()
        for path, (f, *_rest) in paths[o.name].items():
            assert same(f(), paths[this.name][path][0]()), f"{o.name} {path}"
            torch.cuda.empty_cache()
        print(f"{roots[o.name]}: every case and path equals {roots[this.name]} bit for bit")

    def turn(port) -> dict:
        out = {}
        for case, (_mod, _fn, _args, event, *_opt) in cases.items():
            f = lambda: call(port, case)  # noqa: E731
            ev = cs.cuda_ms(f, 20)
            d, seen = cs.kernel_device_ms(f, 20, event, wrapper(port, case))
            out[case] = {"device_ms": d, "event_ms": ev, "recorded": seen}
            torch.cuda.empty_cache()
        for path, (f, iters, runs) in paths[port.name].items():
            wall = statistics.median(cs.host_ms(f, iters=iters, passes=3))
            d, events, split = cs.device_profile(f, runs=runs)
            out[path] = {"wall_ms": wall, "device_ms": d, "events": events,
                         "idle": 1 - d / wall, "split": split}
            torch.cuda.empty_cache()
        return out

    results = {}
    for o in others:
        for port in (o, this, this, o):
            r = turn(port)
            results.setdefault(port.name, []).append(r)
            for what, v in r.items():
                split = v.get("split", {})
                print(f"{roots[port.name]} {what}: "
                      + ", ".join(f"{k} {x:.4f}" for k, x in v.items() if k != "split")
                      + "".join(f"; {name[:60]} {x:.4f}" for name, x in split.items())
                      + f" [{smi}]")
    print(smi)
    print(json.dumps({"card": smi, "roots": roots, "turns": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
