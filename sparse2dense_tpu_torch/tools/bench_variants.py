"""Shared runner of the kernel benches (``bench_plane_subm``,
``bench_tile_subm``, ``bench_window_pass``): builds and loads the sources
compared, then times each on each case in turn and holds it against the
case's plain version.

A source is this tree's kernel, or a variant given on the command line as
``name=path``:

- ``path`` a ``.cu`` file: a copy of the kernel's source, compiled as the
  repo's is (``cuda_build.build_all``, the headers of ``csrc/`` on the
  include path) into ``_build/bench/<kernel>/`` and called through this
  tree's wrapper. Ablations go in such copies, never behind a switch in the
  kernel;
- ``path`` a directory: another checkout of the repo (a parent commit
  unpacked by ``git archive``). Its package is imported under a name of its
  own and called through its own wrapper, which builds its own kernels in
  that checkout, so its host-side layouts may differ from this tree's.

Every round times each source on each case, so drift over the call falls on
all alike: CUDA events over ``reps`` launches L2-warm, queued behind a sleep
kernel so that the host's issue is not timed (``microbench.timed``), and the
median of 10 launches L2-cold (``microbench.timed_cold``). Each source's
outputs beyond the case's tolerance are counted. Prints a JSON line per
(case, source) and, for cases that run on a main path, one per source with
the sum over a frame.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from ..ops import cuda_build
from .microbench import timed, timed_cold

PACKAGE = "sparse2dense_tpu_torch"
# name, launches a frame on a main path (0: off every path), call(wrapper
# module) -> output, the plain version's output, tolerance
Case = Tuple[str, int, Callable[[ModuleType], torch.Tensor], torch.Tensor, object]


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("variants", nargs="*",
                    help="name=path: a variant source (.cu) or another checkout (directory)")
    ap.add_argument("--rounds", type=int, default=2)
    return ap


def _checkout_wrapper(root: str, name: str, wrapper: str) -> ModuleType:
    """The wrapper module ``ops.<wrapper>`` of the checkout at ``root``,
    imported as a package of its own (its imports are relative)."""
    pkg_dir = os.path.join(os.path.abspath(root), PACKAGE)
    alias = f"_bench_{name}"
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg_dir, "__init__.py"), submodule_search_locations=[pkg_dir])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{alias}.ops.{wrapper}")


def _print_ptxas(library: str, log: str) -> None:
    print(json.dumps({"built": library, "ptxas": [line for line in log.splitlines()
                                                  if "registers" in line or "spill" in line]}))


def sources(wrapper: ModuleType, variants: Iterable[str], tag: str
            ) -> Dict[str, Tuple[ModuleType, Optional[object]]]:
    """{name: (wrapper module, library or None)} of this tree's kernel and the
    variants, built. ``wrapper`` is this tree's wrapper module (``SOURCE``,
    ``LIBRARY``, ``load``, ``_lib``); a library is set as its ``_lib``
    before each call, None calls another checkout's wrapper as it is."""
    if not torch.cuda.is_available():
        raise SystemExit(f"the {tag} bench needs a CUDA GPU")
    bench_dir = os.path.join(cuda_build.BUILD_DIR, "bench", tag)
    os.makedirs(bench_dir, exist_ok=True)
    named = [("this tree", wrapper.SOURCE, wrapper.LIBRARY)]
    checkouts = {}
    for v in variants:
        name, path = v.split("=", 1)
        if os.path.isdir(path):
            checkouts[name] = _checkout_wrapper(path, name, wrapper.__name__.rsplit(".", 1)[1])
            named.append((name, None, None))
        else:
            named.append((name, os.path.abspath(path), os.path.join(bench_dir, f"lib{name}.so")))
    for library, log in cuda_build.build_all([(s, lib) for _, s, lib in named if s]).items():
        _print_ptxas(library, log)
    for name, mod in checkouts.items():
        _print_ptxas(f"{name}: {mod.LIBRARY}", mod.build())
    return {name: (checkouts[name], None) if source is None else (wrapper, wrapper.load(library))
            for name, source, library in named}


def run(srcs: Dict[str, Tuple[ModuleType, Optional[object]]], cases: Iterable[Case],
        rounds: int, reps: int = 10) -> None:
    """Time and check every source on every case, the sources in turn
    within a round; ``cases`` may be a generator that frees a case's
    tensors before it makes the next."""
    dev = torch.device("cuda")
    frame: Dict[str, Dict[str, float]] = {}
    for name, per_frame, call, want, tol in cases:
        recs = {src: dict(case=name, source=src, ms=[], cold_ms=[], n_bad=0) for src in srcs}
        for _ in range(rounds):
            for src, (mod, lib) in srcs.items():
                if lib is not None:
                    mod._lib = lib
                rec = recs[src]
                bad = int(((call(mod).float() - want).abs() > tol).sum())
                rec["n_bad"] = max(rec["n_bad"], bad)
                rec["ms"].append(timed(lambda i: call(mod), dev, reps=reps, hold=True) * 1e3)
                rec["cold_ms"].append(timed_cold(lambda i: call(mod), dev) * 1e3)
        for src, rec in recs.items():
            print(json.dumps(rec), flush=True)
            if per_frame:
                f = frame.setdefault(src, dict(ms=0.0, cold_ms=0.0))
                for key in f:
                    f[key] += per_frame * sum(rec[key]) / len(rec[key])
        del call, want, tol   # before the generator makes the next case
    for src, f in frame.items():
        print(json.dumps(dict(frame="main-path launches", source=src, **f)), flush=True)
    for mod, lib in srcs.values():
        if lib is not None:
            mod._lib = None
