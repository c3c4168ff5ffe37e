"""PyTorch port: the kernel build's source hash and its parts
(``ops/_build.py``).

A library's file name carries a hash of its source and of every ``csrc``
header it includes, followed through headers that include others, so a
library built from an older header is never loaded.  ``_source`` only
reads files: these tests run on the CPU, on a copy of ``csrc``.  The
build's plumbing (parts compiled side by side, then linked) runs against
a stand-in for ``nvcc`` that logs its arguments.
"""

import json
import os
import shutil
import sys

import pytest

from neuronx_distributed_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    return str(dst)


def _append(path, text):
    with open(path, "a") as f:
        f.write(text)


def test_copy_hashes_like_the_package(csrc):
    for name in ("flash_attention", "flash_attention_d256", "paged_attention"):
        assert _build._source(name, csrc)[1] == _build._source(name)[1]


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_d256",
                                  "paged_attention"])
def test_nested_header_edit_changes_the_digest(csrc, name):
    """hopper.cuh is included by flash_attention.cuh (and by
    paged_attention_wgmma.cuh), which the library source includes: an
    edit two levels down must rebuild."""
    before = _build._source(name, csrc)[1]
    _append(os.path.join(csrc, "hopper.cuh"), "\n// edited\n")
    assert _build._source(name, csrc)[1] != before


def test_unrelated_edit_keeps_the_digest(csrc):
    """paged_attention.cu does not include the flash kernels' header."""
    before = _build._source("paged_attention", csrc)[1]
    _append(os.path.join(csrc, "flash_attention.cuh"), "\n// edited\n")
    assert _build._source("paged_attention", csrc)[1] == before


def test_include_cycle_ends(csrc):
    with open(os.path.join(csrc, "cyc.cu"), "w") as f:
        f.write('#include "a.cuh"\n')
    with open(os.path.join(csrc, "a.cuh"), "w") as f:
        f.write('#include "b.cuh"\n')
    with open(os.path.join(csrc, "b.cuh"), "w") as f:
        f.write('#include "a.cuh"\n#include "cyc.cu"\n')
    before = _build._source("cyc", csrc)[1]
    _append(os.path.join(csrc, "b.cuh"), "// edited\n")
    assert _build._source("cyc", csrc)[1] != before


FAKE_NVCC = r'''#!{python}
import json, os, sys
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(json.dumps(args) + "\n")
if {fail!r} in args:
    print("error in " + {fail!r})
    sys.exit(2)
if "--time" in args:
    with open(args[args.index("--time") + 1], "w") as f:
        f.write("source file name , phase name , phase input files , "
                "phase output file , arch , tool, metric , unit\n"
                "x.cu , cicc , x.ii , x.ptx , compute_90a , nvcc , 1500 , ms\n")
out = args[args.index("-o") + 1]
with open(out, "w") as f:
    f.write(" ".join(a for a in args if a.endswith(".o")))
print("ptxas info : report of " + " ".join(a for a in args if a.startswith("-D")))
'''


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """``nvcc`` replaced by a script that logs its arguments and writes its
    ``-o`` file (or fails on the argument ``fail``), the build directory
    by a temporary one."""
    def make(fail="never"):
        log = tmp_path / "calls.jsonl"
        script = tmp_path / "nvcc"
        script.write_text(FAKE_NVCC.format(python=sys.executable,
                                            log=str(log), fail=fail))
        script.chmod(0o755)
        monkeypatch.setattr(_build, "find_nvcc", lambda: str(script))
        monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
        monkeypatch.setattr(_build, "build_logs", {})
        return log
    return make


def _calls(log):
    return [json.loads(line) for line in log.read_text().splitlines()]


def test_parts_compile_side_by_side_then_link(fake_nvcc, monkeypatch):
    """A library in PARTS: one ``nvcc -c`` per part, then one link of the
    objects into the library; the parts' reports joined; a library not in
    PARTS: one ``nvcc -shared`` of its source.  No object is left."""
    log = fake_nvcc()
    monkeypatch.delitem(_build.PARTS, "paged_attention")
    paths = _build.build_all(["flash_attention", "paged_attention"])
    calls = _calls(log)
    parts = [c for c in calls if "-c" in c]
    assert sorted(c[c.index("-c") + 1] for c in parts) == \
        sorted(_build.PARTS["flash_attention"])
    assert all(c[-1].endswith("flash_attention.cu") for c in parts)
    links = [c for c in calls if "-shared" in c and "-c" not in c]
    flash_link = [c for c in links if c[-1].endswith(".o")]
    assert len(flash_link) == 1
    assert sorted(flash_link[0][-3:]) == sorted(c[c.index("-o") + 1]
                                                for c in parts)
    paged = [c for c in links if c[-1].endswith("paged_attention.cu")]
    assert len(paged) == 1
    report = _build.build_logs["flash_attention"]
    for flag in _build.PARTS["flash_attention"]:
        assert f"report of {flag}" in report
    build = os.path.dirname(paths["flash_attention"])
    assert sorted(os.listdir(build)) == sorted(
        os.path.basename(p)[:-len(".so")] + ext for p in paths.values()
        for ext in (".so", ".log"))
    # built once: a second call finds both libraries
    assert _build.build_all(["flash_attention", "paged_attention"]) == paths
    assert len(_calls(log)) == len(calls)


@pytest.mark.parametrize("name", sorted(_build.PARTS))
def test_every_part_is_started_before_any_is_waited(fake_nvcc, name):
    """``start_all`` starts every part of every library and returns; a
    library finished alone (``finish_all`` with its name) leaves the
    others' builds running until they are finished in turn."""
    log = fake_nvcc()
    jobs = _build.start_all([name, "paged_attention" if name !=
                             "paged_attention" else "flash_attention"])
    first = _build.finish_all(jobs, [name])
    assert list(first) == [name] and len(jobs) == 1
    rest = _build.finish_all(jobs)
    assert not jobs and len(rest) == 1
    flags = [c[c.index("-c") + 1] for c in _calls(log) if "-c" in c]
    assert set(_build.PARTS[name]) <= set(flags)


def test_stop_all_removes_unfinished_builds(fake_nvcc):
    fake_nvcc()
    jobs = _build.start_all(["flash_attention"])
    _build.stop_all(jobs)
    assert jobs == {}
    assert os.listdir(_build.BUILD_DIR) == []


def test_a_failed_part_fails_its_library(fake_nvcc):
    """A part nvcc refuses fails the build with its report; no library,
    object or temporary file is left."""
    fake_nvcc(fail="-DFLASH_PART=2")
    with pytest.raises(RuntimeError, match="(?s)FLASH_PART=2.*error in"):
        _build.build_all(["flash_attention"])
    assert os.listdir(_build.BUILD_DIR) == []


def test_parts_change_the_digest(monkeypatch):
    before = _build._source("flash_attention")[1]
    monkeypatch.setitem(_build.PARTS, "flash_attention",
                        _build.PARTS["flash_attention"][:2])
    assert _build._source("flash_attention")[1] != before


def test_background_libraries_build_at_a_lower_priority(fake_nvcc):
    """``start_all(background=...)``: those libraries' nvcc run 10 steps
    below this process's priority, the others at it."""
    fake_nvcc()
    jobs = _build.start_all(["flash_attention", "paged_attention"],
                            background=("flash_attention",))
    try:
        own = os.getpriority(os.PRIO_PROCESS, 0)
        for name, want in (("flash_attention", min(own + 10, 19)),
                           ("paged_attention", own)):
            for p in jobs[name][1][0]:
                try:
                    got = os.getpriority(os.PRIO_PROCESS, p.pid)
                except OSError:   # already exited and reaped
                    continue
                assert got == want, name
    finally:
        _build.finish_all(jobs)


def test_build_times_tool_builds_whole_then_in_parts(fake_nvcc):
    """``tools/torch_build_times.py``: one nvcc a source built whole, one
    a part (and a link a library) in parts, each into a directory of its
    own; ``PARTS`` and the build directory are left as they were."""
    sys.path.insert(0, os.path.join(os.path.dirname(_build.CSRC), "..",
                                    "..", "tools"))
    try:
        import torch_build_times as tool
    finally:
        sys.path.pop(0)
    log = fake_nvcc()
    parts, build_dir = dict(_build.PARTS), _build.BUILD_DIR
    whole = tool.build_once("whole")
    n_whole = len(_calls(log))
    tool.build_once("parts")
    n_parts = len(_calls(log)) - n_whole
    assert n_whole == len(_build.SIGNATURES) == len(whole["nvcc"])
    assert n_parts == sum(len(p) + 1 for p in parts.values()) + len(
        set(_build.SIGNATURES) - set(parts))
    assert all(st == {"cicc": 1.5} for st in whole["nvcc"].values())
    assert _build.PARTS == parts and _build.BUILD_DIR == build_dir
    assert not os.path.exists(build_dir)
