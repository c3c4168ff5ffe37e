"""PyTorch port: the kernel build's source hash (``ops/_build.py``).

A library's file name carries a hash of its source and of every ``csrc``
header it includes, followed through headers that include others, so a
library built from an older header is never loaded.  ``_source`` only
reads files: these tests run on the CPU, on a copy of ``csrc``.
"""

import os
import shutil

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
