"""The port's CUDA libraries (softgnss_tpu_torch.track.cuda_lib): which
source each library builds, which module binds each C entry, and the build
key.

The receiver's library (``cuda_lib.RECEIVER``) holds B1-B4 and the
ablations of those kernels that the scripts S1-S3 launch; the probes'
library (``scripts.pallas_probe.PROBE_LIBRARY``) holds S4 and S5 and is
loaded by those two scripts alone.  The CPU tests read the sources and the
declarations; the ``gpu`` test runs the receiver with the probes' library
made unloadable.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_lib.py
"""

import importlib
import pkgutil
import re
import shutil

import numpy as np
import pytest
import torch

import softgnss_tpu_torch as sgt
from softgnss_tpu_torch.scripts.pallas_probe import PROBE_LIBRARY
from softgnss_tpu_torch.track import cuda_lib

torch.set_num_threads(1)

LIBRARIES = {"receiver": cuda_lib.RECEIVER, "probes": PROBE_LIBRARY}
_C_ENTRY = re.compile(r'extern "C" int (sg_\w+)\(')


def _entries_defined(library) -> set:
    return {name for src in library.sources
            for name in _C_ENTRY.findall((cuda_lib.CSRC / src).read_text())}


def _declarations(library) -> list:
    """Every cuda_lib.Entry of ``library`` that a module of the package
    holds, each object once."""
    found = {}
    for info in pkgutil.walk_packages(sgt.__path__, "softgnss_tpu_torch."):
        module = importlib.import_module(info.name)
        for value in vars(module).values():
            if isinstance(value, cuda_lib.Entry) and value.library == library:
                found[id(value)] = value
    return list(found.values())


def test_each_cuda_source_is_in_one_library():
    """The two libraries' sources together are csrc/*.cu, each once."""
    sources = [s for lib in LIBRARIES.values() for s in lib.sources]
    assert sorted(sources) == sorted(p.name for p in cuda_lib.CSRC.glob("*.cu"))
    assert len(set(sources)) == len(sources)


@pytest.mark.parametrize("which", sorted(LIBRARIES))
def test_every_c_entry_is_bound_once(which):
    """Every ``extern "C" int sg_*`` of a library's sources is declared by
    exactly one Entry of that library in the package, and no Entry names
    an entry its sources lack."""
    library = LIBRARIES[which]
    names = [e.name for e in _declarations(library)]
    assert len(names) == len(set(names)), sorted(names)
    assert set(names) == _entries_defined(library)


@pytest.mark.parametrize("edit", ["probe_source_edited", "receiver_source_edited",
                                  "flags_changed"])
def test_library_key(tmp_path, edit):
    """On copies of the sources: editing a probe leaves the receiver
    library's key unchanged; editing one of its own sources, or the
    flags, changes it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, csrc)
    sources = cuda_lib.RECEIVER.sources
    before = cuda_lib.library_key(sources, csrc)
    assert before == cuda_lib.library_key(sources)
    flags = cuda_lib.NVCC_FLAGS
    if edit == "flags_changed":
        flags = tuple(f for f in flags if f != "-fmad=false")
    else:
        lib = PROBE_LIBRARY if edit == "probe_source_edited" else cuda_lib.RECEIVER
        path = csrc / lib.sources[-1]
        path.write_text(path.read_text() + "\n// edited\n")
    after = cuda_lib.library_key(sources, csrc, flags)
    assert (after == before) == (edit == "probe_source_edited")


# --- on the card -------------------------------------------------------------


@pytest.mark.gpu
def test_receiver_runs_without_the_probes_library_on_card(monkeypatch):
    """run_receiver on fast_config, on the card, with the probes' library
    made unloadable: it runs, launches B2 and B1 from the receiver's
    library, and tracks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from softgnss_tpu_torch.pipeline import run_receiver
    from softgnss_tpu_torch.signals.synth import default_scenario
    from softgnss_tpu_torch.track import megakernel as mk

    load = cuda_lib.load_library

    def receiver_only(name, sources):
        if name == PROBE_LIBRARY.name or set(sources) & set(PROBE_LIBRARY.sources):
            raise AssertionError(f"the receiver loaded the probes' library {name}")
        return load(name, sources)

    monkeypatch.setattr(cuda_lib, "load_library", receiver_only)
    cfg = sgt.fast_config(ms_to_process=600)
    _, sig = default_scenario(cfg, device="cuda")
    before = (mk.build_frames.launches, mk.track_block.launches)
    res = run_receiver(cfg, signal=sig, navigate=False, device="cuda")
    torch.cuda.synchronize()
    assert mk.build_frames.launches > before[0] and mk.track_block.launches > before[1]
    assert np.any(res.tracking.i_p != 0)
