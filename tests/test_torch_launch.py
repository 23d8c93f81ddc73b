"""The launch layer of the port's CUDA kernels on the CPU
(``iterativesolvers_tpu_torch/ops/_launch.py``): the C signatures read from
the ``extern "C"`` prototypes of ``csrc/*.cu``, the library every wrapper
module loads through it, the alignment test, the checked launch and query,
and the constants and limits the kernels share with Python.

The kernels run only on a card (``tests/test_torch_gpu.py`` loads every
library there); here a stub stands in for the loaded library.
"""

import ctypes
import re
import types

import pytest
import torch

from iterativesolvers_tpu_torch.ops import _build, _launch

SOURCES = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
WRAPPERS = ["cuda_stencil", "cuda_spmv", "cuda_cg", "cuda_mgs",
            "cuda_arnoldi", "cuda_panel_ortho", "cuda_rbic"]
MAPPED = {ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong}


@pytest.mark.parametrize("name", SOURCES)
def test_every_extern_c_entry_is_parsed(name):
    """Each ``extern "C"`` of the source yields an ``its_*`` entry (none
    missed by the parser), whose every parameter maps to a ctypes type, and
    the pointer count matches the prototype's."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    protos = _launch.prototypes(name)
    assert len(protos) == src.count('extern "C"') > 0
    for entry, argtypes in protos.items():
        assert entry.startswith("its_")
        assert set(argtypes) <= MAPPED
        params = re.search(rf"\b{entry}\s*\(([^)]*)\)", src).group(1)
        assert argtypes.count(ctypes.c_void_p) == sum(
            "*" in p for p in params.split(","))


@pytest.fixture
def fresh_prototypes():
    _launch.prototypes.cache_clear()
    yield
    _launch.prototypes.cache_clear()


def test_prototype_types_map(monkeypatch, tmp_path, fresh_prototypes):
    """A pointer of any kind as ``c_void_p``, ``int`` and ``long long`` (of
    either constness) as themselves, and no parameters as none."""
    (tmp_path / "probe.cu").write_text(
        '// extern "C" in a comment is not a prototype\n'
        'extern "C" int its_a(const void* const* p, unsigned* t,\n'
        '                     const int n, long long m, float* f) {}\n'
        'extern "C" int its_b() { return 0; }\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    protos = _launch.prototypes("probe")
    assert protos == {"its_a": [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_longlong,
                                ctypes.c_void_p],
                      "its_b": []}


@pytest.mark.parametrize("text, what", [
    ('extern "C" int its_a(float x) {}', "float x"),
    ('extern "C" int its_a(size_t n) {}', "size_t n"),
    ('extern "C" void its_a(int n) {}', "returns 'void'"),
])
def test_prototype_outside_the_map_raises(monkeypatch, tmp_path,
                                          fresh_prototypes, text, what):
    (tmp_path / "probe.cu").write_text(text)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    with pytest.raises(TypeError, match=re.escape(what)):
        _launch.prototypes("probe")


class _StubLibrary:
    """A loaded library's stand-in: each attribute a bare namespace that
    takes ``restype`` and ``argtypes``."""

    def __init__(self):
        self.entries = {}

    def __getattr__(self, name):
        if name.startswith("its_"):
            return self.entries.setdefault(name, types.SimpleNamespace())
        raise AttributeError(name)


@pytest.mark.parametrize("module", WRAPPERS)
def test_each_wrapper_module_calls_only_declared_entries(monkeypatch, module):
    """Through a stub ``_build.load``, every library a wrapper module loads
    (``library("...")`` in its source) gets its entries' ``argtypes`` from
    the prototypes, and every ``its_*`` entry the module calls is one of
    them."""
    src = (_build.CSRC.parent / "ops" / f"{module}.py").read_text()
    names = set(re.findall(r'library\("(\w+)"\)', src))
    called = set(re.findall(r"\.(its_\w+)", src))
    assert names and called
    stubs = {}
    monkeypatch.setattr(_build, "load",
                        lambda name: stubs.setdefault(name, _StubLibrary()))
    _launch.library.cache_clear()
    try:
        for name in names:
            lib = _launch.library(name)
            assert lib is stubs[name]
            protos = _launch.prototypes(name)
            assert set(lib.entries) == set(protos)
            for entry, fn in lib.entries.items():
                assert fn.restype is ctypes.c_int
                assert fn.argtypes == protos[entry]
    finally:
        _launch.library.cache_clear()
    declared = set().union(*(stubs[name].entries for name in names))
    assert called <= declared, called - declared


@pytest.mark.parametrize("items, want", [
    ((0, 16, 4096), 1),
    ((16, 8), 0),
    ((4,), 0),
    ((), 1),
])
def test_aligned_on_addresses(items, want):
    assert _launch.aligned(*items) == want


def test_aligned_on_tensors_and_addresses():
    x = torch.zeros(64)
    assert x.data_ptr() % _launch.VEC_BYTES == 0
    assert _launch.aligned(x, x[4:]) == 1
    assert _launch.aligned(x, x[1:]) == 0
    assert _launch.aligned(x, x[8:].data_ptr()) == 1
    assert _launch.aligned(x[4:].data_ptr() + 2) == 0


@pytest.fixture
def on_card_zero(monkeypatch):
    """The current device is card 0 (no card is touched: the calls below
    are stubs)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return torch.device("cuda", 0)


def test_launch_passes_the_arguments_and_checks_the_code(on_card_zero):
    seen = []

    def entry(*args):
        seen.append(args)
        return 0

    assert _launch.launch(entry, 1, None, 3, device=on_card_zero,
                          what="probe") is None
    assert seen == [(1, None, 3)]


@pytest.mark.parametrize("code", [1, -1, 700])
def test_launch_raises_on_a_nonzero_code(on_card_zero, code):
    with pytest.raises(RuntimeError,
                       match=rf"probe kernel launch failed \(error {code}\)"):
        _launch.launch(lambda *a: code, 1, 2, device=on_card_zero,
                       what="probe")


def _query_entry(code):
    """A C function ``int f(int a, int* out)`` writing 2a."""
    def body(a, out):
        out[0] = 2 * a
        return code

    fn = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int))(body)
    fn.__name__ = "its_probe_query"
    return fn


def test_query_returns_what_the_entry_writes(on_card_zero):
    assert _launch.query(_query_entry(0), 21, device=on_card_zero) == 42


def test_query_raises_on_a_nonzero_code(on_card_zero):
    with pytest.raises(RuntimeError,
                       match=r"its_probe_query failed \(error -2\)"):
        _launch.query(_query_entry(-2), 21, device=on_card_zero)


@pytest.mark.parametrize("blocks, n, rows, want", [
    (8, 10**9, 8, 8 * 132),          # as many as the SMs hold
    (8, 3000, 8, 2),                 # fewer where n needs fewer
    (0, 10**9, 4, 132),              # at least one a SM
    (4, 1, 4, 1),
])
def test_grid_for(monkeypatch, blocks, n, rows, want):
    monkeypatch.setattr(_launch, "_sm_count", lambda device: 132)
    assert _launch.grid_for(blocks, torch.device("cpu"), n, rows) == want


def test_dot_ticket_is_one_zero_counter_per_device_and_stream():
    cpu = torch.device("cpu")
    a = _launch.dot_ticket(cpu, 0)
    assert a.dtype == torch.int32 and a.tolist() == [0]
    assert _launch.dot_ticket(cpu, 0) is a
    assert _launch.dot_ticket(cpu, 1) is not a


def test_check_out():
    x = torch.zeros(8)
    out = torch.empty(8)
    assert _launch.check_out(out, x) is out
    for bad in (torch.empty(7), torch.empty(8, dtype=torch.float64),
                torch.empty(16)[::2]):
        with pytest.raises(ValueError, match="contiguous tensor like x"):
            _launch.check_out(bad, x)


def test_max_rows_leaves_the_index_slack():
    for span in (0, 1, 46_656):
        assert (_launch.max_rows(span) + span + _launch.INDEX_SLACK
                == 2**31 - 1)


@pytest.mark.parametrize("dtype, rows", [(torch.float32, 4),
                                         (torch.bfloat16, 8),
                                         (torch.int8, 16)])
def test_run_rows_are_one_16_byte_vector(dtype, rows):
    assert _launch.run_rows(dtype) == rows
    assert rows * torch.empty((), dtype=dtype).element_size() == 16


@pytest.mark.parametrize("name, attr", [("kVecBytes", "VEC_BYTES"),
                                        ("kThreads", "THREADS")])
def test_constants_match_common_cuh(name, attr):
    """The vector width and the threads a block, which Python and
    ``csrc/common.cuh`` share."""
    common = (_build.CSRC / "common.cuh").read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", common)
    assert m is not None, name
    assert int(m.group(1)) == getattr(_launch, attr)
