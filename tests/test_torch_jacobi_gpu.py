"""The Jacobi eigensolver kernel (``csrc/jacobi.cu``) against the torch
loop it replaces (``ops.jacobi.jacobi_eigh_plain``), on a card, bit for bit.

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernel has no CPU mode; tests/test_torch_geometry.py holds the loop to the
JAX reference and the schedule table to the loop's schedule on the CPU).
The module imports no jax; run it on the card with

    python -m pytest tests/test_torch_jacobi_gpu.py -m gpu --noconftest -q

  * every call the tracking step makes, on the inputs the step builds
    (A^T A of Hartley-normalised constraint rows, F^T F, E^T E, DLT rows);
  * the whole eager step with the kernel against the step with the loop;
  * edge cases: zero, diagonal and tiny off-diagonal matrices, repeated
    eigenvalues (the sort's ties), NaN and inf entries;
  * every n of the kernel's scope, leading batch shapes of any rank and
    strided inputs; one call captured in a CUDA graph and replayed on new
    data; inputs outside the scope refused;
  * the default step graph captures 8 launches.

"Bit for bit": equal bits wherever the loop's result is a number (so -0
and +0 differ), NaN wherever it is NaN.
"""
import numpy as np
import pytest
import torch

import torch_frozen
from vslam_tpu_torch.config import VSLAMConfig
from vslam_tpu_torch.ops import bench_kernels, jacobi
from vslam_tpu_torch.ops.bench_kernels import bits_equal
from vslam_tpu_torch.pipeline import tracker
from vslam_tpu_torch.utils import jit

pytestmark = pytest.mark.gpu

CFG = VSLAMConfig()


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _assert_same(A, sweeps):
    before = jacobi.launches
    w, V = jacobi.jacobi_eigh(A, sweeps)
    assert jacobi.launches == before + 1
    w_p, V_p = jacobi.jacobi_eigh_plain(A, sweeps)
    assert bits_equal(w, w_p), (w, w_p)
    assert bits_equal(V, V_p), (V, V_p)


@pytest.fixture(scope="module")
def step_calls(cuda):
    """The (A, sweeps) of every call RANSAC and both triangulations make,
    recorded while the loop runs them."""
    return bench_kernels.step_eigh_inputs(cuda)


def test_step_calls_are_the_step_shapes(step_calls):
    assert [(tuple(A.shape), s) for A, s in step_calls] \
        == list(jacobi.STEP_CALLS)


@pytest.mark.parametrize("k", range(len(jacobi.STEP_CALLS)))
def test_kernel_matches_loop_at_step_shape(step_calls, k):
    A, sweeps = step_calls[k]
    _assert_same(A, sweeps)


def test_step_with_kernel_equals_step_with_loop(cuda, monkeypatch):
    """Eager default-config steps: every output and the final state equal,
    the kernel launched 8 times a step."""
    frames = torch.from_numpy(torch_frozen.frames(4, 2, CFG)).to(cuda)

    def run():
        st = tracker.bootstrap(frames[0], CFG, cuda, seed=0, rng="torch")
        outs = []
        with jit.disable_jit():
            for f in frames[1:]:
                st, o = tracker.track_step(st, f, CFG)
                outs.append(o)
        return st, outs

    before = jacobi.launches
    st, outs = run()
    assert jacobi.launches - before == 8 * (len(frames) - 1)
    monkeypatch.setattr(jacobi, "jacobi_eigh", jacobi.jacobi_eigh_plain)
    st_p, outs_p = run()
    assert all(bool(o.success) for o in outs_p)               # premise
    for o, o_p in zip(outs, outs_p):
        for name, x, y in zip(o._fields, o, o_p):
            assert torch.equal(x, y), name
    for (name, x), (_, y) in zip(torch_frozen.tensors(st),
                                 torch_frozen.tensors(st_p)):
        assert torch.equal(x, y), name
    assert torch.equal(st.key.get_state(), st_p.key.get_state())


def _edge(name, n, dev):
    rng = np.random.RandomState(n)
    X = rng.randn(16, n + 2, n).astype(np.float32)
    spd = np.einsum("bji,bjk->bik", X, X)
    if name == "zero":
        A = np.zeros((4, n, n), np.float32)
    elif name == "diagonal":
        A = np.stack([np.diag(rng.randn(n)) for _ in range(8)])
    elif name == "tiny_offdiagonal":        # |apq| < 1e-30, denormals too
        A = np.stack([np.diag(rng.randn(n)) for _ in range(8)])
        off = rng.choice([1e-31, -3e-35, 1e-40, 2e-30], (8, n, n))
        A = A + np.triu(off, 1) + np.triu(off, 1).transpose(0, 2, 1)
    elif name == "ties":                    # repeated eigenvalues
        A = np.stack([np.eye(n) * 2, np.diag(np.tile([1.0, -1.0], n)[:n]),
                      np.diag(np.r_[np.zeros(n - 1), -0.0]),
                      -np.eye(n)] + [np.eye(n)] * 4)
    elif name == "nan":
        A = spd.copy()
        A[::3, 0, n - 1] = A[::3, n - 1, 0] = np.nan
        A[1::3, n // 2, n // 2] = np.nan
    elif name == "inf":
        A = spd.copy()
        A[::3, 0, 0] = np.inf
        A[1::3, 0, n - 1] = A[1::3, n - 1, 0] = -np.inf
        A[2::3, n - 1, n - 1] = -np.inf
    return torch.from_numpy(np.asarray(A, np.float32)).to(dev)


@pytest.mark.parametrize("name", ["zero", "diagonal", "tiny_offdiagonal",
                                  "ties", "nan", "inf"])
@pytest.mark.parametrize("n,sweeps", [(3, 10), (4, 7), (9, 4)])
def test_kernel_matches_loop_on_edge_cases(cuda, name, n, sweeps):
    _assert_same(_edge(name, n, cuda), sweeps)


@pytest.mark.parametrize("n", range(2, jacobi.MAX_N + 1))
@pytest.mark.parametrize("lead,sweeps", [((), 8), ((37,), 3), ((2, 5), 1),
                                         ((3,), 0)])
def test_kernel_matches_loop_at_every_n(cuda, n, lead, sweeps):
    g = torch.Generator(device="cpu").manual_seed(n * 31 + len(lead))
    X = torch.randn(lead + (n + 2, n), generator=g)
    _assert_same((X.mT @ X).to(cuda), sweeps)


def test_kernel_reads_strided_inputs(cuda):
    g = torch.Generator(device="cpu").manual_seed(9)
    X = torch.randn((6, 5, 11, 9), generator=g).to(cuda)
    A = X.mT @ X                                         # (6, 5, 9, 9)
    _assert_same(A.transpose(0, 1), 4)                   # batch strides
    _assert_same(A[:, 2], 6)                             # a sliced batch
    _assert_same((A + 0.5 * torch.randn_like(A)).mT, 4)  # unsymmetric, mT
    _assert_same(A[0, 0].expand(7, 9, 9), 4)             # stride 0


def test_kernel_replays_in_a_cuda_graph(cuda):
    g = torch.Generator(device="cpu").manual_seed(4)
    make = lambda: (lambda X: X.mT @ X)(torch.randn((1024, 8, 9),
                                                    generator=g)).to(cuda)
    static = make()
    jacobi.jacobi_eigh(static, 4)                        # the table uploaded
    graph = torch.cuda.CUDAGraph()
    before = jacobi.launches
    with torch.cuda.graph(graph):
        w, V = jacobi.jacobi_eigh(static, 4)
    assert jacobi.launches == before + 1
    for _ in range(2):
        static.copy_(make())
        graph.replay()
        torch.cuda.synchronize()
        w_p, V_p = jacobi.jacobi_eigh_plain(static, 4)
        assert bits_equal(w, w_p) and bits_equal(V, V_p)


def test_kernel_refuses_inputs_outside_its_scope(cuda):
    A = torch.eye(3, device=cuda)
    before = jacobi.launches
    for bad in (A.double(), A.half(), torch.eye(10, device=cuda),
                torch.eye(1, device=cuda), torch.ones((2, 3, 4), device=cuda),
                torch.ones(3, device=cuda)):
        with pytest.raises(ValueError):
            jacobi.jacobi_eigh(bad)
    w, V = jacobi.jacobi_eigh(torch.ones((0, 4, 4), device=cuda))
    assert w.shape == (0, 4) and V.shape == (0, 4, 4)
    assert jacobi.launches == before


def test_default_step_graph_captures_8_launches(cuda):
    from vslam_tpu_torch.pipeline.slam import SLAMSystem
    frames = torch.from_numpy(torch_frozen.frames(3, 2, CFG)).to(cuda)
    s = SLAMSystem(CFG, cuda)
    for f in frames:
        s.process(f)
    assert s.step_graph.replays == len(frames) - 1
    assert s.step_graph.captured_launches["jacobi"] == 8
