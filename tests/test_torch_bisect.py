"""The bisect probes (``radegs_torch/ops/bisect.py``) against the JAX
package's four Pallas probe kernels (``scripts/_kernel_bisect.py``) run in
interpret mode on the CPU, on the script's own start / count and two seeded
sets (an empty step, unaligned starts, a window ending on the last column),
on the long-run set (steps of 0, 1, 3, 4, 5 and 64 windows in a (25, 8192)
matrix: the run lengths the ``window`` kernel's ring meets) and, for
``tri_mm``, ``aligned`` and ``mm_highest``, on more seeded matrices (for the
last two also one of entries near +-1e4, whose sums cancel, and NaN / Inf
placed in and outside the rows each reads). ``mm_highest`` is also held to
the identity its kernel computes: 8 dot products ``f[i, :128] . f[0, :128]``
broadcast over columns and steps.

The script is loaded with ``ast``: its four module-level ``run(...)`` calls
are dropped, and its grid spec is taken from the ``grid_spec = ...``
statement of ``run`` (evaluated with the grid's T set to the number of
steps), so the kernels run with the script's own spec. Tolerance: abs 1e-5
x the sum of |terms| of each output (per step for the window sums; the
largest row's |products| for ``mm_highest``).

The ``cuda``-marked tests hold the kernels to the plain versions on the
card; the file imports JAX only inside the fixture and helper that run the
Pallas kernels, so those tests also run where JAX is missing::

    python -m pytest --noconftest -q -m cuda tests/test_torch_bisect.py
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from radegs_torch.ops import bisect
from radegs_torch.scripts import kernel_bisect as kb

torch.set_num_threads(1)
SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "_kernel_bisect.py"
KERNELS = {"aligned": "k_aligned", "window": "k_window", "mm_highest": "k_mm_highest",
           "tri_mm": "k_tri_mm"}
SETS = [(kb.START, kb.COUNT), kb.seeded_set(1), kb.seeded_set(2)]
REL = 1e-5
# the long-run set: steps of 0, 1, 3, 4, 5 and 64 windows (a ring of 3 or 4
# windows, one more, and many refills); the 64-window step starts unaligned
# and ends on the last column
LONG_B = 8192
LONG_START = [1000, 300, 1100, 2100, 4000, 5]
LONG_COUNT = [0, 50, 300, 400, 600, 8187]


def long_inputs(device):
    """The long-run set's operands on ``device`` (feat seeded as the script's)."""
    feat = np.random.default_rng(0).normal(size=(25, LONG_B)).astype(np.float32)
    return (torch.tensor(LONG_START, dtype=torch.int32, device=device),
            torch.tensor(LONG_COUNT, dtype=torch.int32, device=device),
            torch.from_numpy(feat).to(device))


@pytest.fixture(scope="module")
def script():
    """The script's namespace (without its run(...) calls) and the compiled
    expression of its grid spec."""
    tree = ast.parse(SCRIPT.read_text(), filename=str(SCRIPT))
    tree.body = [n for n in tree.body
                 if not (isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
                         and getattr(n.value.func, "id", None) == "run")]
    ns = {}
    exec(compile(tree, str(SCRIPT), "exec"), ns)
    run = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run")
    assign = next(n for n in ast.walk(run) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "grid_spec")
    expr = ast.fix_missing_locations(ast.Expression(assign.value))
    return ns, compile(expr, str(SCRIPT), "eval")


def jax_probe(script, probe, start, count, feat):
    """The script's kernel over a grid of len(start) steps, in interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    ns, spec = script
    T = len(start)
    grid_spec = eval(spec, {**ns, "T": T})
    return np.asarray(pl.pallas_call(
        ns[KERNELS[probe]], out_shape=jax.ShapeDtypeStruct((T, 8, 256), jnp.float32),
        grid_spec=grid_spec, interpret=True)(jnp.asarray(start, jnp.int32),
                                             jnp.asarray(count, jnp.int32), jnp.asarray(feat)))


def tolerance(probe, start, count, feat):
    """abs 1e-5 x sum |terms| of every output, broadcast to (T, 8, 256)."""
    a = np.abs(feat)
    T = len(start)
    if probe == "aligned":
        tol = np.full(T, a[:, :128].sum())
    elif probe == "window":
        tol = bisect.window_torch(torch.tensor(start), torch.tensor(count),
                                  torch.from_numpy(a))[:, 0, 0].numpy()
    elif probe == "tri_mm":
        return REL * np.broadcast_to(np.cumsum(a[0, :8])[None, :, None], (T, 8, 256))
    else:
        return REL * np.broadcast_to((a[:8, :128] * a[0, :128]).sum(1)[None, :, None],
                                     (T, 8, 256))
    return REL * np.broadcast_to(tol[:, None, None], (T, 8, 256))


@pytest.mark.parametrize("probe", list(KERNELS))
@pytest.mark.parametrize("case", range(len(SETS)))
def test_plain_probe_matches_pallas_interpret(script, probe, case):
    start, count = SETS[case]
    t_start, t_count, t_feat = kb.inputs("cpu", start, count)
    feat = t_feat.numpy()
    want = jax_probe(script, probe, start, count, feat)
    got = bisect.PLAIN[probe](t_start, t_count, t_feat).numpy()
    assert got.shape == want.shape == (4, 8, 256)
    assert (np.abs(got - want) <= tolerance(probe, start, count, feat)).all()
    if probe == "window" and case > 0:
        assert 0 in count and any(s % 128 for s in start)
        assert any(s + c == kb.B for s, c in zip(start, count))


@pytest.mark.parametrize("probe", list(KERNELS))
def test_plain_probe_matches_pallas_interpret_on_long_runs(script, probe):
    t_start, t_count, t_feat = long_inputs("cpu")
    feat = t_feat.numpy()
    want = jax_probe(script, probe, LONG_START, LONG_COUNT, feat)
    got = bisect.PLAIN[probe](t_start, t_count, t_feat).numpy()
    assert got.shape == want.shape == (6, 8, 256)
    assert (np.abs(got - want) <= tolerance(probe, LONG_START, LONG_COUNT, feat)).all()


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_tri_mm_matches_pallas_interpret_on_more_matrices(script, seed):
    t_start, t_count, t_feat = kb.inputs("cpu", seed=seed)
    feat = t_feat.numpy()
    want = jax_probe(script, "tri_mm", kb.START, kb.COUNT, feat)
    got = bisect.tri_mm_torch(t_start, t_count, t_feat).numpy()
    assert (np.abs(got - want) <= tolerance("tri_mm", kb.START, kb.COUNT, feat)).all()


# matrices for aligned and mm_highest: seeded normals, and entries near +-1e4
# of mixed signs (sums that cancel to a small fraction of their |terms|)
MATRICES = [3, 4, "1e4"]
# NaN / Inf placed at (row, column) of feat: in row 0 (every product row), in
# a product row, in a row only aligned reads, past column 127 (read by
# neither), +Inf in a product row, and +-Inf in two (NaN for aligned)
NONFINITE = [
    [(0, 7, np.nan)], [(3, 5, np.nan)], [(12, 9, np.nan)], [(4, 200, np.nan)],
    [(6, 3, np.inf)], [(2, 1, np.inf), (5, 6, -np.inf)],
]


def matrix(kind, B=kb.B):
    """A (25, B) float32 feature matrix: seeded normals for an int, else
    +-1e4 (1 + u), u ~ U(0, 1e-3), with seeded signs."""
    if kind != "1e4":
        return np.random.default_rng(kind).normal(size=(25, B)).astype(np.float32)
    rng = np.random.default_rng(5)
    sign = rng.choice([-1.0, 1.0], size=(25, B))
    return (sign * 1e4 * (1.0 + rng.uniform(0.0, 1e-3, size=(25, B)))).astype(np.float32)


def with_nonfinite(feat, places):
    feat = feat.copy()
    for r, c, v in places:
        feat[r, c] = v
    return feat


def nonfinite_matches(got, want):
    """NaN on the same outputs, and the same +-Inf on the same outputs."""
    return (np.array_equal(np.isnan(got), np.isnan(want))
            and np.array_equal(np.isposinf(got), np.isposinf(want))
            and np.array_equal(np.isneginf(got), np.isneginf(want)))


@pytest.mark.parametrize("kind", MATRICES)
@pytest.mark.parametrize("probe", ["aligned", "mm_highest"])
def test_plain_sum_and_product_match_pallas_interpret_on_more_matrices(script, probe, kind):
    feat = matrix(kind)
    if kind == "1e4":  # the sums cancel: |sum| well below the sum of |terms|
        assert abs(float(feat[:, :128].astype(np.float64).sum())) < 0.1 * 3200 * 1e4
    want = jax_probe(script, probe, kb.START, kb.COUNT, feat)
    got = bisect.PLAIN[probe](*kb.inputs("cpu")[:2], torch.from_numpy(feat)).numpy()
    assert got.shape == want.shape == (4, 8, 256)
    assert (np.abs(got - want) <= tolerance(probe, kb.START, kb.COUNT, feat)).all()


@pytest.mark.parametrize("kind", MATRICES)
def test_mm_highest_is_eight_dot_products_broadcast(script, kind):
    feat = matrix(kind)
    f = feat[:, :128].astype(np.float64)
    dots = f[:8] @ f[0]  # R[i, j] = f[i, :128] . f[0, :128] for every j
    want = np.broadcast_to(dots[None, :, None], (4, 8, 256))
    got = jax_probe(script, "mm_highest", kb.START, kb.COUNT, feat)
    assert (np.abs(got - want) <= tolerance("mm_highest", kb.START, kb.COUNT, feat)).all()


@pytest.mark.parametrize("case", range(len(NONFINITE)))
@pytest.mark.parametrize("probe", ["aligned", "mm_highest"])
def test_plain_sum_and_product_put_nan_and_inf_where_pallas_interpret_does(script, probe,
                                                                           case):
    feat = with_nonfinite(matrix(3), NONFINITE[case])
    want = jax_probe(script, probe, kb.START, kb.COUNT, feat)
    got = bisect.PLAIN[probe](*kb.inputs("cpu")[:2], torch.from_numpy(feat)).numpy()
    assert nonfinite_matches(got, want)
    fin = np.isfinite(want)
    tol = tolerance(probe, kb.START, kb.COUNT, np.nan_to_num(feat, posinf=0, neginf=0))
    assert (np.abs(got[fin] - want[fin]) <= tol[fin]).all()


def test_long_run_set_covers_the_ring():
    start, count, _ = long_inputs("cpu")
    start_al, n = bisect.window_bounds(start, count)
    assert n.tolist() == [0, 1, 3, 4, 5, 64]
    assert int((start_al + n * 128).max()) == LONG_B and int(start[-1]) % 128 != 0


def test_seeded_sets_cover_the_edges():
    for start, count in SETS[1:]:
        start_al, n = bisect.window_bounds(torch.tensor(start), torch.tensor(count))
        assert int(n[0]) == 0 and int((start_al + n * 128).max()) == kb.B
        assert all(0 <= s and s + c <= kb.B for s, c in zip(start, count))


def test_wrappers_on_cpu_run_the_plain_versions_and_count_nothing():
    bisect.reset_launches()
    start, count, feat = kb.inputs("cpu")
    for probe in bisect.PROBES:
        assert torch.equal(bisect.WRAPPERS[probe](start, count, feat),
                           bisect.PLAIN[probe](start, count, feat))
    assert all(v == 0 for v in bisect.LAUNCHES.values())


def test_kernel_bisect_cli_on_cpu(capsys):
    assert kb.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[1].strip() for ln in lines] == ["OK"] * 4


def test_pad_columns_and_window_bounds():
    feat = torch.ones((25, 300))
    padded = bisect.pad_columns(feat)
    assert padded.shape == (25, 384) and float(padded[:, 300:].abs().sum()) == 0.0
    start_al, n = bisect.window_bounds(torch.tensor([0, 127, 128, 5]),
                                       torch.tensor([1, 2, 128, 0]))
    assert start_al.tolist() == [0, 0, 128, 0] and n.tolist() == [1, 2, 1, 0]


OUTSIDE = ([0, -5, 1000, 900], [10, 3, 100, 0])  # ok, negative start, past the end, empty


def test_window_steps_outside_the_matrix_are_nan():
    start, count, feat = kb.inputs("cpu", *OUTSIDE)
    out = bisect.window(start, count, feat)
    assert torch.isnan(out[1:3]).all() and torch.isfinite(out[[0, 3]]).all()
    assert float(out[0, 0, 0]) == pytest.approx(float(feat[:, :128].sum()), rel=1e-6)
    assert float(out[3].abs().max()) == 0.0


@pytest.mark.cuda
def test_window_kernel_writes_nan_outside_the_matrix():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    start, count, feat = kb.inputs("cuda", *OUTSIDE)
    out = bisect.window(start, count, feat)
    plain = bisect.window_torch(start, count, feat)
    assert torch.equal(torch.isnan(out), torch.isnan(plain))
    assert (out[[0, 3]] - plain[[0, 3]]).abs().max() <= 1e-5 * float(feat[:, :128].abs().sum())


@pytest.mark.cuda
def test_probe_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for start, count in SETS:
        s, c, f = kb.inputs("cuda", start, count)
        for probe in bisect.PROBES:
            err, tol, out = kb.check(probe, s, c, f)
            assert err <= tol, (probe, err, tol)
            assert torch.equal(out, bisect.WRAPPERS[probe](s, c, f))


@pytest.mark.cuda
def test_ring_and_scan_kernels_match_plain_on_the_long_run_set():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    start, count, feat = long_inputs("cuda")
    for probe in ("window", "tri_mm"):
        out = bisect.WRAPPERS[probe](start, count, feat)
        assert torch.equal(out, bisect.WRAPPERS[probe](start, count, feat))
        tol = tolerance(probe, LONG_START, LONG_COUNT, feat.cpu().numpy())
        err = (out - bisect.PLAIN[probe](start, count, feat)).abs().cpu().numpy()
        assert (err <= tol).all(), (probe, float(err.max()))


@pytest.mark.cuda
def test_ring_kernel_nan_steps_are_bitwise_stable():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    start, count, feat = kb.inputs("cuda", *OUTSIDE)
    out = bisect.window(start, count, feat)
    again = bisect.window(start, count, feat)
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    assert torch.equal(torch.isnan(out), torch.isnan(bisect.window_torch(start, count, feat)))


@pytest.mark.cuda
def test_sum_and_product_kernels_match_plain_at_every_width():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for B in (128, 8192):
        for kind in MATRICES:
            feat = torch.from_numpy(matrix(kind, B)).cuda()
            for T in (1, 4, 64):
                start = torch.zeros(T, dtype=torch.int32, device="cuda")
                count = torch.full((T,), 100, dtype=torch.int32, device="cuda")
                for probe in ("aligned", "mm_highest"):
                    out = bisect.WRAPPERS[probe](start, count, feat)
                    again = bisect.WRAPPERS[probe](start, count, feat)
                    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
                    tol = tolerance(probe, [0] * T, [100] * T, feat.cpu().numpy())
                    err = (out - bisect.PLAIN[probe](start, count, feat)).abs().cpu().numpy()
                    assert (err <= tol).all(), (probe, B, kind, T, float(err.max()))


@pytest.mark.cuda
def test_sum_and_product_kernels_put_nan_and_inf_where_plain_does():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    start, count, _ = kb.inputs("cuda")
    for places in NONFINITE:
        feat = torch.from_numpy(with_nonfinite(matrix(3), places)).cuda()
        for probe in ("aligned", "mm_highest"):
            out = bisect.WRAPPERS[probe](start, count, feat)
            again = bisect.WRAPPERS[probe](start, count, feat)
            assert torch.equal(out.view(torch.int32), again.view(torch.int32))
            plain = bisect.PLAIN[probe](start, count, feat).cpu().numpy()
            assert nonfinite_matches(out.cpu().numpy(), plain), (probe, places)
