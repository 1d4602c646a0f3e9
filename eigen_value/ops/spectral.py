"""Spectral diagnostics and refinement around the solver.

Capabilities the reference has no analog for (its only outputs are
``(λ, v, ms, rounds)``, wrapper/python/similarity_transform.py:42-78),
each falling out of the functional design:

* :func:`operator_residual` — the ``A·v ≈ λ·v`` acceptance check of the
  reference's wrapper test (wrapper/python/test.py:15-16), generalized to
  matrix-free operators (api.eigen_residual covers the dense case).
* :func:`convergence_report` — the per-round λ history recorded by
  :func:`..solver_matvec.solve_matvec_traced` exposes the method's
  asymptotics: λ_k − λ converges geometrically with ratio
  r = |λ₂/λ₁| (the similarity-transform method IS renormalized power
  iteration, solver_matvec.py module docstring), so successive history
  deltas estimate the subdominant-eigenvalue ratio, digits gained per
  round, and rounds remaining to any tolerance — at zero extra compute.
* :func:`refine_eigenpair` — float64 host-side polish of a converged
  float32 solve.  The device does the O(n²·rounds) work in fast f32/bf16;
  a handful of O(n²) float64 power-form rounds on the host then buy
  oracle-grade accuracy (the sequential reference oracle is f64,
  main.py:63) without ever paying f64 traffic on the device.  Each
  round multiplies the error by r, so ``max_rounds=20`` reaches f64
  round-off from any 1e-3-converged start unless the spectral gap is
  tiny — and the returned ``spread``/``residual`` report exactly what
  was achieved.
* :func:`power_eigenpair` / :func:`subdominant_eigenpair` /
  :func:`top_k_eigenpairs` — classic normalized power iteration for
  general SYMMETRIC operators (on device, jittable, no positivity
  assumed), the second eigenpair via Hotelling deflation of the
  (refined) dominant pair, and the k-pair generalization by successive
  deflation.  Together they turn :func:`convergence_report`'s rate
  ESTIMATE into a measured spectral gap |λ₂/λ₁| (and full gap profile).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def _dot(a, b):
    """A device product at full f32 precision: a GPU may otherwise run it
    in TF32 (~3 decimal digits), far coarser than these solvers' eps."""
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


def operator_residual(matvec, result) -> jnp.ndarray:
    """``max |A·v − λ·v|`` for a matrix-free operator — the eigen-pair
    acceptance check (reference wrapper/python/test.py:15-16, atol 1e-3)
    when only a matvec exists.  Jittable."""
    v = result.eigenvector
    return jnp.max(jnp.abs(matvec(v) - result.eigenvalue * v))


class ConvergenceReport(NamedTuple):
    """Asymptotics extracted from a per-round λ history (host floats)."""

    rate: float  # estimated |λ₂/λ₁| ∈ (0, 1); nan if history too short
    digits_per_round: float  # −log10(rate)
    lam_error_estimate: float  # |λ_final − λ_∞| ≈ |last Δ|·rate/(1−rate)
    deltas_used: int  # successive-delta ratios the estimate averaged


def convergence_report(lam_history, rounds: int) -> ConvergenceReport:
    """Estimate the convergence rate (≈ the subdominant eigenvalue ratio
    |λ₂/λ₁|) from the λ-per-round history of
    :func:`..solver_matvec.solve_matvec_traced`.

    λ_k − λ_∞ ≈ C·rᵏ with r = λ₂/λ₁ ⇒ the ratio of successive deltas
    Δ_k = λ_{k+1} − λ_k estimates r; |r| is reported.  A NEGATIVE λ₂
    alternates the delta signs (q < 0) — |q| still estimates |λ₂/λ₁|, so
    both signs are accepted (for the alternating case the
    ``lam_error_estimate`` bound |Δ|·r/(1−r) is conservative: the true
    remaining error is ≈ |Δ|·r/(1+r)).  The geometric mean over the
    usable tail is returned; ratios from deltas at round-off scale
    (|Δ| ≤ 100·eps·λ, with eps taken from the HISTORY's dtype — an f64
    traced solve keeps its deeper usable tail) are excluded.  Works on
    any geometric tail, including cap-exhausted runs.  Histories passed
    as plain Python lists are assumed f32-origin (the solver's parity
    dtype); pass the solver's own array to get its dtype's floor.
    """
    in_dtype = getattr(lam_history, "dtype", None)
    hist_eps = (
        float(np.finfo(in_dtype).eps)
        if in_dtype is not None and np.issubdtype(in_dtype, np.floating)
        else float(np.finfo(np.float32).eps)
    )
    hist = np.asarray(lam_history, np.float64)[: int(rounds) + 1]
    if hist.size < 3:
        return ConvergenceReport(float("nan"), float("nan"), float("nan"), 0)
    deltas = np.diff(hist)
    scale = max(abs(float(hist[-1])), 1e-30)
    floor = 100 * hist_eps * scale
    ratios = []
    for k in range(len(deltas) - 1):
        if abs(deltas[k]) > floor and abs(deltas[k + 1]) > floor:
            q = deltas[k + 1] / deltas[k]
            # geometric decay toward λ∞ (|q| < 1); q < 0 = alternating
            # convergence (negative λ₂); |q| ≥ 1 transients excluded
            if 0 < abs(q) < 1:
                ratios.append(abs(q))
    if not ratios:
        return ConvergenceReport(float("nan"), float("nan"), float("nan"), 0)
    ratios = ratios[-5:]  # the tail is the asymptote; early rounds carry
    # transients from the non-dominant spectrum
    rate = float(np.exp(np.mean(np.log(ratios))))
    last = abs(float(deltas[-1]))
    err = last * rate / (1.0 - rate) if rate < 1 else float("inf")
    return ConvergenceReport(rate, float(-np.log10(rate)), err, len(ratios))


class RefinedPair(NamedTuple):
    eigenvalue: float  # float64 λ estimate (v[0] readout, parity semantics)
    eigenvector: np.ndarray  # float64, max-normalized like the solver's
    rounds: int  # extra f64 rounds actually run
    spread: float  # (max v − min v)/λ of the last round — the stop measure
    residual: float  # max |A·v − λ·v| of the returned pair, float64


def refine_eigenpair(
    A, result, max_rounds: int = 50, tol: float = 1e-12
) -> RefinedPair:
    """Polish a converged solve to float64 accuracy with a few host-side
    power-form rounds (module docstring).

    ``A`` is the dense matrix (anything ``np.asarray`` accepts) or a
    CALLABLE float64 matvec for matrix-free operators.  ``result`` is the
    :class:`..solver.SolveResult` (or anything with ``eigenvector``) whose
    vector seeds the iteration — starting from the converged f32 vector,
    each round shrinks the remaining error by |λ₂/λ₁|.

    Stops when the row-sum spread (max−min)/λ — the same equalization
    measure as the solver's stop check, but relative — falls below
    ``tol``, stops improving (the f64 round-off floor, ~n·2⁻⁵²·λ, sits
    above any fixed tol for large n), or after ``max_rounds``.  Returns
    float64 (λ, v) plus the
    achieved spread and residual so callers can SEE what was achieved
    rather than trust a flag.  Host NumPy on purpose: no jax x64 global,
    no f64 HBM traffic; a round is one O(n²) host matmul (~ms at 8192²).
    """
    matvec = A if callable(A) else np.asarray(A, np.float64).__matmul__
    q = np.asarray(result.eigenvector, np.float64)
    if not np.all(np.isfinite(q)) or np.any(q <= 0):
        raise ValueError(
            "seed eigenvector must be finite and positive — refine polishes "
            "a CONVERGED solve (check result.converged)"
        )
    lam = float("nan")
    spread = float("inf")
    k = 0
    for k in range(1, max_rounds + 1):
        y = matvec(q)
        v = y / q
        lam = float(v[0])
        prev_spread, spread = spread, float((v.max() - v.min()) / abs(lam))
        q = q * (v / v.max())
        if spread < tol or spread >= prev_spread:  # done, or round-off floor
            break
    vhat = q / q.max()
    residual = float(np.max(np.abs(matvec(vhat) - lam * vhat)))
    return RefinedPair(lam, vhat, k, spread, residual)


class PowerResult(NamedTuple):
    """Eigenpair from :func:`power_eigenpair` (traced arrays)."""

    eigenvalue: "jnp.ndarray"  # Rayleigh quotient of the returned vector
    eigenvector: "jnp.ndarray"  # unit 2-norm
    rounds: "jnp.ndarray"  # matvecs spent inside the loop (int32)
    converged: "jnp.ndarray"  # residual ≤ eps·|λ| reached before the cap
    residual: "jnp.ndarray"  # ‖A·v − λ·v‖₂ of the returned pair


def power_eigenpair(
    matvec, n: int, eps: float = 1e-6, max_itr: int = 1000, x0=None,
    dtype=jnp.float32,
) -> PowerResult:
    """CLASSIC normalized power iteration — the general-operator sibling
    of the similarity-transform solver, with no positivity assumption.

    Converges to the largest-|λ| eigenpair of a SYMMETRIC operator
    (λ may be negative — the iterate's alternating sign cancels in the
    Rayleigh quotient), at rate |λ_sub/λ_dom| per round; it stalls when
    the two largest magnitudes tie.  The similarity-transform solver
    remains the production path for positive matrices (same asymptotics,
    plus the reference's exact round-count semantics); this entry exists
    for operators OUTSIDE that contract — above all the Hotelling-deflated
    operators of :func:`subdominant_eigenpair`, whose deflation makes
    them indefinite.  No reference analog (the reference solves positive
    matrices only, similarity_transform.hpp:8-9).

    Stop: relative residual ‖A·x − λ·x‖₂ ≤ eps·|λ| (checked on the
    PRE-update iterate; the returned pair is re-evaluated exactly, one
    extra matvec).  Jittable: ``n``/``eps``/``max_itr`` are static,
    the loop is a ``lax.while_loop``.  ``x0`` defaults to a fixed-key
    normal vector (a deterministic start that is almost surely
    non-orthogonal to the dominant eigenvector; ``jnp.ones`` would be
    EXACTLY orthogonal to odd-symmetric eigenvectors).
    """
    import jax
    from jax import lax

    if x0 is None:
        x0 = jax.random.normal(jax.random.key(0), (n,), dtype)
    x0 = jnp.asarray(x0, dtype)
    x0 = x0 / jnp.linalg.norm(x0)
    tiny = jnp.asarray(np.finfo(np.float32).tiny, dtype)

    def cond(state):
        _, lam, resid, itr = state
        return (resid > eps * jnp.abs(lam)) & (itr < max_itr)

    def body(state):
        x, _, _, itr = state
        y = matvec(x)
        lam = _dot(x, y)  # Rayleigh quotient (x has unit norm)
        resid = jnp.linalg.norm(y - lam * x)
        x_new = y / jnp.maximum(jnp.linalg.norm(y), tiny)
        return x_new, lam, resid, itr + 1

    init = (x0, jnp.asarray(0.0, dtype), jnp.asarray(jnp.inf, dtype),
            jnp.asarray(0, jnp.int32))
    x, _, _, itr = lax.while_loop(cond, body, init)
    # the loop's (λ, resid) describe the PREVIOUS iterate; re-evaluate the
    # returned vector exactly so the record matches what the caller gets
    y = matvec(x)
    lam = _dot(x, y)
    resid = jnp.linalg.norm(y - lam * x)
    # converged requires BOTH the residual tolerance and loop exit before
    # the cap: a capped run whose final (never-checked) update happens to
    # land within tolerance may sit on a tied-magnitude pair — report the
    # honest flag and let the caller judge by the returned residual.
    converged = (itr < max_itr) & (resid <= eps * jnp.abs(lam))
    return PowerResult(lam, x, itr, converged, resid)


def _require_symmetric(A, fn_name: str) -> np.ndarray:
    """float64 copy of ``A``, validated square and symmetric (Hotelling
    deflation with the right eigenvector assumes left = right)."""
    A64 = np.asarray(A, np.float64)
    if A64.ndim != 2 or A64.shape[0] != A64.shape[1]:
        raise ValueError(f"need a square matrix, got {A64.shape}")
    if not np.allclose(A64, A64.T, rtol=1e-6, atol=1e-12):
        raise ValueError(
            f"{fn_name} requires a SYMMETRIC matrix (Hotelling deflation "
            "with the right eigenvector assumes left = right)"
        )
    return A64


def _deflation_seed(A64: np.ndarray, result, refine: bool):
    """(λ₁, unit-2-norm v̂₁) in float64 from any solve result.  A
    :class:`RefinedPair` is used as-is (already polished — callers who
    also want the refined dominant pair pay the host work once);
    otherwise ``refine=True`` polishes via :func:`refine_eigenpair`."""
    if isinstance(result, RefinedPair):
        lam1 = float(result.eigenvalue)
        v1 = np.asarray(result.eigenvector, np.float64)
    elif refine:
        rp = refine_eigenpair(A64, result)
        lam1, v1 = rp.eigenvalue, rp.eigenvector
    else:
        lam1 = float(result.eigenvalue)
        v1 = np.asarray(result.eigenvector, np.float64)
    return lam1, v1 / np.linalg.norm(v1)


class SubdominantPair(NamedTuple):
    eigenvalue: float  # λ₂ (signed)
    eigenvector: np.ndarray  # unit 2-norm, ``dtype``
    ratio: float  # |λ₂/λ₁| — the measured convergence rate / spectral gap
    rounds: int  # power-iteration matvecs spent
    converged: bool
    residual: float  # ‖A·v₂ − λ₂·v₂‖₂ through the ORIGINAL A


def subdominant_eigenpair(
    A, result, eps: float = 1e-5, max_itr: int = 5000, refine: bool = True,
    dtype=jnp.float32,
) -> SubdominantPair:
    """The SECOND eigenpair (λ₂, v₂) of a symmetric positive matrix, by
    Hotelling deflation of the solver's dominant pair — it turns
    :func:`convergence_report`'s rate ESTIMATE into a measured spectral
    gap (the report reads |λ₂/λ₁| off the λ history's decay; this
    computes λ₂ itself and cross-validates the estimate).

    ``result`` is any converged solve's :class:`..solver.SolveResult` —
    or an already-polished :class:`RefinedPair` (e.g. from a prior
    :func:`refine_eigenpair` call), which is used as-is so callers who
    also want the polished dominant pair pay the host refinement once.
    Otherwise the dominant pair is first polished to f64 on the host
    (``refine=True``): the deflated operator
    B = A − λ₁·v̂₁v̂₁ᵀ carries a spurious eigenvalue of order the dominant
    RESIDUAL in the v₁ direction, so an eps=1e-3 unpolished pair bounds
    λ₂'s accuracy at ~1e-3·λ₁ while the polished one is exact to f32
    round-off.  The deflated iteration itself runs ON DEVICE in ``dtype``
    via :func:`power_eigenpair` (B is symmetric but indefinite — outside
    the similarity-transform contract).  Only defined for symmetric A
    (Hotelling deflation needs the left eigenvector = right); requires
    |λ₂| > |λ₃| to converge.
    """
    A64 = _require_symmetric(A, "subdominant_eigenpair")
    lam1, v1n = _deflation_seed(A64, result, refine)

    n = A64.shape[0]
    Aj = jnp.asarray(A64, dtype)
    v1j = jnp.asarray(v1n, dtype)
    lam1j = jnp.asarray(lam1, dtype)

    def deflated(x):
        return _dot(Aj, x) - lam1j * _dot(v1j, x) * v1j

    # start orthogonal to v̂₁: removes the (already deflated) dominant
    # direction from round 0, so every iteration works on the subspace
    import jax

    x0 = jax.random.normal(jax.random.key(0), (n,), dtype)
    x0 = x0 - _dot(v1j, x0) * v1j
    pr = power_eigenpair(deflated, n, eps=eps, max_itr=max_itr, x0=x0,
                         dtype=dtype)
    v2 = np.asarray(pr.eigenvector, dtype)
    lam2 = float(pr.eigenvalue)
    resid = float(np.linalg.norm(A64 @ v2.astype(np.float64)
                                 - lam2 * v2.astype(np.float64)))
    return SubdominantPair(
        lam2, v2, abs(lam2) / abs(lam1), int(pr.rounds),
        bool(pr.converged), resid,
    )


class TopKPairs(NamedTuple):
    eigenvalues: np.ndarray  # (k,) signed, ordered by decreasing |λ|
    eigenvectors: np.ndarray  # (n, k) columns, unit 2-norm, ``dtype``
    ratios: np.ndarray  # (k,) |λ_i/λ₁| — cumulative gap profile
    rounds: np.ndarray  # (k,) power-iteration matvecs per pair (0 = dominant)
    converged: np.ndarray  # (k,) bool
    residuals: np.ndarray  # (k,) ‖A·v_i − λ_i·v_i‖₂ through the ORIGINAL A


def top_k_eigenpairs(
    A, result, k: int, eps: float = 1e-5, max_itr: int = 5000,
    refine: bool = True, dtype=jnp.float32,
) -> TopKPairs:
    """The ``k`` largest-|λ| eigenpairs of a symmetric positive matrix by
    SUCCESSIVE Hotelling deflation — :func:`subdominant_eigenpair`
    iterated, each stage deflating every pair found so far
    (B_j = A − Σ_{i<j} λ_i·v_iv_iᵀ) and re-orthogonalizing its start and
    result against them (computed vectors are only eps-orthogonal, so
    without the projection the dominant directions re-enter through
    round-off).  The small spectral toolkit this enables — mixing rates,
    gap profiles, low-rank spectral approximation — has no reference
    analog (outputs are (λ, v, ms, rounds) only,
    wrapper/python/similarity_transform.py:42-78).

    Accuracy compounds: pair j inherits the residuals of pairs < j, so
    deep k needs the f64-refined dominant pair (``refine=True``) and a
    tight ``eps``; per-pair ``residuals`` (through the ORIGINAL A) report
    what was actually achieved.  Requires strictly separated magnitudes
    |λ_j| > |λ_{j+1}| at every computed stage to converge.
    """
    import jax

    if k < 1:
        raise ValueError(f"need k >= 1, got {k}")
    A64 = _require_symmetric(A, "top_k_eigenpairs")
    n = A64.shape[0]
    if k > n:
        raise ValueError(f"k={k} exceeds the dimension n={n}")
    lam1, v1 = _deflation_seed(A64, result, refine)

    lams = [lam1]
    vecs = [v1.astype(dtype)]
    rounds = [0]
    # a RefinedPair seed has no converged flag — its polish implies one
    converged = [bool(getattr(result, "converged", True))]
    Aj = jnp.asarray(A64, dtype)
    for j in range(1, k):
        V = jnp.stack([jnp.asarray(v) for v in vecs], axis=1)  # (n, j)
        lamv = jnp.asarray(np.array(lams), dtype)

        def deflated(x, _V=V, _lamv=lamv):
            return _dot(Aj, x) - _dot(_V, _lamv * _dot(_V.T, x))

        x0 = jax.random.normal(jax.random.key(j), (n,), dtype)
        x0 = x0 - _dot(V, _dot(V.T, x0))
        pr = power_eigenpair(deflated, n, eps=eps, max_itr=max_itr, x0=x0,
                             dtype=dtype)
        v = np.asarray(pr.eigenvector, np.float64)
        # project out the found subspace again: the iterate re-acquires
        # O(eps) components of earlier directions through imperfect deflation
        Vh = np.stack([np.asarray(vi, np.float64) for vi in vecs], axis=1)
        v = v - Vh @ (Vh.T @ v)
        v /= np.linalg.norm(v)
        lam = float(v @ (A64 @ v))  # Rayleigh quotient through the true A
        lams.append(lam)
        vecs.append(v.astype(dtype))
        rounds.append(int(pr.rounds))
        converged.append(bool(pr.converged))

    Vout = np.stack([np.asarray(v, dtype) for v in vecs], axis=1)
    lam_arr = np.array(lams)
    resid = np.array([
        float(np.linalg.norm(A64 @ Vout[:, i].astype(np.float64)
                             - lam_arr[i] * Vout[:, i].astype(np.float64)))
        for i in range(k)
    ])
    return TopKPairs(
        lam_arr, Vout, np.abs(lam_arr) / abs(lam_arr[0]),
        np.array(rounds), np.array(converged), resid,
    )
