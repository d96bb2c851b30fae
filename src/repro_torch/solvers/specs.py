"""ProgramSpec JSON for every solver iteration body — plus whole
solvers as JSON loop specs (CG_LOOP / JACOBI_LOOP / BICGSTAB_LOOP /
GMRES_LOOP / BLOCK_CG_LOOP at the bottom).

The port's own copy of the reference package's solver specs: the same
dicts, name by name (a CPU test holds them equal).

Each spec below is a plain AIEBLAS-style JSON dict assembled from
registry routines (gemv/gemvt/dot/axpy/vsub/vmul/scal/waxpby/nrm2/rot/
transpose), so every solver iteration goes through the real pipeline —
spec parse → dataflow graph → fusion plan → generated kernels —
in both `dataflow` and `nodataflow` modes. The comments note which
routines the fusion planner merges into a single on-chip kernel in
dataflow mode.

Convention: gemv `y` operands that are multiplied by beta=0 are aliased
to an existing same-length vector instead of a dedicated zeros input,
so no dead operand crosses the program boundary.
"""
from __future__ import annotations

# r = b - A x ; rnorm = ‖r‖        (vsub → nrm2 fuse into one kernel)
RESIDUAL = {
    "name": "residual",
    "routines": [
        {"blas": "gemv", "name": "matvec",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "x": "x", "y": "b"},
         "connections": {"out": "res.y"}},
        {"blas": "vsub", "name": "res", "inputs": {"x": "b"},
         "connections": {"out": "rn.x"}, "outputs": {"out": "r"}},
        {"blas": "nrm2", "name": "rn", "outputs": {"out": "rnorm"}},
    ],
}

# ‖x‖ alone — used for the relative-tolerance scale ‖b‖
NRM2 = {
    "name": "nrm2",
    "routines": [
        {"blas": "nrm2", "name": "nn", "inputs": {"x": "x"},
         "outputs": {"out": "norm"}},
    ],
}

# --------------------------------------------------------------------
# Conjugate gradient
# --------------------------------------------------------------------

# q = A p ; pq = pᵀ q
CG_MATVEC = {
    "name": "cg_matvec",
    "routines": [
        {"blas": "gemv", "name": "matvec",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "x": "p", "y": "p"},
         "connections": {"out": "pq.x"}, "outputs": {"out": "q"}},
        {"blas": "dot", "name": "pq", "inputs": {"y": "p"},
         "outputs": {"out": "pq"}},
    ],
}

# x' = x + alpha p ; r' = r - alpha q ; rnorm = ‖r'‖
# (rup → rn fuse: the new residual never round-trips through HBM
#  before its norm is taken)
CG_UPDATE = {
    "name": "cg_update",
    "routines": [
        {"blas": "axpy", "name": "xup",
         "scalars": {"alpha": {"input": "alpha"}},
         "inputs": {"x": "p", "y": "x"}, "outputs": {"out": "x_next"}},
        {"blas": "axpy", "name": "rup",
         "scalars": {"alpha": {"input": "neg_alpha"}},
         "inputs": {"x": "q", "y": "r"},
         "connections": {"out": "rn.x"}, "outputs": {"out": "r_next"}},
        {"blas": "nrm2", "name": "rn", "outputs": {"out": "rnorm"}},
    ],
}

# p' = r' + beta p
CG_PUPDATE = {
    "name": "cg_pupdate",
    "routines": [
        {"blas": "waxpby", "name": "pup",
         "scalars": {"alpha": 1.0, "beta": {"input": "beta"}},
         "inputs": {"x": "r", "y": "p"}, "outputs": {"out": "p_next"}},
    ],
}

# --------------------------------------------------------------------
# Jacobi / Richardson:  x' = x + omega D⁻¹ (b - A x)
# --------------------------------------------------------------------

# x' = x + omega (dinv ⊙ r)         (vmul → axpy fuse into one kernel)
# The residual r and its norm come from RESIDUAL on the *updated* x,
# so the reported residual/history always belong to the returned
# iterate (same telemetry semantics as CG/BiCGStab).
JACOBI_UPDATE = {
    "name": "jacobi_update",
    "routines": [
        {"blas": "vmul", "name": "sc",
         "inputs": {"x": "r", "y": "dinv"},
         "connections": {"out": "xup.x"}},
        {"blas": "axpy", "name": "xup",
         "scalars": {"alpha": {"input": "omega"}},
         "inputs": {"y": "x"}, "outputs": {"out": "x_next"}},
    ],
}

# --------------------------------------------------------------------
# BiCGStab
# --------------------------------------------------------------------

# v = A p ; rv = r̂ᵀ v
BICG_MATVEC1 = {
    "name": "bicg_matvec1",
    "routines": [
        {"blas": "gemv", "name": "matvec",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "x": "p", "y": "p"},
         "connections": {"out": "rv.x"}, "outputs": {"out": "v"}},
        {"blas": "dot", "name": "rv", "inputs": {"y": "rhat"},
         "outputs": {"out": "rv"}},
    ],
}

# s = r - alpha v ; snorm = ‖s‖    (sup → sn fuse into one kernel)
# snorm drives the ‖s‖-based early exit in the driver: when s is
# already tiny the step finishes with x += alpha p under a cond
# stage and skips the second matvec entirely.
BICG_SUPDATE = {
    "name": "bicg_supdate",
    "routines": [
        {"blas": "axpy", "name": "sup",
         "scalars": {"alpha": {"input": "neg_alpha"}},
         "inputs": {"x": "v", "y": "r"},
         "connections": {"out": "sn.x"}, "outputs": {"out": "s"}},
        {"blas": "nrm2", "name": "sn", "outputs": {"out": "snorm"}},
    ],
}

# x' = x + alpha p — the ‖s‖-early-exit half step
BICG_XHALF = {
    "name": "bicg_xhalf",
    "routines": [
        {"blas": "axpy", "name": "xh",
         "scalars": {"alpha": {"input": "alpha"}},
         "inputs": {"x": "p", "y": "x"}, "outputs": {"out": "x_half"}},
    ],
}

# t = A s ; tt = tᵀ t ; ts = tᵀ s    (t fans out to three input ports)
BICG_MATVEC2 = {
    "name": "bicg_matvec2",
    "routines": [
        {"blas": "gemv", "name": "matvec",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "x": "s", "y": "s"},
         "connections": {"out": ["tt.x", "tt.y", "ts.x"]},
         "outputs": {"out": "t"}},
        {"blas": "dot", "name": "tt", "outputs": {"out": "tt"}},
        {"blas": "dot", "name": "ts", "inputs": {"y": "s"},
         "outputs": {"out": "ts"}},
    ],
}

# x' = x + alpha p + omega s ; r' = s - omega t ; rnorm ; rho' = r̂ᵀ r'
# Two fused groups: {xh → xup} and {rup → rn, rho}
BICG_XRUPDATE = {
    "name": "bicg_xrupdate",
    "routines": [
        {"blas": "axpy", "name": "xh",
         "scalars": {"alpha": {"input": "alpha"}},
         "inputs": {"x": "p", "y": "x"},
         "connections": {"out": "xup.y"}},
        {"blas": "axpy", "name": "xup",
         "scalars": {"alpha": {"input": "omega"}},
         "inputs": {"x": "s"}, "outputs": {"out": "x_next"}},
        {"blas": "axpy", "name": "rup",
         "scalars": {"alpha": {"input": "neg_omega"}},
         "inputs": {"x": "t", "y": "s"},
         "connections": {"out": ["rn.x", "rho.x"]},
         "outputs": {"out": "r_next"}},
        {"blas": "nrm2", "name": "rn", "outputs": {"out": "rnorm"}},
        {"blas": "dot", "name": "rho", "inputs": {"y": "rhat"},
         "outputs": {"out": "rho_next"}},
    ],
}

# p' = r' + beta (p - omega v)       (pm → pup fuse)
BICG_PUPDATE = {
    "name": "bicg_pupdate",
    "routines": [
        {"blas": "axpy", "name": "pm",
         "scalars": {"alpha": {"input": "neg_omega"}},
         "inputs": {"x": "v", "y": "p"},
         "connections": {"out": "pup.y"}},
        {"blas": "waxpby", "name": "pup",
         "scalars": {"alpha": 1.0, "beta": {"input": "beta"}},
         "inputs": {"x": "r"}, "outputs": {"out": "p_next"}},
    ],
}

# --------------------------------------------------------------------
# Power iteration
# --------------------------------------------------------------------

# av = A v ; norm = ‖av‖ ; lambda = vᵀ av
POWER_STEP = {
    "name": "power_step",
    "routines": [
        {"blas": "gemv", "name": "matvec",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "x": "v", "y": "v"},
         "connections": {"out": ["nn.x", "lam.x"]},
         "outputs": {"out": "av"}},
        {"blas": "nrm2", "name": "nn", "outputs": {"out": "norm"}},
        {"blas": "dot", "name": "lam", "inputs": {"y": "v"},
         "outputs": {"out": "lambda"}},
    ],
}

# v' = av / ‖av‖
NORMALIZE = {
    "name": "normalize",
    "routines": [
        {"blas": "scal", "name": "norm",
         "scalars": {"alpha": {"input": "inv_norm"}},
         "inputs": {"x": "av"}, "outputs": {"out": "v_next"}},
    ],
}

# --------------------------------------------------------------------
# Loop programs: whole solvers as JSON (`iterate` section)
# --------------------------------------------------------------------
# These are complete solver descriptions — state, feedback edges for
# vectors AND scalars, scalar update expressions, and the stop rule —
# executed generically by `solvers.LoopProgram`. No per-solver Python:
# the ~230 lines of scalar/state glue the class-based solvers carry
# live in the spec instead. The nested stage programs are the same
# dicts as above, so the program cache compiles each body once per
# mode whichever path (class or loop spec) runs it.

CG_LOOP = {
    "name": "cg",
    "dtype": "float32",
    "operands": {"A": "matrix", "b": "vector", "x0": "vector"},
    "setup": [
        {"program": NRM2, "inputs": {"x": "b"},
         "outputs": {"norm": "bnorm"}},
        {"program": RESIDUAL, "inputs": {"x": "x0"},
         "outputs": {"r": "r0", "rnorm": "rnorm0"}},
    ],
    "iterate": {
        "state": {
            "x": {"init": "x0"},
            "r": {"init": "r0"},
            "p": {"init": "r0"},
            "rz": {"init": "rnorm0 * rnorm0", "kind": "scalar"},
        },
        "body": [
            {"program": CG_MATVEC},                      # q = A p ; pq
            {"let": {"alpha": "rz / pq",                 # step length
                     "neg_alpha": "-alpha"}},
            {"program": CG_UPDATE},          # x', r', ‖r'‖ (fused)
            {"let": {"rz_next": "rnorm * rnorm",
                     "beta": "rz_next / rz"}},
            {"program": CG_PUPDATE, "inputs": {"r": "r_next"}},
        ],
        "feedback": {
            "x": "x_next", "r": "r_next", "p": "p_next",
            "rz": "rz_next",               # scalar feedback edge
        },
        "while": {"metric": "rnorm", "init": "rnorm0", "scale": "bnorm",
                  "rtol": 1e-6, "max_iters": 200},
        # in-loop failure detection: pq = p'Ap collapsing is the CG
        # (Krylov) breakdown; the rest catches poisoned state fast
        "guards": {
            "nonfinite": ["x_next"],
            "breakdown": [{"value": "pq", "below": 1e-30}],
            "divergence": {"factor": 1e4},
            "stagnation": {"window": 50},
        },
        "solution": {"x": "x"},
    },
}

BICGSTAB_LOOP = {
    "name": "bicgstab",
    "dtype": "float32",
    "operands": {"A": "matrix", "b": "vector", "x0": "vector"},
    "setup": [
        {"program": NRM2, "inputs": {"x": "b"},
         "outputs": {"norm": "bnorm"}},
        {"program": RESIDUAL, "inputs": {"x": "x0"},
         "outputs": {"r": "r0", "rnorm": "rnorm0"}},
    ],
    "iterate": {
        "state": {
            "x": {"init": "x0"},
            "r": {"init": "r0"},
            "rhat": {"init": "r0"},
            "p": {"init": "r0"},
            "rho": {"init": "rnorm0 * rnorm0", "kind": "scalar"},
        },
        "body": [
            {"program": BICG_MATVEC1},               # v = A p ; rv
            {"let": {"alpha": "rho / rv",
                     "neg_alpha": "-alpha"}},
            {"program": BICG_SUPDATE},               # s ; ‖s‖ (fused)
            # the ‖s‖ early exit IS the spec now: `threshold` is the
            # driver-bound stop threshold (tol * scale), and the two
            # branches agree on {x_next, r_next, p_next, rho_next,
            # rnorm} — everything else stays branch-local
            {"cond": {
                "if": "snorm <= threshold",
                "then": [
                    # x' = x + alpha p, r' = s; p/rho carry over
                    # (bare-name lets alias values of any kind)
                    {"program": BICG_XHALF,
                     "outputs": {"x_half": "x_next"}},
                    {"let": {"r_next": "s", "p_next": "p",
                             "rho_next": "rho", "rnorm": "snorm"}},
                ],
                "else": [
                    {"program": BICG_MATVEC2},       # t ; tᵀt ; tᵀs
                    {"let": {"omega": "ts / tt",
                             "neg_omega": "-omega"}},
                    {"program": BICG_XRUPDATE},      # x', r', ‖r'‖, rho'
                    {"let": {"beta":
                             "(rho_next / rho) * (alpha / omega)"}},
                    {"program": BICG_PUPDATE,
                     "inputs": {"r": "r_next"}},     # p'
                ],
            }},
        ],
        "feedback": {"x": "x_next", "r": "r_next", "p": "p_next",
                     "rho": "rho_next"},
        "while": {"metric": "rnorm", "init": "rnorm0", "scale": "bnorm",
                  "rtol": 1e-6, "max_iters": 200},
        # rv = r̂'v ~ 0 is the BiCGStab breakdown (alpha = rho / rv)
        "guards": {
            "nonfinite": ["x_next"],
            "breakdown": [{"value": "rv", "below": 1e-30}],
            "divergence": {"factor": 1e4},
            "stagnation": {"window": 50},
        },
        "solution": {"x": "x"},
    },
}

JACOBI_LOOP = {
    "name": "jacobi",
    "dtype": "float32",
    "operands": {"A": "matrix", "b": "vector", "x0": "vector",
                 "dinv": "vector", "omega": "scalar"},
    "setup": [
        {"program": NRM2, "inputs": {"x": "b"},
         "outputs": {"norm": "bnorm"}},
        {"program": RESIDUAL, "inputs": {"x": "x0"},
         "outputs": {"r": "r0", "rnorm": "rnorm0"}},
    ],
    "iterate": {
        "state": {
            "x": {"init": "x0"},
            "r": {"init": "r0"},
        },
        "body": [
            # x' = x + omega (dinv ⊙ r)    (vmul → axpy fuse)
            {"program": JACOBI_UPDATE},
            # residual of the *updated* iterate, so telemetry always
            # describes the returned x (same semantics as the class)
            {"program": RESIDUAL, "inputs": {"x": "x_next"},
             "outputs": {"r": "r_next", "rnorm": "rnorm"}},
        ],
        "feedback": {"x": "x_next", "r": "r_next"},
        "while": {"metric": "rnorm", "init": "rnorm0", "scale": "bnorm",
                  "rtol": 1e-6, "max_iters": 1000},
        # Jacobi on a non-diagonally-dominant system genuinely
        # diverges — DIVERGED is the expected diagnosis, not an
        # accident (no Krylov scalar, so no breakdown sentinel)
        "guards": {
            "nonfinite": ["x_next"],
            "divergence": {"factor": 1e4},
            "stagnation": {"window": 100},
        },
        "solution": {"x": "x"},
    },
}


# --------------------------------------------------------------------
# GMRES(m): restarts, Arnoldi, and Givens least-squares — pure JSON
# --------------------------------------------------------------------
# Grammar-v2 constructs in one solver: an outer restart loop whose body
# runs three nested count-loops over stacked Krylov state —
#
#   arnoldi  — V[j+1] from A V[j], classical Gram-Schmidt against the
#              whole basis buffer at once (gemv h = V w, gemvt
#              w' = w − Vᵀ h; zero slots project to zero, so the
#              unfilled basis masks itself — no index arithmetic),
#              Hessenberg COLUMNS stored into a stack, the subdiagonal
#              via an element store;
#   givens   — the column stack transposed to rows (`transpose`), then
#              one plane rotation per step applied to ROW PAIRS with
#              the registry `rot` routine (vectorized over columns),
#              rotating the rhs g alongside;
#   backsub  — y from the triangularized system (the zero-initialized
#              y stack makes dot(R_row, y) sum exactly the
#              already-solved tail), x updated incrementally with axpy.
#
# Safe divides keep breakdown benign: a zero ‖w'‖ (happy breakdown or
# a converged lane in `batched()`) zeroes the remaining slots, the
# zero rows rotate to zero, and back-substitution skips them — the
# solve degrades to the filled Krylov prefix, which is the textbook
# behaviour.

# w = A v                             (the Arnoldi matvec)
GMRES_MATVEC = {
    "name": "gmres_matvec",
    "routines": [
        {"blas": "gemv", "name": "mv",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "x": "v", "y": "v"},
         "outputs": {"out": "w"}},
    ],
}

# h = V w — one gemv against the whole (m+1, n) basis buffer; unfilled
# (zero) slots produce zero projections, masking themselves
GMRES_PROJ = {
    "name": "gmres_proj",
    "routines": [
        {"blas": "gemv", "name": "proj",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "V", "x": "w", "y": "g"},
         "outputs": {"out": "h"}},
    ],
}

# w' = w − Vᵀ h ; hnorm = ‖w'‖       (gemvt correction, then the norm)
GMRES_ORTH = {
    "name": "gmres_orth",
    "routines": [
        {"blas": "gemvt", "name": "corr",
         "scalars": {"alpha": -1.0, "beta": 1.0},
         "inputs": {"A": "V", "x": "h", "y": "w"},
         "connections": {"out": "hn.x"}, "outputs": {"out": "w2"}},
        {"blas": "nrm2", "name": "hn", "outputs": {"out": "hnorm"}},
    ],
}

# out = alpha x                      (v0 and V[j+1] normalizations)
GMRES_SCAL = {
    "name": "gmres_scal",
    "routines": [
        {"blas": "scal", "name": "sc",
         "scalars": {"alpha": {"input": "alpha"}},
         "inputs": {"x": "x"}, "outputs": {"out": "out"}},
    ],
}

# (rja, rj1a) = rot(c, s, rj, rj1)   (Givens on a Hessenberg ROW pair
#                                     — the registry rot routine)
GMRES_ROT = {
    "name": "gmres_rot",
    "routines": [
        {"blas": "rot", "name": "giv",
         "scalars": {"c": {"input": "c"}, "s": {"input": "s"}},
         "inputs": {"x": "rj", "y": "rj1"},
         "outputs": {"out_x": "rja", "out_y": "rj1a"}},
    ],
}

# Hm = Hcᵀ — the column stack becomes the (m+1, m) row-major H
GMRES_TRANSPOSE = {
    "name": "gmres_transpose",
    "routines": [
        {"blas": "transpose", "name": "tr", "inputs": {"A": "Hb"},
         "outputs": {"out": "Hm"}},
    ],
}

# acc = row · y                      (back-substitution inner product)
GMRES_DOT = {
    "name": "gmres_dot",
    "routines": [
        {"blas": "dot", "name": "bs", "inputs": {"x": "row", "y": "yv"},
         "outputs": {"out": "acc"}},
    ],
}

# x' = x + yq v                      (incremental solution update)
GMRES_AXPY = {
    "name": "gmres_axpy",
    "routines": [
        {"blas": "axpy", "name": "up",
         "scalars": {"alpha": {"input": "yq"}},
         "inputs": {"x": "v", "y": "x"}, "outputs": {"out": "xn"}},
    ],
}


def gmres_loop(m: int = 20, *, rtol: float = 1e-6,
               max_restarts: int = 50, name: str = "gmres") -> dict:
    """The GMRES(m) loop spec, parameterized by the restart length.

    `GMRES_LOOP` below is the default instance; callers wanting a
    different Krylov depth build their own.
    """
    m1 = m + 1
    arnoldi = {
        "counter": "j",
        "state": {
            "V": {"kind": "stack", "slots": m1, "of": "vector",
                  "init": {"slot0": "v0"}},
            "Hc": {"kind": "stack", "slots": m, "of": "vector",
                   "len": m1},
            "gs": {"kind": "stack", "slots": m1, "of": "scalar",
                   "init": {"slot0": "rn"}},
        },
        "body": [
            {"read": {"name": "vj", "from": "V", "slot": "j"}},
            {"program": GMRES_MATVEC, "inputs": {"v": "vj"}},
            {"program": GMRES_PROJ, "inputs": {"g": "gs"}},
            {"program": GMRES_ORTH},
            {"let": {"inv_hn": "1 / hnorm"}},      # sdiv: breakdown-safe
            {"program": GMRES_SCAL,
             "inputs": {"alpha": "inv_hn", "x": "w2"},
             "outputs": {"out": "vnext"}},
            {"store": {"into": "V", "slot": "j + 1", "value": "vnext"}},
            {"store": {"into": "Hc", "slot": "j", "value": "h"}},
            # the subdiagonal entry H[j+1, j] = ‖w'‖ lands in the same
            # column via an element store (h[j+1] was 0: V[j+1] did
            # not exist when h was projected)
            {"store": {"into": "Hc", "slot": "j", "at": "j + 1",
                       "value": "hnorm"}},
        ],
        "while": {"count": m},
        "yield": {"Vb": "V", "Hcb": "Hc", "g0": "gs"},
    }

    givens = {
        "counter": "t",
        "state": {
            "R": {"kind": "stack", "slots": m1, "of": "vector",
                  "init": {"from": "Hm"}},
            "g": {"kind": "stack", "slots": m1, "of": "scalar",
                  "init": {"from": "g0"}},
        },
        "body": [
            {"read": {"name": "rj", "from": "R", "slot": "t"}},
            {"read": {"name": "rj1", "from": "R", "slot": "t + 1"}},
            {"read": {"name": "hjj", "from": "rj", "slot": "t"}},
            {"read": {"name": "hsub", "from": "rj1", "slot": "t"}},
            {"let": {"den": "sqrt(hjj * hjj + hsub * hsub)",
                     "c": "hjj / den",        # sdiv: den = 0 on the
                     "s": "hsub / den"}},     # unfilled tail -> no-op
            {"program": GMRES_ROT},
            {"store": {"into": "R", "slot": "t", "value": "rja"}},
            {"store": {"into": "R", "slot": "t + 1", "value": "rj1a"}},
            {"read": {"name": "gj", "from": "g", "slot": "t"}},
            {"let": {"gjn": "c * gj", "gj1n": "-s * gj"}},
            {"store": {"into": "g", "slot": "t", "value": "gjn"}},
            {"store": {"into": "g", "slot": "t + 1", "value": "gj1n"}},
        ],
        "while": {"count": m},
        "yield": {"Rf": "R", "gf": "g"},
    }

    backsub = {
        "counter": "i",
        "state": {
            "y": {"kind": "stack", "slots": m, "of": "scalar"},
            "xa": {"init": "x"},
        },
        "body": [
            {"let": {"q": f"{m - 1} - i"}},    # solve bottom-up
            {"read": {"name": "Rq", "from": "Rf", "slot": "q"}},
            {"read": {"name": "gq", "from": "gf", "slot": "q"}},
            # y's unsolved entries are still zero, so the full-row dot
            # sums exactly the already-solved tail k > q
            {"program": GMRES_DOT, "inputs": {"row": "Rq", "yv": "y"}},
            {"read": {"name": "rqq", "from": "Rq", "slot": "q"}},
            {"let": {"yq": "(gq - acc) / rqq"}},
            {"store": {"into": "y", "slot": "q", "value": "yq"}},
            {"read": {"name": "vq", "from": "Vb", "slot": "q"}},
            {"program": GMRES_AXPY,
             "inputs": {"yq": "yq", "v": "vq", "x": "xa"},
             "outputs": {"xn": "xn"}},
        ],
        "feedback": {"xa": "xn"},
        "while": {"count": m},
        "yield": {"x_next": "xa"},
    }

    return {
        "name": name,
        "dtype": "float32",
        "operands": {"A": "matrix", "b": "vector", "x0": "vector"},
        "setup": [
            {"program": NRM2, "inputs": {"x": "b"},
             "outputs": {"norm": "bnorm"}},
            {"program": RESIDUAL, "inputs": {"x": "x0"},
             "outputs": {"r": "r0", "rnorm": "rnorm0"}},
        ],
        "iterate": {
            "state": {
                "x": {"init": "x0"},
                "r": {"init": "r0"},
                "rn": {"init": "rnorm0", "kind": "scalar"},
            },
            "body": [
                {"let": {"inv_beta": "1 / rn"}},
                {"program": GMRES_SCAL,
                 "inputs": {"alpha": "inv_beta", "x": "r"},
                 "outputs": {"out": "v0"}},
                {"iterate": arnoldi},
                {"program": GMRES_TRANSPOSE, "inputs": {"Hb": "Hcb"}},
                {"iterate": givens},
                {"iterate": backsub},
                # true residual of the restart iterate: metric and
                # telemetry always describe the returned x
                {"program": RESIDUAL, "inputs": {"x": "x_next"},
                 "outputs": {"r": "r_next", "rnorm": "rnorm"}},
            ],
            "feedback": {"x": "x_next", "r": "r_next", "rn": "rnorm"},
            "while": {"metric": "rnorm", "init": "rnorm0",
                      "scale": "bnorm", "rtol": rtol,
                      "max_iters": max_restarts},
            # guards run at restart granularity (the outer loop is
            # the iteration the driver sees); a restart that stops
            # improving the true residual is the GMRES stall mode
            "guards": {
                "nonfinite": ["x_next"],
                "divergence": {"factor": 1e4},
                "stagnation": {"window": 10},
            },
            "solution": {"x": "x"},
        },
    }


GMRES_LOOP = gmres_loop()


# --------------------------------------------------------------------
# Block conjugate gradient: s independent CG recurrences over an
# (n, s) right-hand-side panel sharing one gemm matvec per iteration.
# The per-RHS dot products travel as length-s vectors (coldot), the
# per-RHS step lengths as vdiv quotients, and the stop metric
# collapses to a scalar with amax (the worst column governs). The
# iterates are column-for-column identical to running CG_LOOP on each
# right-hand side, so parity against per-column solves is exact up to
# kernel arithmetic order.
# --------------------------------------------------------------------

# bb = diag(BᵀB) ; bbmax = max_j bb_j      (scale for the stop rule)
BLOCK_NRM2 = {
    "name": "block_nrm2",
    "routines": [
        {"blas": "coldot", "name": "bb",
         "inputs": {"x": "X", "y": "X"},
         "connections": {"out": "mx.x"}, "outputs": {"out": "bb"}},
        {"blas": "amax", "name": "mx", "outputs": {"out": "bbmax"}},
    ],
}

# R0 = B - A X ; rz0 = diag(R0ᵀR0) ; rz0max     (gemm → coldot fuse:
# the residual panel feeds its Gram diagonal on-chip, tile by tile)
BLOCK_RESIDUAL = {
    "name": "block_residual",
    "routines": [
        {"blas": "gemm", "name": "resid",
         "scalars": {"alpha": -1.0, "beta": 1.0},
         "inputs": {"A": "A", "B": "X", "C": "B"},
         "connections": {"out": ["rz.x", "rz.y"]},
         "outputs": {"out": "r0"}},
        {"blas": "coldot", "name": "rz",
         "connections": {"out": "mx.x"}, "outputs": {"out": "rz0"}},
        {"blas": "amax", "name": "mx", "outputs": {"out": "rz0max"}},
    ],
}

# Q = A P ; pq = diag(PᵀQ)      (the gemm-anchored fused group: coldot
# folds each (bm, bn) product tile into its (1, bn) partial on-chip,
# so Q never round-trips through HBM before the Gram diagonal)
BLOCK_CG_MATVEC = {
    "name": "block_cg_matvec",
    "routines": [
        {"blas": "gemm", "name": "mv",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "B": "P", "C": "P"},
         "connections": {"out": "pq.y"}, "outputs": {"out": "q"}},
        {"blas": "coldot", "name": "pq", "inputs": {"x": "P"},
         "outputs": {"out": "pq"}},
    ],
}

# alpha = rz / pq (per column) ; X' = X + P diag(alpha) ;
# R' = R - Q diag(alpha) ; rz' = diag(R'ᵀR') ; rzmax = max_j rz'_j
BLOCK_CG_UPDATE = {
    "name": "block_cg_update",
    "routines": [
        {"blas": "vdiv", "name": "al",
         "inputs": {"x": "rz", "y": "pq"},
         "connections": {"out": ["xup.a", "nal.x"]}},
        {"blas": "scal", "name": "nal", "scalars": {"alpha": -1.0},
         "connections": {"out": "rup.a"}},
        {"blas": "colaxpy", "name": "xup",
         "inputs": {"x": "P", "y": "X"}, "outputs": {"out": "x_next"}},
        {"blas": "colaxpy", "name": "rup",
         "inputs": {"x": "Q", "y": "R"},
         "connections": {"out": ["rz2.x", "rz2.y"]},
         "outputs": {"out": "r_next"}},
        {"blas": "coldot", "name": "rz2",
         "connections": {"out": "mx.x"}, "outputs": {"out": "rz_next"}},
        {"blas": "amax", "name": "mx", "outputs": {"out": "rzmax"}},
    ],
}

# beta = rz' / rz (per column) ; P' = R' + P diag(beta)
BLOCK_CG_PUPDATE = {
    "name": "block_cg_pupdate",
    "routines": [
        {"blas": "vdiv", "name": "bt",
         "inputs": {"x": "rz_next", "y": "rz"},
         "connections": {"out": "pup.a"}},
        {"blas": "colaxpy", "name": "pup",
         "inputs": {"x": "P", "y": "R"}, "outputs": {"out": "p_next"}},
    ],
}

BLOCK_CG_LOOP = {
    "name": "block_cg",
    "dtype": "float32",
    "operands": {"A": "matrix", "B": "matrix", "x0": "matrix"},
    "setup": [
        {"program": BLOCK_NRM2, "inputs": {"X": "B"},
         "outputs": {"bbmax": "bbmax"}},
        {"let": {"bnorm": "sqrt(bbmax)"}},
        {"program": BLOCK_RESIDUAL, "inputs": {"X": "x0"},
         "outputs": {"r0": "r0", "rz0": "rz0", "rz0max": "rz0max"}},
        {"let": {"rnorm0": "sqrt(rz0max)"}},
    ],
    "iterate": {
        "state": {
            "x": {"init": "x0"},
            "r": {"init": "r0"},
            "p": {"init": "r0"},
            "rz": {"init": "rz0"},   # length-s vector: diag(RᵀR)
        },
        "body": [
            {"program": BLOCK_CG_MATVEC, "inputs": {"P": "p"}},
            {"program": BLOCK_CG_UPDATE,
             "inputs": {"P": "p", "X": "x", "Q": "q", "R": "r"}},
            {"let": {"rnorm": "sqrt(rzmax)"}},
            {"program": BLOCK_CG_PUPDATE,
             "inputs": {"P": "p", "R": "r_next"}},
        ],
        "feedback": {
            "x": "x_next", "r": "r_next", "p": "p_next",
            "rz": "rz_next",           # vector feedback edge
        },
        "while": {"metric": "rnorm", "init": "rnorm0", "scale": "bnorm",
                  "rtol": 1e-6, "max_iters": 200},
        # pq is a per-right-hand-side sentinel: any column's p'Ap
        # collapsing is a (block-)Krylov breakdown for that column
        "guards": {
            "nonfinite": ["x_next"],
            "breakdown": [{"value": "pq", "below": 1e-30}],
            "divergence": {"factor": 1e4},
            "stagnation": {"window": 50},
        },
        "solution": {"x": "x"},
    },
}
