"""Port parity of exact vector search (K22, the ``vec_distance`` kernel):
``_vocab_distances``, ``_compile_vec_distance`` and the host evaluator's
vector branch against the JAX reference's (``greptimedb_tpu/query/
exprs.py``), on the CPU with the kernel's plain version.

Inputs come from numpy seeds.  Tolerance: the golden comparer's
``|a-b| <= 1e-5*max(1,|b|)`` for real-valued components (both sides sum
in f32, in different orders); exact for integer-valued components, whose
f32 sums are exact.  NaN must sit where the reference has it: terms that
do not parse to the query's width, and code -1.  The distinct-vector guard
(``GREPTIME_VECTOR_MAX_DISTINCT``) raises the reference's message, and
the reference's own ``TestVectorSearch`` / ``TestVectorScaleGuard`` cases
run against the port.  Tests marked ``cuda`` hold the kernel to its plain
version on the card.
"""

import numpy as np
import pytest
import test_sql as ts
import torch

from greptimedb_tpu.query import exprs as RE
from greptimedb_tpu.query.ast import Column as RColumn
from greptimedb_tpu.query.ast import FuncCall as RFuncCall
from greptimedb_tpu.query.ast import Literal as RLiteral
from greptimedb_tpu.standalone import GreptimeDB as RefDB
from greptimedb_tpu_torch.errors import (
    ExecutionError, PlanError, ResourcesExhausted,
)
from greptimedb_tpu_torch.ops import vector_kernels as VK
from greptimedb_tpu_torch.query import exprs as PE
from greptimedb_tpu_torch.query.ast import Column, FuncCall, Literal
from greptimedb_tpu_torch.standalone import GreptimeDB

NAMES = sorted(VK.OPS)
REL_TOL = 1e-5


def _text(v) -> str:
    return "[" + ", ".join(repr(float(x)) for x in v) + "]"


def _terms(rng, d: int, dim: int, integer: bool) -> list:
    if integer:
        mat = rng.integers(0, 128, (d, dim)).astype(np.float32)
    else:
        mat = rng.uniform(-1, 1, (d, dim)).astype(np.float32)
    terms = [_text(r) for r in mat]
    terms[3] = "nope"                      # does not parse
    terms[5] = _text(mat[5][:-1])          # the wrong width
    terms[7] = None                        # NULL
    terms[11] = _text(np.zeros(dim))       # cosine's 1e-30 floor
    return terms


def _close(got: np.ndarray, want: np.ndarray, exact: bool) -> None:
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if exact:
        assert np.array_equal(got[ok], want[ok])
    else:
        err = np.abs(got[ok] - want[ok])
        assert (err <= REL_TOL * np.maximum(1.0, np.abs(want[ok]))).all()


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dim,integer", [(128, True), (128, False),
                                         (37, False), (3, True)])
def test_vocab_distances_match_reference(name, dim, integer):
    rng = np.random.default_rng(dim * 2 + integer)
    terms = _terms(rng, 300, dim, integer)
    q = (rng.integers(0, 128, dim) if integer
         else rng.uniform(-1, 1, dim)).astype(np.float32)
    want = RE._vocab_distances(name, terms, q)
    got = PE._vocab_distances(name, terms, q, "cpu")
    # cosine divides, so it is held to the bound even for integers
    _close(got, want, exact=integer and name != "vec_cos_distance")


def test_plain_is_the_reference_formula():
    rng = np.random.default_rng(3)
    mat = torch.from_numpy(rng.uniform(-1, 1, (64, 16)).astype(np.float32))
    q = torch.from_numpy(rng.uniform(-1, 1, 16).astype(np.float32))
    valid = torch.ones(64, dtype=torch.bool)
    valid[9] = False
    m64, q64 = mat.double(), q.double()
    want = {
        "vec_dot_product": m64 @ q64,
        "vec_l2sq_distance": ((m64 - q64) ** 2).sum(1),
        "vec_cos_distance": 1 - (m64 @ q64) / (m64.norm(dim=1) * q64.norm()),
    }
    for name in NAMES:
        got = VK.vec_distance(mat, valid, q, name).double()
        assert torch.isnan(got[9])
        w = want[name].clone()
        w[9] = float("nan")
        _close(got.numpy(), w.numpy(), exact=False)
    assert VK.vec_distance.launches == 0  # CPU tensors: the plain version


def test_vec_distance_checks_arguments():
    mat = torch.zeros(4, 3)
    valid = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        VK.vec_distance(mat, valid, torch.zeros(3), "vec_l1_distance")
    with pytest.raises(ValueError):
        VK.vec_distance(mat, valid, torch.zeros(2), "vec_dot_product")
    with pytest.raises(ValueError):
        VK.vec_distance(mat.double(), valid, torch.zeros(3),
                        "vec_dot_product")
    with pytest.raises(ValueError):
        VK.vec_distance(mat, valid[:3], torch.zeros(3), "vec_dot_product")


DDL = ("CREATE TABLE docs (id STRING, ts TIMESTAMP(3) TIME INDEX, "
       "emb VECTOR(4), PRIMARY KEY (id))")
ROWS = ("INSERT INTO docs VALUES ('a',1000,'[1,0,0,0]'),"
        "('b',2000,'[0,1,0,0]'),('c',3000,'[0.5,0.5,0,0]'),"
        "('d',4000,'[2, 2, 1, 0]'),('e',5000,'[1,2]')")


@pytest.mark.parametrize("name", NAMES)
def test_compile_vec_distance_gathers_by_code(name):
    """Distances once per dictionary entry, gathered to rows by code;
    code -1 (padding) gives NaN, as in the reference."""
    ref, port = RefDB(), GreptimeDB(device="cpu")
    try:
        for d in (ref, port):
            d.sql(DDL)
            d.sql(ROWS)
        vocab = ["[1,0,0,0]", "[0,1,0,0]", "[0.5,0.5,0,0]", "[2, 2, 1, 0]",
                 "[1,2]", ""]
        codes = np.array([0, -1, 2, 5, 1, 3, 4, -1, 0], dtype=np.int32)
        lit = "[1, 2, 0, 0.5]"
        rctx = ref.table_context("docs")
        rctx.table_dicts = {"emb": vocab}
        rfn = RE._compile_vec_distance(
            RFuncCall(name, (RColumn("emb"), RLiteral(lit))), rctx)
        want = np.asarray(rfn({"emb": codes}), dtype=np.float64)
        pctx = port.table_context("docs")
        pctx.table_dicts = {"emb": vocab}
        pfn = PE._compile_vec_distance(
            FuncCall(name, (Column("emb"), Literal(lit))), pctx)
        got = pfn({"emb": torch.from_numpy(codes)})
        assert got.dtype == torch.float32
        _close(got.double().numpy(), want, exact=False)
        assert np.isnan(want[[1, 7]]).all()
    finally:
        ref.close()
        port.close()


def test_sql_paths_match_reference():
    ref, port = RefDB(), GreptimeDB(device="cpu")
    try:
        for d in (ref, port):
            d.sql(DDL)
            d.sql(ROWS)
        for sql in (
            "SELECT id, vec_l2sq_distance(emb, '[1,1,0,0]') AS d FROM docs "
            "ORDER BY d, id",
            "SELECT id FROM docs ORDER BY vec_cos_distance(emb, '[1,0,0,0]') "
            "LIMIT 3",
            "SELECT id, vec_dot_product(emb, '[1,2,3,4]') FROM docs "
            "ORDER BY id",
            "SELECT count(*) FROM docs "
            "WHERE vec_l2sq_distance(emb, '[1,0,0,0]') < 1.0",
            "SELECT id, ts FROM docs WHERE vec_dot_product(emb, '[0,1,0,0]')"
            " > 0.2 ORDER BY ts",
        ):
            want, got = ref.sql(sql), port.sql(sql)
            assert len(got.rows) == len(want.rows) > 0, sql
            for g, w in zip(got.rows, want.rows):
                assert len(g) == len(w)
                for a, b in zip(g, w):
                    if isinstance(b, float):
                        assert a == pytest.approx(b, rel=REL_TOL,
                                                  abs=REL_TOL), sql
                    else:
                        assert a == b, sql
    finally:
        ref.close()
        port.close()


def test_distinct_guard_raises_the_reference_message(monkeypatch):
    monkeypatch.setenv("GREPTIME_VECTOR_MAX_DISTINCT", "3")
    q = np.zeros(2, dtype=np.float32)
    terms = ["[1,0]", "[0,1]", "[1,1]", "[2,2]"]
    from greptimedb_tpu.errors import ResourcesExhausted as RefExhausted

    with pytest.raises(RefExhausted) as want:
        RE._vocab_distances("vec_l2sq_distance", terms, q)
    with pytest.raises(ResourcesExhausted) as got:
        PE._vocab_distances("vec_l2sq_distance", terms, q, "cpu")
    assert str(got.value) == str(want.value)
    monkeypatch.setenv("GREPTIME_VECTOR_MAX_DISTINCT", "4")
    assert PE._vocab_distances("vec_l2sq_distance", terms, q,
                               "cpu").shape == (4,)


def test_host_eval_needs_a_device():
    """The host evaluator runs K22 on the device the engine passes in
    ``__device__``; without one it raises instead of using the CPU."""
    e = FuncCall("vec_l2sq_distance", (Column("emb"), Literal("[1,0]")))
    env = {"emb": np.array(["[1,0]", "[0,1]"], dtype=object)}
    with pytest.raises(ExecutionError):
        PE.eval_host(e, env, 2)
    env["__device__"] = torch.device("cpu")
    assert PE.eval_host(e, env, 2).tolist() == [0.0, 2.0]


# ---- the reference's own cases, against the port ----------------------

@pytest.fixture
def db():
    d = GreptimeDB(device="cpu")
    yield d
    d.close()


class TestVectorSearchOnPort(ts.TestVectorSearch):
    """tests/test_sql.py::TestVectorSearch with the port's db."""

    def test_bad_literal_errors(self, vdb):
        with pytest.raises(PlanError):
            vdb.sql("SELECT vec_cos_distance(emb, 'nope') FROM docs")


class TestVectorScaleGuardOnPort(ts.TestVectorScaleGuard):
    """tests/test_sql.py::TestVectorScaleGuard with the port's db and its
    ResourcesExhausted."""

    def test_distinct_bound_enforced(self, db, monkeypatch):
        monkeypatch.setenv("GREPTIME_VECTOR_MAX_DISTINCT", "2")
        db.sql("CREATE TABLE vg (id STRING, ts TIMESTAMP(3) TIME INDEX, "
               "emb VECTOR(2), PRIMARY KEY (id))")
        db.sql("INSERT INTO vg VALUES ('a',1000,'[1,0]'),"
               "('b',2000,'[0,1]'),('c',3000,'[1,1]')")
        with pytest.raises(ResourcesExhausted, match="distinct vectors"):
            db.sql("SELECT id FROM vg ORDER BY "
                   "vec_cos_distance(emb, '[1,0]') LIMIT 1")
        monkeypatch.setenv("GREPTIME_VECTOR_MAX_DISTINCT", "100")
        r = db.sql("SELECT id FROM vg ORDER BY "
                   "vec_cos_distance(emb, '[1,0]') LIMIT 1")
        assert r.rows == [["a"]]


# ---- on the card --------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [128, 37])
def test_cuda_vec_distance_matches_plain(dim, cuda_device):
    """Integer components (0..127): dot and L2^2 exact; cosine within
    1e-6 (its sums are exact, only the square roots, product, quotient
    and difference round)."""
    rng = np.random.default_rng(dim)
    d = 131_072 + 5
    mat = torch.from_numpy(rng.integers(0, 128, (d, dim)).astype(np.float32))
    q = torch.from_numpy(rng.integers(0, 128, dim).astype(np.float32))
    valid = torch.from_numpy(rng.random(d) < 0.99)
    mat[7] = 0.0
    for name in NAMES:
        want = VK.vec_distance_plain(mat.double(), valid, q.double(), name)
        before = VK.vec_distance.launches
        got = VK.vec_distance(mat.to(cuda_device), valid.to(cuda_device),
                              q.to(cuda_device), name)
        torch.cuda.synchronize()
        assert VK.vec_distance.launches == before + 1
        got = got.cpu().double()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        err = (got[ok] - want[ok]).abs().max().item()
        assert err <= (1e-6 if name == "vec_cos_distance" else 0.0), name


@pytest.mark.cuda
def test_cuda_vector_sql_matches_cpu(cuda_device):
    dbs = (GreptimeDB(device="cuda"), GreptimeDB(device="cpu"))
    try:
        for d in dbs:
            d.sql(DDL)
            d.sql(ROWS)
        for sql in ("SELECT id FROM docs ORDER BY "
                    "vec_l2sq_distance(emb, '[1,1,0,0]') LIMIT 3",
                    "SELECT count(*) FROM docs "
                    "WHERE vec_dot_product(emb, '[1,0,0,0]') >= 0.5"):
            before = VK.vec_distance.launches
            assert dbs[0].sql(sql).rows == dbs[1].sql(sql).rows
            assert VK.vec_distance.launches == before + 1
    finally:
        for d in dbs:
            d.close()
