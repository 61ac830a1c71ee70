"""Run the reference's own test scenarios on both packages and compare.

A reference test file (tests/test_tx_apply.py and the like) is written
against ``stellar_core_tpu``.  ``load`` compiles its source a second time
with every name of that package pointed at another root, so the same
scenario, with the same seeded keys, runs on ``stellar_core_tpu`` and on
``stellar_core_tpu_torch``.  ``run_case`` runs one test of it on one root
while recording every ledger close (each ``LedgerManager.close_ledger``:
the new ledger's hash and its ``TransactionResultSet`` in XDR bytes, or
the error it raised) and the test's own outcome; ``assert_mirrored``
holds the two roots' records equal, byte for byte.

``cases`` lists a file's tests that the port can run: a test whose body
names a module the port does not have is left out (since the last
slice every module has its copy), as is one marked slow (the tier-1
run deselects those).  Fixtures are the file's own, called as plain functions
(a module-scoped one anew for each case); ``tmp_path``,
``tmp_path_factory``, ``monkeypatch``, ``capsys`` and ``caplog`` are
made here.  As under pytest,
the file's autouse fixtures (its own and its class's) come first, then a
class's ``setup_method``; ``teardown_method`` runs after the case, and a
fixture argument with a default keeps it.

The tests of this file check the helper itself.
"""

from __future__ import annotations

import ast
import contextlib
import importlib
import inspect
import io
import itertools
import logging
import re
import sys
import tempfile
import types
from pathlib import Path

import pytest

REF, PORT = "stellar_core_tpu", "stellar_core_tpu_torch"
ROOTS = (REF, PORT)
TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
_NAME = re.compile(r"\bstellar_core_tpu\b")
_DOTTED = re.compile(r"\bstellar_core_tpu((?:\.\w+)+)")
_FROM_PKG = re.compile(r"from stellar_core_tpu import (\([^)]*\)|[^\n]+)")
# the reference's timing driver, which its clock rule exempts; the port's
# is chip_smoke.py (a file name, so "workbench.py" is not one)
_BENCH = re.compile(r"(?<![\w.])bench\.py\b")
# the port's native modules are built, not files
_BUILT = {"_cxdr", "_capply", "_cquorum"}
# names the port defines whose use reaches, through a lazy import inside
# them, a module the port may lack: simulation.loadgen's AdmissionCampaign
# runs the live node's admission pipeline
_REACHES = {"AdmissionCampaign": ".herder.admission"}


def ported(dotted: str) -> bool:
    """True when `dotted` (a module path under the reference's root, the
    root left out, e.g. ".ledger.manager") exists in the port."""
    parts = [p for p in dotted.split(".") if p]
    base = REPO / PORT
    for i, part in enumerate(parts):
        if i == 0 and part in _BUILT:
            return True
        if (base / part / "__init__.py").exists():
            base = base / part
            continue
        # a module file; what follows is a name inside it
        return (base / (part + ".py")).exists()
    return True


def unported(source: str) -> list:
    """The modules `source` names, or reaches through a name of
    _REACHES, that the port does not have."""
    missing = [m for m in _DOTTED.findall(source) if not ported(m)]
    missing += [m for name, m in _REACHES.items()
                if re.search(rf"\b{name}\b", source) and not ported(m)]
    for names in _FROM_PKG.findall(source):
        for n in names.strip("()").replace("\n", " ").split(","):
            n = n.split(" as ")[0].strip()
            if n and not ported("." + n):
                missing.append("." + n)
    return sorted(set(missing))


def _marks(node) -> list:
    out = []
    for d in node.decorator_list:
        seg = ast.unparse(d)
        if seg.startswith("pytest.mark."):
            out.append(seg.split("(")[0].removeprefix("pytest.mark."))
    return out


def cases(filename: str) -> list:
    """The tests of tests/`filename` the port can run, as "name" or
    "Class.name"."""
    src = (TESTS / filename).read_text()
    tree = ast.parse(src)
    top = "\n".join(ast.get_source_segment(src, n) or "" for n in tree.body
                  if isinstance(n, (ast.Import, ast.ImportFrom)))
    if unported(top):
        raise ValueError(f"{filename} imports {unported(top)} at the top")
    found = []

    def consider(fn, name, cls=None):
        if not fn.name.startswith("test_") or "slow" in _marks(fn) \
                or (cls is not None and "slow" in _marks(cls)):
            return
        body = ast.get_source_segment(src, fn)
        if unported(body):
            return
        found.append(name)

    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            consider(node, node.name)
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef):
                    consider(fn, f"{node.name}.{fn.name}", node)
    return found


def rewrite(source: str, root: str) -> str:
    """`source` with every name of the reference's package pointed at
    `root`, in imports and in path strings alike ("stellar_core_tpu/scp/"
    becomes the port's consensus scope), the reference's bench.py named
    as the port's chip_smoke.py, and pytest's fixture decorators removed
    (a fixture is then a plain function that run_case calls)."""
    if root != REF:
        source = _BENCH.sub("chip_smoke.py", _NAME.sub(root, source))
    return re.sub(r"^[ \t]*@pytest\.fixture(\([^)]*\))?[ \t]*\n", "", source,
                  flags=re.M)


_loaded: dict = {}


def _autouse(tree) -> dict:
    """{None: the module's autouse fixtures, class name: its own}, in
    the order the file defines them."""
    def names(body):
        return [n.name for n in body if isinstance(n, ast.FunctionDef)
                and any("fixture" in ast.unparse(d) and "autouse=True"
                        in ast.unparse(d) for d in n.decorator_list)]
    out = {None: names(tree.body)}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            out[node.name] = names(node.body)
    return out


def load(filename: str, root: str):
    """tests/`filename` compiled against `root`, once a process."""
    key = (filename, root)
    if key not in _loaded:
        path = TESTS / filename
        name = f"_mirror_{root}_{path.stem}"
        mod = types.ModuleType(name)
        mod.__file__ = str(path)
        sys.modules[name] = mod
        src = path.read_text()
        mod.__mirror_autouse__ = _autouse(ast.parse(src))
        exec(compile(rewrite(src, root), str(path), "exec"), mod.__dict__)
        _loaded[key] = mod
    return _loaded[key]


def _params(fn) -> list:
    """Every argument set of fn's parametrize marks, as dicts."""
    sets = [[{}]]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[:2]
        names = [n.strip() for n in names.split(",")] \
            if isinstance(names, str) else list(names)
        one = []
        for v in values:
            v = v.values if hasattr(v, "values") and hasattr(v, "marks") \
                else v
            v = (v,) if len(names) == 1 else tuple(v)
            one.append(dict(zip(names, v)))
        sets.append(one)
    return [dict(kv for d in combo for kv in d.items())
            for combo in itertools.product(*sets)]


def _outcome(call) -> tuple:
    try:
        call()
    except pytest.skip.Exception as e:
        return ("skip", str(e))
    except BaseException as e:          # the test's own failure, compared
        return ("fail", type(e).__name__, str(e))
    return ("ok",)


@contextlib.contextmanager
def recording(root: str, log: list):
    """Record every LedgerManager.close_ledger of `root` into `log`."""
    LM = importlib.import_module(root + ".ledger.manager").LedgerManager
    orig = LM.close_ledger

    def close_ledger(self, *args, **kwargs):
        try:
            arts = orig(self, *args, **kwargs)
        except BaseException as e:
            log.append(("raise", type(e).__name__, str(e)))
            raise
        log.append((self.lcl_header.ledgerSeq, self.lcl_hash,
                    arts.result_entry.txResultSet.to_xdr()))
        return arts

    LM.close_ledger = close_ledger
    try:
        yield log
    finally:
        LM.close_ledger = orig


class _TmpPathFactory:
    """pytest's tmp_path_factory, reduced to mktemp, under one directory."""

    def __init__(self, base: Path):
        self._base = base
        self._n = itertools.count()

    def mktemp(self, basename: str, numbered: bool = True) -> Path:
        path = self._base / (f"{basename}{next(self._n)}" if numbered
                             else basename)
        path.mkdir()
        return path


class _CapSys:
    """pytest's capsys, reduced to readouterr: what the case writes to
    sys.stdout and sys.stderr from the moment it asks for it until
    close()."""

    def __init__(self):
        self._saved = sys.stdout, sys.stderr
        self._out, self._err = io.StringIO(), io.StringIO()
        sys.stdout, sys.stderr = self._out, self._err

    def readouterr(self):
        got = types.SimpleNamespace(out=self._out.getvalue(),
                                    err=self._err.getvalue())
        for buf in (self._out, self._err):
            buf.seek(0)
            buf.truncate()
        return got

    def close(self) -> None:
        sys.stdout, sys.stderr = self._saved


class _CapLog(logging.Handler):
    """pytest's caplog, reduced to records, text and at_level: the log
    records that reach the root logger from the moment the case asks for
    it until close()."""

    def __init__(self):
        super().__init__(logging.NOTSET)
        self.records = []
        logging.getLogger().addHandler(self)

    def emit(self, record) -> None:
        self.records.append(record)

    @property
    def text(self) -> str:
        return "\n".join(r.getMessage() for r in self.records)

    @contextlib.contextmanager
    def at_level(self, level, logger=None):
        target = logging.getLogger(logger)
        saved = target.level, self.level
        target.setLevel(level)
        self.setLevel(level)
        try:
            yield
        finally:
            target.setLevel(saved[0])
            self.setLevel(saved[1])

    def close(self) -> None:
        logging.getLogger().removeHandler(self)
        super().close()


_CAPTURES = {"capsys": _CapSys, "caplog": _CapLog}


def _xunit(owner, name: str, fn) -> None:
    """owner.name(fn) or owner.name(), where the class defines it."""
    method = getattr(owner, name, None)
    if method is not None:
        method(*[fn][:len(inspect.signature(method).parameters)])


def run_case(filename: str, case: str, root: str) -> dict:
    """Run one test of tests/`filename` on `root` (every parameter set of
    it): {"outcomes": [...], "closes": [...]}."""
    mod = load(filename, root)
    cls_name, _, fn_name = case.rpartition(".")
    owner = getattr(mod, cls_name)() if cls_name else None
    fn = getattr(owner if owner is not None else mod, fn_name)
    raw = getattr(type(owner), fn_name) if owner is not None else fn
    outcomes, closes = [], []
    for params in _params(raw):
        with tempfile.TemporaryDirectory() as tmp, \
                pytest.MonkeyPatch.context() as mp, \
                recording(root, closes):
            (Path(tmp) / "case").mkdir()
            made = {"tmp_path": Path(tmp) / "case", "monkeypatch": mp,
                    "tmp_path_factory": _TmpPathFactory(Path(tmp))}
            teardown = []

            def resolve(name):
                if name in params:
                    return params[name]
                if name in _CAPTURES and name not in made:
                    made[name] = _CAPTURES[name]()
                if name not in made:
                    fixture = getattr(owner, name, None) or getattr(mod, name)
                    args = [resolve(p) for p, v in
                            inspect.signature(fixture).parameters.items()
                            if v.default is inspect.Parameter.empty]
                    if inspect.isgeneratorfunction(fixture):
                        gen = fixture(*args)
                        made[name] = next(gen)
                        teardown.append(gen)
                    else:
                        made[name] = fixture(*args)
                return made[name]

            def call():
                for name in (mod.__mirror_autouse__[None]
                             + mod.__mirror_autouse__.get(cls_name, [])):
                    resolve(name)
                _xunit(owner, "setup_method", fn)
                args = {p: resolve(p)
                        for p in inspect.signature(fn).parameters}
                try:
                    fn(**args)
                finally:
                    _xunit(owner, "teardown_method", fn)

            outcomes.append(_outcome(call))
            for name in _CAPTURES:
                if name in made:
                    made[name].close()
            for gen in reversed(teardown):
                with contextlib.suppress(StopIteration):
                    next(gen)
    return {"outcomes": outcomes, "closes": closes}


def assert_mirrored(filename: str, case: str) -> dict:
    """The case on both roots: the reference passes it, and the port's
    outcomes and every close (hash, result set bytes) equal the
    reference's."""
    ref = run_case(filename, case, REF)
    assert all(o[0] != "fail" for o in ref["outcomes"]), ref["outcomes"]
    port = run_case(filename, case, PORT)
    for i, (a, b) in enumerate(zip(port["closes"], ref["closes"])):
        assert a == b, f"close {i} of {case}: port {a!r} != reference {b!r}"
    assert len(port["closes"]) == len(ref["closes"])
    assert port["outcomes"] == ref["outcomes"]
    return ref


# -- the helper's own checks --------------------------------------------------

def test_rewrite_points_every_name_at_the_root():
    src = ("from stellar_core_tpu import xdr as X\n"
           "import stellar_core_tpu.ledger.manager\n"
           "@pytest.fixture\ndef mgr():\n    pass\n"
           "@pytest.fixture(scope='module')\ndef root(mgr):\n    pass\n")
    out = rewrite(src, PORT)
    assert "from stellar_core_tpu_torch import xdr as X" in out
    assert "import stellar_core_tpu_torch.ledger.manager" in out
    assert "@pytest" not in out and "def root(mgr)" in out
    assert rewrite(out, PORT).count("stellar_core_tpu_torch_torch") == 0
    paths = ('IN_SCOPE = "stellar_core_tpu/scp/mod.py"\n'
             'lint(tmp_path, "bench.py")\nq = root / "workbench.py"\n')
    assert rewrite(paths, PORT) == (
        'IN_SCOPE = "stellar_core_tpu_torch/scp/mod.py"\n'
        'lint(tmp_path, "chip_smoke.py")\nq = root / "workbench.py"\n')
    assert rewrite(paths, REF) == paths


def test_cases_leave_out_what_the_port_lacks():
    assert ported(".ledger.manager") and ported(".xdr")
    assert ported("._capply") and ported(".catchup.catchup")
    assert ported("._cquorum") and ported(".scp") and ported(".herder.herder")
    assert ported(".herder.tx_queue") and ported(".herder.admission")
    # the overlay and the application, ported now
    assert ported(".overlay") and ported(".overlay.peer")
    assert ported(".main.application") and ported(".simulation.simulation")
    # the chaos campaigns, the fuzzers and the fleet, ported now; and the
    # last slice, lint and hashseed_diff
    assert ported(".simulation.chaos") and ported(".fuzz")
    assert ported(".simulation.fleet") and ported(".util.fleettrace")
    assert ported(".lint") and ported(".simulation.hashseed_diff")
    assert ported(".lint.rules.determinism") and ported(".lint.clex")
    assert unported("from stellar_core_tpu.overlay.peer import Peer\n"
                    "from stellar_core_tpu import scp, overlay, fuzz, xdr\n"
                    "from stellar_core_tpu.simulation.chaos import C\n"
                    "import stellar_core_tpu.simulation.hashseed_diff\n"
                    "import stellar_core_tpu.simulation.simulation\n"
                    "import stellar_core_tpu.lint.rules\n") == []
    # a module the port does not have is still caught
    assert unported("import stellar_core_tpu.no_such_module\n") \
        == [".no_such_module"]
    names = cases("test_tx_apply.py")
    assert "test_fee_bump" in names
    # imports catchup and history.manager in its body, both ported now
    assert "test_same_source_apply_order_survives_replay" in names
    # imports herder.tx_queue in its body, ported now
    assert "test_surge_pricing_counts_txs_below_11_and_ops_after" \
        in cases("test_protocol_versions.py")
    # runs an AdmissionCampaign, whose pipeline (herder.admission) is
    # ported now
    assert unported("c = AdmissionCampaign(8)\n") == []
    soroban = cases("test_soroban.py")
    assert "TestFootprintScheduler.test_admission_campaign_soroban_mix" \
        in soroban
    assert "TestFootprintScheduler.test_mixed_campaign_50_ledgers_hash_identity" \
        in soroban


def test_a_different_close_is_caught(monkeypatch):
    """The comparison sees a port that closes one ledger differently."""
    from stellar_core_tpu_torch.transactions import frame
    orig = frame.TransactionFrame.apply

    def apply(self, ltx, close_time):
        res = orig(self, ltx, close_time)
        res.feeCharged += 1
        return res

    monkeypatch.setattr(frame.TransactionFrame, "apply", apply)
    with pytest.raises(AssertionError, match="close 0 of"):
        assert_mirrored("test_tx_apply.py", "test_create_account_and_payment")


def test_capsys_and_caplog_capture_what_the_case_writes():
    out = _CapSys()
    try:
        print("to stdout")
        print("to stderr", file=sys.stderr)
        got = out.readouterr()
        assert (got.out, got.err) == ("to stdout\n", "to stderr\n")
        assert out.readouterr().out == ""
    finally:
        out.close()
    log = _CapLog()
    try:
        with log.at_level(logging.WARNING, logger="mirror.test"):
            logging.getLogger("mirror.test").info("dropped")
            logging.getLogger("mirror.test").warning("kept")
        assert [r.getMessage() for r in log.records] == ["kept"]
        assert log.text == "kept"
    finally:
        log.close()
    assert log not in logging.getLogger().handlers
