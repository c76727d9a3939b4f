"""Import and device rules of the port.

``skghoi_torch`` and ``chip_smoke.py`` import nothing of JAX, flax, the JAX
package or torchvision (checked on the source, by AST).  Entry points run on
CUDA unless the caller names the CPU: without a card they raise instead of
falling back, ``train_hicodet`` under torchrun's environment too.  The
port's tests remove what they write (checked on their source, by AST): every
``tmp_path_factory.mktemp`` directory is removed by its fixture after the
``yield``, and a test file that writes checkpoints overrides ``tmp_path`` with
a fixture that removes the test's directory when it ends.  Every field of
a flax module of the JAX package that a JAX caller sets, where the port has
a class of that name, is an ``__init__`` argument there, or is listed with
its reason (checked on the sources of both, by AST).  ``RoIAlignFunction``'s
backward reaches no ``roi_align_adjoint``, ``matmul`` or ``einsum`` through
any helper of its module (by AST): on the card it runs the adjoint kernel.
Every ``span`` of the port names an entry of ``utils.profiling.SPANS`` and
each entry is opened; none sits in a loop under ``ops/``; only
``utils/profiling.py`` calls ``record_function`` (by AST).
``chip_smoke.py`` keeps no copy of the RoIAlign bounds that
``hoibench/roofline.py`` computes, and imports them from there (by AST).
"""

import ast
import os
from pathlib import Path

import pytest
import torch

from skghoi_torch.data.factory import to_device
from skghoi_torch.device import resolve_device
from skghoi_torch.entry import build_model, entry, make_batch, verb_mask
from skghoi_torch.models.backbone import DetectorBackbone
from skghoi_torch.models.scg import SpatiallyConditionedGraph
from skghoi_torch.ops.roi_align_cuda import roi_align_cuda
from skghoi_torch.detect.adamixer import AdaMixerDetector
from skghoi_torch.detect.detector import FPNDetector
from skghoi_torch.detect.detr import DETR
from skghoi_torch.detect.frcnn import FasterRCNN
from skghoi_torch.tools import (bench_io, cache_results, demo, extract_roi_features, perf_report,
                                preprocess_detections, pretrain_transh_hoi, stage_profile,
                                test_hicodet, train_detector, train_hicodet, train_kge,
                                visualise_detections)
from skghoi_torch.utils.profiling import SPANS

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "skghoi_tpu", "__graft_entry__", "bench",
             "torchvision")
SOURCES = sorted((ROOT / "skghoi_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
_NOWHERE = str(ROOT / "checkout_check" / "no-such-dir")  # the CLIs must raise before writing


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_sources_scanned():
    names = {p.name for p in SOURCES}
    assert {"roi_align_cuda.py", "scg.py", "weights.py", "chip_smoke.py", "factory.py",
            "engine.py", "checkpoint.py", "hoi_eval.py", "train_hicodet.py", "sampling.py",
            "trainer.py", "tester.py", "train_kge.py", "pretrain_transh_hoi.py",
            "vcoco_eval.py", "vcoco_evaluation.py", "distributed.py", "mesh.py", "frcnn.py",
            "generate.py", "eval_detections.py", "preprocess_detections.py", "hico_meta.py",
            "text_label.py", "logging.py", "profiling.py", "hicodet_split.py", "navigator.py",
            "generate_html_page.py", "learning_curve.py", "kge_results_table.py",
            "kge_relation_stats.py", "visualise_and_cache.py", "visualise_detections.py",
            "demo.py", "extract_roi_features.py", "bench_io.py", "perf_report.py",
            "stage_profile.py"} <= names
    assert ROOT / "skghoi_torch" / "utils" / "__init__.py" in SOURCES
    assert ROOT / "skghoi_torch" / "detect" / "__init__.py" in SOURCES


# What ``hoibench/roofline.py`` computes; ``chip_smoke.py`` reads it from there.
YARDSTICK = {"sample_cells", "roi_bound_ms", "adjoint_kernel_ops"}


def _yardstick_copies(source):
    """(the yardstick's names that ``source`` defines, whether it imports
    ``hoibench.roofline``)."""
    tree = ast.parse(source)
    defined = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)} & YARDSTICK
    imports = any((isinstance(n, ast.ImportFrom) and n.module == "hoibench.roofline")
                  or (isinstance(n, ast.Import) and "hoibench.roofline" in [a.name for a in n.names])
                  for n in ast.walk(tree))
    return sorted(defined), imports


def test_chip_smoke_reads_the_benchmark_yardstick():
    """``chip_smoke.py`` keeps no copy of the bounds the benchmark counts."""
    assert _yardstick_copies((ROOT / "chip_smoke.py").read_text()) == ([], True)


def test_yardstick_rule_sees_what_it_checks():
    copy = "def roi_bound_ms(maps, boxes):\n    def sample_cells(b, hw):\n        pass\n"
    assert _yardstick_copies(copy) == (["roi_bound_ms", "sample_cells"], False)
    assert _yardstick_copies("import hoibench.roofline\n") == ([], True)
    assert _yardstick_copies("from hoibench.roofline import sample_cells\n") == ([], True)


@pytest.mark.parametrize("build", [
    lambda: resolve_device(None),
    lambda: resolve_device("cuda"),
    lambda: SpatiallyConditionedGraph(),
    lambda: DetectorBackbone(),
    lambda: build_model(),
    lambda: make_batch(1, (64, 96)),
    lambda: verb_mask(),
    lambda: to_device(make_batch(1, (64, 96), device="cpu")),
    lambda: train_hicodet.main(["--synthetic", "--synthetic-root", _NOWHERE]),
    lambda: test_hicodet.main(["--synthetic", "--synthetic-root", _NOWHERE]),
    lambda: cache_results.main(["--dataset", "hicodet", "--synthetic", "--synthetic-root",
                                _NOWHERE]),
    lambda: train_kge.main(["--data", _NOWHERE, "--checkpoint", _NOWHERE + "/kge.pt"]),
    lambda: pretrain_transh_hoi.main(["--synthetic", "--output", _NOWHERE + "/transh.pt"]),
    lambda: FasterRCNN(),
    lambda: preprocess_detections.main(["--ckpt-path", _NOWHERE + "/frcnn.pt", "--data-root",
                                        _NOWHERE, "--cache-dir", _NOWHERE]),
    lambda: train_kge.main(["--data", _NOWHERE, "--data-parallel"]),
    lambda: FPNDetector(),
    lambda: AdaMixerDetector(),
    lambda: DETR(),
    lambda: train_detector.main(["--synthetic", "--synthetic-root", _NOWHERE, "--cache-dir",
                                 _NOWHERE]),
    lambda: demo.main(["--data-root", _NOWHERE, "--output", _NOWHERE + "/overlay.png"]),
    lambda: extract_roi_features.main(["--data-root", _NOWHERE, "--output-dir", _NOWHERE]),
    lambda: visualise_detections.main(["--data-root", _NOWHERE, "--detection-root", _NOWHERE,
                                       "--out-file", _NOWHERE + "/result.jpg"]),
    lambda: perf_report.report(1, (64, 96), trace_dir=_NOWHERE),
    lambda: stage_profile.profile(1, (64, 96)),
    lambda: bench_io.main(["--root", _NOWHERE, "--train"]),
], ids=["resolve", "resolve-cuda", "scg", "backbone", "build_model", "make_batch", "verb_mask",
        "to_device", "train_hicodet", "test_hicodet", "cache_results", "train_kge",
        "pretrain_transh_hoi", "frcnn", "preprocess_detections", "train_kge-data-parallel",
        "fpn_detector", "adamixer", "detr", "train_detector", "demo", "extract_roi_features",
        "visualise_detections", "perf_report", "stage_profile", "bench_io"])
def test_default_device_is_cuda(build):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
    assert not os.path.exists(_NOWHERE)


def test_torchrun_train_hicodet_needs_a_card(monkeypatch):
    """Under torchrun's environment the process takes the card of its
    ``LOCAL_RANK``, and raises without one before it joins a group."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_hicodet.main(["--synthetic", "--synthetic-root", _NOWHERE])
    assert not os.path.exists(_NOWHERE) and not torch.distributed.is_initialized()


def test_kernel_wrapper_refuses_cpu():
    maps = [torch.zeros(1, 8 // s, 8 // s, 4) for s in (1, 2, 4, 8)]
    boxes = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_cuda(maps, boxes)


def test_cpu_on_request():
    assert resolve_device("cpu") == torch.device("cpu")
    fn, (batch,) = entry(device="cpu", dtype=torch.float32)
    assert batch.images.device.type == "cpu" and batch.images.shape == (1, 832, 1344, 3)
    scores = fn(batch)
    assert scores.shape == (1, 15, 30, 117) and torch.isfinite(scores).all()


# --- the card's backward is the adjoint kernel ----------------------------------

GEMM_ROUTE = {"roi_align_adjoint", "matmul", "einsum", "bmm", "baddbmm", "mm"}


def _callee(call):
    return call.func.id if isinstance(call.func, ast.Name) else getattr(call.func, "attr", None)


def _reached_calls(tree, cls, method):
    """Names of every call reached from ``cls.method``, following calls of the
    module's own functions and methods (by name) into their bodies."""
    defs = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            defs[node.name] = node
        elif isinstance(node, ast.ClassDef):
            defs.update({f.name: f for f in node.body if isinstance(f, ast.FunctionDef)})
    start = next(f for c in tree.body if isinstance(c, ast.ClassDef) and c.name == cls
                 for f in c.body if isinstance(f, ast.FunctionDef) and f.name == method)
    reached, todo, seen = set(), [start], set()
    while todo:
        fn = todo.pop()
        if fn.name in seen:
            continue
        seen.add(fn.name)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and _callee(node):
                reached.add(_callee(node))
                if _callee(node) in defs:
                    todo.append(defs[_callee(node)])
    return reached


def test_backward_reaches_no_gemm_route():
    """On the card ``RoIAlignFunction.backward`` runs the adjoint kernel and
    nothing of the plain GEMM route (``roi_align_adjoint``, ``matmul``,
    ``einsum``), however deep in the module's own helpers."""
    tree = ast.parse((ROOT / "skghoi_torch" / "ops" / "roi_align_cuda.py").read_text())
    reached = _reached_calls(tree, "RoIAlignFunction", "backward")
    assert {"adjoint", "_check_adjoint_inputs", "_launch"} <= reached
    assert not reached & GEMM_ROUTE, sorted(reached & GEMM_ROUTE)


def test_backward_rule_sees_what_it_checks():
    """The scan follows a helper's helper and catches the GEMM route there."""
    tree = ast.parse(
        "class RoIAlignFunction:\n"
        "    def backward(ctx, g):\n"
        "        return helper(g)\n"
        "def helper(g):\n"
        "    return roi_align_cuda.inner(g)\n"
        "class K:\n"
        "    def inner(self, g):\n"
        "        return torch.matmul(g, g)\n")
    assert _reached_calls(tree, "RoIAlignFunction", "backward") & GEMM_ROUTE == {"matmul"}


# --- the port's tests remove what they write ------------------------------------

TEST_FILES = sorted((ROOT / "tests").glob("test_torch_*.py"))
WRITER_TOOLS = ("train_hicodet", "train_detector", "pretrain_transh_hoi")


def _is_rmtree(node):
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "rmtree" and getattr(node.func.value, "id", None) == "shutil")


def _removes_after_yield(fn, names):
    """Whether the generator ``fn`` calls ``shutil.rmtree`` after its
    ``yield`` (later in its body, or in a ``finally`` around it), in code
    that names each of ``names``."""
    yields = [n.end_lineno for n in ast.walk(fn) if isinstance(n, (ast.Yield, ast.YieldFrom))]
    if not yields:
        return False
    after = [n for n in ast.walk(fn) if getattr(n, "lineno", 0) > max(yields)]
    seen = {n.id for n in after if isinstance(n, ast.Name)}
    return any(map(_is_rmtree, after)) and set(names) <= seen


def _is_fixture(fn):
    return any("fixture" in ast.unparse(d) for d in fn.decorator_list)


def _mktemp_fixtures(tree):
    """``(function, names bound to its mktemp directories)`` for each
    function that calls ``tmp_path_factory.mktemp``."""
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Attribute) and n.func.attr == "mktemp"
                 and getattr(n.func.value, "id", None) == "tmp_path_factory"]
        if not calls:
            continue
        names = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and any(c in ast.walk(node.value) for c in calls):
                for target in node.targets:
                    base = target.value if isinstance(target, ast.Subscript) else target
                    names |= {n.id for n in ast.walk(base) if isinstance(n, ast.Name)}
        out.append((fn, names))
    return out


def _writes_checkpoints(tree):
    """Whether the file calls a checkpoint writer: ``save_checkpoint``, an
    engine given a ``cache_dir``, or the ``main`` of ``train_hicodet``,
    ``train_detector``, ``pretrain_transh_hoi`` or ``bench_io --train``.
    Calls given ``_NOWHERE`` must raise before they write, and do not count."""
    for call in ast.walk(tree):
        if not isinstance(call, ast.Call):
            continue
        inside = list(ast.walk(call))
        if any(isinstance(n, ast.Name) and "nowhere" in n.id.lower() for n in inside):
            continue
        func = call.func
        name = func.id if isinstance(func, ast.Name) else getattr(func, "attr", "")
        owner = getattr(getattr(func, "value", None), "id", None)
        if isinstance(func, ast.Name) and name.endswith("save_checkpoint"):
            return True
        if name.endswith("Engine") and any(k.arg == "cache_dir" for k in call.keywords):
            return True
        if name == "main" and (owner in WRITER_TOOLS or (owner == "bench_io" and any(
                isinstance(n, ast.Constant) and n.value == "--train" for n in inside))):
            return True
    return False


def _has_tmp_path_cleanup(tree):
    """A module-level ``tmp_path`` fixture over pytest's that removes it."""
    return any(isinstance(fn, ast.FunctionDef) and fn.name == "tmp_path" and _is_fixture(fn)
               and [a.arg for a in fn.args.args] == ["tmp_path"]
               and _removes_after_yield(fn, {"tmp_path"}) for fn in tree.body)


@pytest.mark.parametrize("path", TEST_FILES, ids=lambda p: p.name)
def test_tests_remove_what_they_write(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for fn, names in _mktemp_fixtures(tree):
        assert _is_fixture(fn) and names, f"{path.name}:{fn.lineno} {fn.name}"
        assert _removes_after_yield(fn, names), (
            f"{path.name}:{fn.lineno} {fn.name} does not remove {sorted(names)} after its yield")
    if _writes_checkpoints(tree):
        assert _has_tmp_path_cleanup(tree), f"{path.name} writes checkpoints and keeps tmp_path"


def test_cleanup_rules_see_what_they_check():
    """The scan finds today's writers and fixtures, and refuses a fixture that
    removes another directory than its own, and a writer whose ``tmp_path``
    fixture removes the directory before the test instead of after it."""
    trees = {p.name[len("test_torch_port_"):-3]: ast.parse(p.read_text()) for p in TEST_FILES
             if p.name.startswith("test_torch_port_")}
    assert {"engine", "ddp", "cli", "train_detector", "measure", "tools", "checkpoint"} <= {
        name for name, tree in trees.items() if _writes_checkpoints(tree)}
    assert not _writes_checkpoints(trees["rules"])  # its CLI calls raise before writing
    assert {"engine", "ddp", "tools", "detect_tools", "data", "eval"} <= {
        name for name, tree in trees.items() if _mktemp_fixtures(tree)}
    assert [sorted(names) for _, names in _mktemp_fixtures(trees["engine"])] == [["cache", "root"]]

    kept = ast.parse(
        "@pytest.fixture(scope='module')\n"
        "def root(tmp_path_factory):\n"
        "    root = str(tmp_path_factory.mktemp('x'))\n"
        "    yield root\n"
        "    shutil.rmtree(other)\n")
    ((fn, names),) = _mktemp_fixtures(kept)
    assert names == {"root"} and not _removes_after_yield(fn, names)
    returned = ast.parse(
        "@pytest.fixture\n"
        "def tmp_path(tmp_path):\n"
        "    shutil.rmtree(tmp_path)\n"
        "    return tmp_path\n"
        "def test_x(tmp_path):\n"
        "    train_hicodet.main(['--cache-dir', str(tmp_path)])\n")
    assert _writes_checkpoints(returned) and not _has_tmp_path_cleanup(returned)


# --- the port's modules take the JAX fields that JAX's callers set ------------------

# (class, JAX field) -> why the port's class takes no argument of that name:
# ("renamed", its name in the port) or ("not to port", why).
FIELD_EXCEPTIONS = {
    ("ResNet50", "scan_blocks"): ("not to port", "nn.scan of same-shape blocks: a compile lever"),
    ("DetectorBackbone", "scan_blocks"): ("not to port", "passed to ResNet50"),
    ("SpatiallyConditionedGraph", "scan_blocks"): ("not to port", "passed to ResNet50"),
    ("Bottleneck", "features"): ("renamed", "width"),
    ("Bottleneck", "strides"): ("renamed", "stride"),
}


def _flax_modules():
    """(file, class) -> its dataclass fields with their defaults' source
    (None: no default), inherited ones first, for every flax module of the
    JAX package (a class of ``nn.Module`` in a file that imports
    ``flax.linen``)."""
    out = {}
    for path in sorted((ROOT / "skghoi_tpu").rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        if "flax.linen" not in set(_imported_modules(tree)):
            continue
        local = {}
        for cls in tree.body:
            if not isinstance(cls, ast.ClassDef):
                continue
            bases = [ast.unparse(b) for b in cls.bases]
            if "nn.Module" not in bases and not set(bases) & set(local):
                continue
            fields = {f: d for b in bases for f, d in local.get(b, {}).items()}
            for n in cls.body:
                if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
                    fields[n.target.id] = None if n.value is None else ast.unparse(n.value)
            local[cls.name] = fields
            out[(path.relative_to(ROOT).as_posix(), cls.name)] = fields
    return out


def _imported_modules(tree):
    for node in tree.body:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _jax_callers():
    """The JAX package's sources and its entry scripts: every file but the
    tests."""
    return sorted((ROOT / "skghoi_tpu").rglob("*.py")) + [ROOT / "bench.py",
                                                           ROOT / "__graft_entry__.py"]


def _flax_calls(tree, flax_names):
    """Yield (enclosing flax class or None, called class, {field: value})
    for each call of a JAX package flax class in ``tree``: a name bound by a
    class of the file or an import from ``skghoi_tpu``, or an attribute of a
    module imported from it.  Positional arguments take the fields in order."""
    names, modules = {}, set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            ours = node.level > 0 or (node.module or "").startswith("skghoi_tpu")
            for a in node.names if ours else ():
                if a.name in flax_names:
                    names[a.asname or a.name] = a.name
                else:
                    modules.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            modules.update(a.asname or a.name for a in node.names
                           if a.name.startswith("skghoi_tpu"))
    for cls in tree.body:
        if isinstance(cls, ast.ClassDef) and cls.name in flax_names:
            names[cls.name] = cls.name

    def visit(node, owner):
        if isinstance(node, ast.ClassDef):
            owner = node.name if node.name in flax_names else None
        if isinstance(node, ast.Call):
            f = node.func
            called = (names.get(f.id) if isinstance(f, ast.Name) else
                      f.attr if isinstance(f, ast.Attribute) and f.attr in flax_names
                      and ast.unparse(f.value) in modules else None)
            if called:
                yield owner, called, node
        for child in ast.iter_child_nodes(node):
            yield from visit(child, owner)

    yield from visit(tree, None)


def _jax_fields_set():
    """(class, field) for every field of a JAX flax module that a JAX caller
    sets to something other than its default: a value other than the
    default's source, or ``self.<g>`` inside a flax module whose own ``g``
    is so set (followed to a fixed point)."""
    modules = _flax_modules()
    fields = {}
    for (_, name), f in modules.items():
        fields.setdefault(name, {}).update(f)
    direct, through = set(), set()
    for path in _jax_callers():
        tree = ast.parse(path.read_text(), filename=str(path))
        for owner, called, call in _flax_calls(tree, fields):
            order = [f for f in fields[called] if f not in ("parent", "name")]
            given = dict(zip(order, call.args))
            given.update((k.arg, k.value) for k in call.keywords if k.arg)
            for field, value in given.items():
                src = ast.unparse(value)
                if field not in fields[called] or src == fields[called][field]:
                    continue
                if owner and src.startswith("self.") and src[5:] in fields[owner]:
                    through.add(((owner, src[5:]), (called, field)))
                else:
                    direct.add((called, field))
    used = set(direct)
    while True:
        more = {dst for src, dst in through if src in used} - used
        if not more:
            return used
        used |= more


def _port_init_args():
    """class name -> the argument names of its ``__init__`` (a class without
    one takes its first base's in the same file), for the port's classes."""
    out = {}
    for path in sorted((ROOT / "skghoi_torch").rglob("*.py")):
        for cls in ast.parse(path.read_text(), filename=str(path)).body:
            if not isinstance(cls, ast.ClassDef):
                continue
            init = [n for n in cls.body if isinstance(n, ast.FunctionDef) and n.name == "__init__"]
            if init:
                a = init[0].args
                out[cls.name] = {x.arg for x in a.args[1:] + a.kwonlyargs}
            elif cls.bases and ast.unparse(cls.bases[0]) in out:
                out[cls.name] = out[ast.unparse(cls.bases[0])]
    return out


def _missing(used, port):
    """The set fields of classes the port has that its ``__init__`` does not
    take and no exception covers, and the exceptions that went unused."""
    missing, excused = [], set()
    for name, field in sorted(used):
        if name not in port or field in port[name]:
            continue
        reason = FIELD_EXCEPTIONS.get((name, field))
        if reason is None or (reason[0] == "renamed" and reason[1] not in port[name]):
            missing.append(f"{name}.{field}")
        excused.add((name, field))
    return missing, set(FIELD_EXCEPTIONS) - excused


def test_port_modules_take_the_jax_fields():
    """Every field that a JAX caller sets (``_jax_fields_set``) of a flax
    module whose class the port has too is an ``__init__`` argument of the
    port's class, or is listed in ``FIELD_EXCEPTIONS`` with its reason."""
    missing, stale = _missing(_jax_fields_set(), _port_init_args())
    assert not missing, f"fields JAX's callers set that the port's classes do not take: {missing}"
    assert not stale, f"stale exceptions: {stale}"


def test_jax_fields_rule_sees_what_it_checks():
    """The rule finds the fields it is about: ``bench.py --stage1``'s
    ``DETR(dtype=jnp.bfloat16)`` and, through ``dtype=self.dtype``, the
    ResNet-50 under it; the SCG's own backbone dtype; never a field left at
    its default (AdaMixer's and the FPN detector's ``dtype``, the SCG's
    ``fg_iou_thresh``, ``transh_margin``, ``max_transh_pairs``).  Without DETR's ``dtype`` in the port the rule fails."""
    used, port = _jax_fields_set(), _port_init_args()
    assert {("DETR", "dtype"), ("ResNet50", "dtype"), ("SpatiallyConditionedGraph", "dtype"),
            ("DetectorBackbone", "dtype")} <= used
    assert not {f for f in used if f[1] in ("fg_iou_thresh", "transh_margin", "max_transh_pairs")
                or f in {("AdaMixerDetector", "dtype"), ("FPNDetector", "dtype")}}
    port["DETR"] = port["DETR"] - {"dtype"}
    assert _missing(used, port)[0] == ["DETR.dtype"]


# --- the program's named spans ----------------------------------------------------

SPAN_CALLS = ("span", "record_function")


def _span_faults(sources):
    """What breaks the span rule in ``{path under skghoi_torch/: source}``:
    a ``span`` whose name is not a literal entry of ``SPANS``, an entry no
    ``span`` opens, a ``span`` or ``record_function`` inside a loop under
    ``ops/``, and a ``record_function`` outside ``utils/profiling.py``."""
    faults, opened = [], set()
    for path, text in sorted(sources.items()):
        tree = ast.parse(text, filename=path)
        looped = set()
        if path.startswith("ops/"):
            for loop in ast.walk(tree):
                if isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                    looped |= {id(n) for stmt in loop.body + loop.orelse for n in ast.walk(stmt)}
        for node in ast.walk(tree):
            name = _callee(node) if isinstance(node, ast.Call) else None
            if name not in SPAN_CALLS:
                continue
            where = f"{path}:{node.lineno}"
            if id(node) in looped:
                faults.append(f"{where}: {name} in a loop")
            if name == "record_function" and path != "utils/profiling.py":
                faults.append(f"{where}: record_function outside utils/profiling.py")
            if name == "span":
                arg = node.args[0] if node.args else None
                if isinstance(arg, ast.Constant) and arg.value in SPANS:
                    opened.add(arg.value)
                else:
                    faults.append(f"{where}: span not in SPANS")
    return faults + [f"SPANS entry {s!r} opened nowhere" for s in SPANS if s not in opened]


def test_spans_are_named_once_and_kept_out_of_loops():
    """Every ``span`` of the port names an entry of ``utils.profiling.SPANS``,
    every entry is opened somewhere, no span sits in a loop under ``ops/``,
    and only ``utils/profiling.py`` calls ``record_function``."""
    port = ROOT / "skghoi_torch"
    sources = {str(p.relative_to(port)): p.read_text() for p in port.rglob("*.py")}
    assert _span_faults(sources) == []


def test_span_rule_sees_what_it_checks():
    """A span in NMS's loop, a name outside ``SPANS``, a direct
    ``record_function`` and the entries left unopened are each refused."""
    planted = {
        "ops/boxes.py": ("def nms_keep(n):\n"
                         "    for j in range(n):\n"
                         "        with span('filter'):\n"
                         "            pass\n"),
        "models/head.py": ("def head(x):\n"
                           "    with torch.profiler.record_function('head'):\n"
                           "        with span('graph_head'):\n"
                           "            return x\n"),
    }
    assert _span_faults(planted) == [
        "models/head.py:2: record_function outside utils/profiling.py",
        "models/head.py:3: span not in SPANS",
        "ops/boxes.py:3: span in a loop",
    ] + [f"SPANS entry {s!r} opened nowhere" for s in SPANS if s != "filter"]
