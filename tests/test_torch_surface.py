"""The port's surface against the JAX package's, read from the source with
``ast`` (neither package is imported):

  - every module file of kvquant_tpu/ has a port module at the same
    relative path in kvquant_tpu_torch/ (the one mapped pair:
    ops/pallas/<m>.py -> ops/kernels/<m>.py, the Pallas kernels and their
    Hopper wrappers);
  - every public top-level function, class and constant a JAX module
    defines is defined under the same name in its port module, or stands
    in ELSEWHERE below with the counterpart it has (checked to exist) and
    why the name differs;
  - every --flag of each kvquant_tpu/cli/<x>.py parser is accepted by the
    port's cli/<x>.py parser (flags added by helpers in cli/common.py or a
    sibling cli module are followed).

A name or module added to the JAX package without a counterpart fails
here, so a later change there shows up as a gap of the port."""

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(REPO, "kvquant_tpu")
PORT = os.path.join(REPO, "kvquant_tpu_torch")

# (JAX module, name) -> (port file, counterpart, why the name differs).
# The counterpart is a top-level name of the port module ("Class.field"
# for a class attribute) or, for a csrc/ file, text found in it.
ELSEWHERE = {
    ("paged.py", "paged_flash_decode"): (
        "ops/kernels/paged_decode.py", "paged_flash_decode",
        "K5's wrapper sits with the other kernel wrappers; paged.py imports "
        "it under the same name"),
    ("paged.py", "PAGE_TOKENS"): (
        "cache.py", "DeployConfig.page_tokens",
        "JAX's constant is only the default of DeployConfig.page_tokens "
        "(1024 in both); the port keeps the field alone"),
    ("ops/packing.py", "set_token_codes_int"): (
        "ops/packing.py", "set_token_rows",
        "intN codes are encoded into their container first "
        "(store_codes_int, ops/deployed._encode_rows) and written as rows: "
        "set_token_rows at a host position, write_rows at device positions"),
    ("ops/packing.py", "set_token_codes_int_at_layer"): (
        "ops/packing.py", "write_rows",
        "a torch layer arr[li] is a view written in place, so the append "
        "writes the layer's rows with write_rows at per-sample device "
        "positions"),
    ("ops/packing.py", "set_token_rows_at_layer"): (
        "ops/packing.py", "set_token_rows",
        "the same in-place view: set_token_rows (host position) or "
        "write_rows (device positions) on arr[li]"),
    ("ops/deployed.py", "rotate_half_axis"): (
        "models/llama.py", "rotate_half",
        "JAX calls it only with axis=-1 (ops/deployed.py:395, :895); the "
        "port's deployed path imports models.llama.rotate_half"),
    ("ops/pallas/attention.py", "GROUP"): (
        "ops/packing.py", "GROUP",
        "the packing group is defined once, in the port's packing module"),
    ("ops/pallas/attention.py", "WPG"): (
        "ops/packing.py", "WPG",
        "the words per group and plane, defined beside GROUP"),
    ("ops/pallas/flash_decode.py", "NEG"): (
        "csrc/flash_decode.cu", "-INFINITY",
        "Pallas needs a finite mask value; the CUDA kernels mask with "
        "-INFINITY and guard the exponent"),
    ("ops/pallas/flash_decode.py", "fold_affine"): (
        "ops/kernels/common.py", "fold_affine",
        "shared by the K1 and K2 wrappers, so it sits in their common "
        "module"),
    ("ops/pallas/flash_decode.py", "prep_constants"): (
        "ops/kernels/flash_decode.py", "run_kernel",
        "the per-call constants go to the kernel as fields of the FdArgs "
        "struct that run_kernel fills (K2: flash_serial._launch, FsArgs), "
        "not as a packed band operand"),
    ("ops/pallas/flash_serial.py", "NB"): (
        "csrc/flash_serial.cu", "MSTAGES",
        "the double buffer of DMA slots is fs_mma's two-stage ring per "
        "warp"),
}


def modules(root):
    """Relative paths of the package's .py files."""
    out = []
    for d, dirs, files in os.walk(root):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        out += [os.path.relpath(os.path.join(d, f), root)
                for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def port_module(rel):
    if rel.startswith("ops/pallas/"):
        return "ops/kernels/" + rel[len("ops/pallas/"):]
    return rel


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read(), path)


def _bound(body):
    """Names a block of statements defines (def, class, assignment)."""
    out = set()
    for n in body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
    return out


def public_names(path):
    return {n for n in _bound(_tree(path).body) if not n.startswith("_")}


def defines(path, name):
    """Whether the port file defines ``name`` ("Class.attr" for a class
    attribute); a csrc/ file: whether the text holds it."""
    if not path.endswith(".py"):
        with open(path) as f:
            return name in f.read()
    body = _tree(path).body
    *outer, last = name.split(".")
    for part in outer:
        body = next((n.body for n in body if isinstance(n, ast.ClassDef)
                     and n.name == part), [])
    return last in _bound(body)


def module_gaps(jax_root, port_root, rel, elsewhere):
    """A JAX module's missing port module or public names without a
    counterpart, as messages."""
    prel = port_module(rel)
    ppath = os.path.join(port_root, prel)
    if not os.path.exists(ppath):
        return [f"{rel}: no port module {prel}"]
    missing = public_names(os.path.join(jax_root, rel)) \
        - _bound(_tree(ppath).body) \
        - {n for (m, n) in elsewhere if m == rel}
    return [f"{rel}: {n} not in {prel} nor in ELSEWHERE"
            for n in sorted(missing)]


def gaps(jax_root, port_root, elsewhere):
    return [g for rel in modules(jax_root)
            for g in module_gaps(jax_root, port_root, rel, elsewhere)]


@pytest.mark.parametrize("rel", modules(JAX))
def test_every_jax_module_has_its_port_module(rel):
    assert os.path.exists(os.path.join(PORT, port_module(rel))), rel


@pytest.mark.parametrize("rel", modules(JAX))
def test_every_public_jax_name_has_a_counterpart(rel):
    got = module_gaps(JAX, PORT, rel, ELSEWHERE)
    assert not got, got


@pytest.mark.parametrize("key", sorted(ELSEWHERE))
def test_each_exception_names_a_counterpart_that_exists(key):
    rel, name = key
    pfile, counterpart, why = ELSEWHERE[key]
    assert name in public_names(os.path.join(JAX, rel)), \
        f"stale entry: {rel} no longer defines {name}"
    assert name not in _bound(_tree(os.path.join(
        PORT, port_module(rel))).body), \
        f"stale entry: the port's {port_module(rel)} defines {name}"
    assert defines(os.path.join(PORT, pfile), counterpart), \
        f"{counterpart} not found in {pfile}"
    assert len(why) > 10


def test_the_native_packer_is_part_of_the_surface():
    """The host packer was the last module without a port: its JAX module
    is listed and its port module defines the same public functions."""
    assert "native/__init__.py" in modules(JAX)
    assert public_names(os.path.join(JAX, "native/__init__.py")) == {
        "have_native", "pack_codes", "unpack_codes", "encode_outliers",
        "decode_outliers"}
    assert os.path.exists(os.path.join(PORT, "csrc", "packing.cpp"))


def test_gaps_catch_a_missing_module_and_a_missing_name(tmp_path):
    """The check itself: a JAX module or name with no counterpart and no
    ELSEWHERE entry is reported; an entry silences only its name."""
    def put(root, rel, text):
        path = tmp_path / root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)

    put("j", "native/__init__.py", "def pack_codes():\n    pass\n")
    put("j", "ops/pallas/k.py", "NB = 2\ndef run():\n    pass\n")
    put("j", "cache.py", "X = 1\n_private = 2\nclass C:\n    pass\n")
    put("p", "ops/kernels/k.py", "def run():\n    pass\n")
    put("p", "cache.py", "class C:\n    pass\n")
    found = gaps(str(tmp_path / "j"), str(tmp_path / "p"), {})
    assert found == ["cache.py: X not in cache.py nor in ELSEWHERE",
                     "native/__init__.py: no port module native/__init__.py",
                     "ops/pallas/k.py: NB not in ops/kernels/k.py nor in "
                     "ELSEWHERE"]
    found = gaps(str(tmp_path / "j"), str(tmp_path / "p"),
                 {("ops/pallas/k.py", "NB"): None})
    assert len(found) == 2 and not any("NB" in g for g in found)


# ---------------------------------------------------------------------------
# CLI flags
# ---------------------------------------------------------------------------


def _cli_module(pkg, mod):
    """(its top-level functions, local name -> (module, function) of the
    functions it imports from sibling cli modules, sibling modules it
    imports by name)."""
    tree = _tree(os.path.join(pkg, "cli", f"{mod}.py"))
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    imported, aliases = {}, {}
    for n in tree.body:
        if isinstance(n, ast.ImportFrom) and n.level == 1:
            for a in n.names:
                if n.module is None:  # from . import common
                    aliases[a.asname or a.name] = a.name
                else:  # from .generate import add_kernel_arg
                    imported[a.asname or a.name] = (n.module, a.name)
    return tree, funcs, imported, aliases


def cli_flags(pkg, mod, node=None, seen=None):
    """The --flags a cli module's parser accepts: add_argument calls in the
    module, and in every cli function it calls, followed across modules."""
    seen = set() if seen is None else seen
    tree, funcs, imported, aliases = _cli_module(pkg, mod)
    out = set()
    for call in ast.walk(tree if node is None else node):
        if not isinstance(call, ast.Call):
            continue
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr == "add_argument":
            out |= {a.value for a in call.args if isinstance(a, ast.Constant)
                    and str(a.value).startswith("--")}
            continue
        target = None
        if isinstance(f, ast.Name):
            target = (mod, f.id) if f.id in funcs else imported.get(f.id)
        elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id in aliases:
            target = (aliases[f.value.id], f.attr)
        if target and target not in seen:
            seen.add(target)
            fn = _cli_module(pkg, target[0])[1].get(target[1])
            if fn is not None:
                out |= cli_flags(pkg, target[0], fn, seen)
    return out


CLI_MODULES = sorted(m[:-3] for m in os.listdir(os.path.join(JAX, "cli"))
                     if m.endswith(".py")
                     and m not in ("__init__.py", "common.py"))


@pytest.mark.parametrize("mod", CLI_MODULES)
def test_every_jax_cli_flag_is_accepted_by_the_port(mod):
    want = cli_flags(JAX, mod)
    got = cli_flags(PORT, mod)
    assert len(want) > 10 and all(re.fullmatch(r"--[a-z0-9-]+", f)
                                  for f in want), want
    assert "--device" in got  # the port's own: cuda (default) or cpu
    assert not want - got, sorted(want - got)


def test_cli_flags_follow_helpers_across_modules():
    """The flags of common.add_model_args and of generate.add_kernel_arg
    (imported by eval_ppl, passkey and needle) are found."""
    assert {"--toy-layers", "--moe", "--model"} <= cli_flags(PORT, "fisher")
    for mod in ("eval_ppl", "passkey", "needle"):
        assert "--kernel" in cli_flags(PORT, mod), mod
        assert "--kernel" in cli_flags(JAX, mod), mod
