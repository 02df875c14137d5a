"""Every public name of the reference (``src/repro/``) has a counterpart in the
port (``src/repro_torch/``), apart from a stated map, and every public
function and method that has one takes the reference's parameters.

Both packages are read with ``ast``; neither is imported.  A public name is
a top-level function, class or assignment whose name does not start with
``_``, and a public method of a public class (found in the class or a base
class the port defines).  Each module of the reference is matched with the
port's module of the same path; the map says where a name went instead, or
why it has no counterpart.

Parameters: for each public function, public method and ``__init__`` of a
public class with a counterpart written out in both packages, the names in
order, their kind (positional or keyword-only), which have a default and
the default's source (``jnp.<dtype>`` read as ``torch.<dtype>``) are the
same, apart from a stated map: parameters the port adds after the
reference's own or keyword-only (every call of the reference's form means
the same there), parameters it names otherwise, and a few functions whose
parameters differ, each with its reason.
"""

import ast
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# reference module -> its counterpart in the port, where the path differs
MODULE_RENAMES = {
    "runtime/hlo_analysis.py": "runtime/comm_analysis.py",  # XLA HLO -> collectives recorded as issued
}

# (reference module, name) -> the port's name (in the counterpart module)
NAME_RENAMES = {
    ("runtime/roofline.py", "ICI_BW"): "NVLINK_BW",  # TPU ICI link -> the card's NVLink
    # collectives as a step issues them, not parsed from HLO text
    ("runtime/hlo_analysis.py", "HloCollectives"): "Collectives",
    ("runtime/hlo_analysis.py", "HloCollectives.to_dict"): "Collectives.to_dict",
    ("runtime/hlo_analysis.py", "HloCollectives.total_link_bytes"): "Collectives.total_link_bytes",
    ("runtime/hlo_analysis.py", "HloCollectives.total_result_bytes"):
        "Collectives.total_result_bytes",
    ("runtime/hlo_analysis.py", "parse_collectives"): "CollectiveRecorder",
    ("runtime/hlo_analysis.py", "parse_collectives_scaled"): "CollectiveRecorder",
    # the port draws n stacked layers at once (init_stack folded in)
    ("models/transformer.py", "init_dense_layer"): "init_dense_layers",
    ("models/transformer.py", "init_moe_layer"): "init_moe_layers",
    ("models/transformer.py", "init_ssm_layer"): "init_ssm_layers",
    ("models/transformer.py", "init_hybrid_sublayer"): "init_hybrid_sublayers",
    ("models/transformer.py", "init_stack"): "init_dense_layers",
    ("models/encdec.py", "init_enc_layer"): "init_enc_layers",
    ("models/encdec.py", "init_dec_layer"): "init_dec_layers",
}

# names with no counterpart, each with its reason
NOT_PORTED = {
    # TPU tile constants of the Pallas kernels: the CUDA kernels size their own tiles
    ("kernels/histogram/kernel.py", "DEFAULT_BT"): "Pallas tile of the TPU kernel",
    ("kernels/histogram/kernel.py", "DEFAULT_KT"): "Pallas tile of the TPU kernel",
    ("kernels/huffman_encode/kernel.py", "DEFAULT_T"): "Pallas tile of the TPU kernel",
    ("kernels/mgard_lerp/kernel.py", "DEFAULT_R"): "Pallas tile of the TPU kernel",
    ("kernels/quantize_map/kernel.py", "DEFAULT_T"): "Pallas tile of the TPU kernel",
    ("kernels/tridiag/kernel.py", "DEFAULT_B"): "Pallas tile of the TPU kernel",
    ("kernels/zfp_block/kernel.py", "DEFAULT_TB"): "Pallas tile of the TPU kernel",
    # XLA-only adapters and buffer donation
    ("core/adapters.py", "XLA"): "the port's backends are torch and cuda",
    ("core/adapters.py", "PALLAS"): "the port's backends are torch and cuda",
    ("core/adapters.py", "PALLAS_INTERPRET"): "the port's backends are torch and cuda",
    ("core/adapters.py", "supports_donation"): "XLA buffer donation; eager torch donates nothing",
    ("core/adapters.py", "donating_jit"): "XLA buffer donation; eager torch donates nothing",
    # the machinery of fused jitted segments: eager PyTorch traces nothing
    ("core/stages/base.py", "TraceEnv"): "a jitted segment's view; eager stages get CallEnv",
    ("core/stages/base.py", "TraceEnv.operand"): "a jitted segment's view; eager stages get CallEnv",
    ("core/stages/base.py", "TraceEnv.static"): "a jitted segment's view; eager stages get CallEnv",
    ("core/stages/base.py", "TraceEnv.workspace"): "a jitted segment's view; eager stages get CallEnv",
    ("core/stages/base.py", "Stage.jit_statics"): "bucketing of statics to reuse XLA traces",
    ("core/stages/base.py", "Stage.merge_static"): "statics of one stacked shard_map trace",
    ("core/stages/library.py", "BitPack.jit_statics"): "bucketing of statics to reuse XLA traces",
    ("core/stages/library.py", "AlphabetBind.merge_static"): "statics of one stacked shard_map trace",
    ("core/stages/library.py", "CodebookBuild.merge_static"): "statics of one stacked shard_map trace",
    ("core/stages/base.py", "CompiledPipeline.device_segments"): "fused XLA segments; eager stages run one by one",
    ("core/stages/base.py", "CompiledPipeline.segment_exe"): "fused XLA segments; eager stages run one by one",
    ("core/stages/base.py", "CompiledPipeline.invertible"): "fused XLA segments; eager stages run one by one",
    ("core/codecs/huffman_codec.py", "ENTROPY_INV_INPUTS"): "decode inputs padded to bound XLA retraces",
    # HLO text helpers: a recorded step has no HLO text, no while loops to scale
    ("runtime/hlo_analysis.py", "count_op"): "counts an op in HLO text",
    ("runtime/hlo_analysis.py", "split_computations"): "splits HLO text into computations",
    ("runtime/hlo_analysis.py", "computation_scales"): "trip counts of HLO while loops",
    ("core/codecs/huffman_codec.py", "ENTROPY_INV_PADS"): "decode inputs padded to bound XLA retraces",
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _scan(root: Path) -> tuple[dict[str, set], dict[str, tuple[set, list]]]:
    """``{module: public names}`` and ``{class name: (methods, base names)}``."""
    modules, classes = {}, {}
    for path in sorted(root.rglob("*.py")):
        names = set()
        tree = ast.parse(path.read_text())
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
                names.add(node.name)
            elif isinstance(node, ast.ClassDef):
                methods = {m.name for m in node.body
                           if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                           and _public(m.name)}
                bases = [b.id if isinstance(b, ast.Name) else getattr(b, "attr", "")
                         for b in node.bases]
                classes.setdefault(node.name, (set(), []))
                classes[node.name][0].update(methods)
                classes[node.name][1].extend(bases)
                if _public(node.name):
                    names.add(node.name)
                    names.update(f"{node.name}.{m}" for m in methods)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                names.update(t.id for t in targets if isinstance(t, ast.Name) and _public(t.id))
        modules[str(path.relative_to(root))] = names
    return modules, classes


def _methods(cls: str, classes: dict, seen=None) -> set:
    seen = set() if seen is None else seen
    if cls in seen or cls not in classes:
        return set()
    seen.add(cls)
    methods, bases = classes[cls]
    out = set(methods)
    for b in bases:
        out |= _methods(b, classes, seen)
    return out


def _missing() -> list[tuple[str, str]]:
    ref, _ = _scan(REF)
    port, port_classes = _scan(PORT)
    missing = []
    for module, names in ref.items():
        counterpart = MODULE_RENAMES.get(module, module)
        have = port.get(counterpart)
        if have is None:
            missing.append((module, "<module>"))
            continue
        for name in sorted(names):
            if (module, name) in NOT_PORTED:
                continue
            want = NAME_RENAMES.get((module, name), name)
            if want in have:
                continue
            cls, _, method = want.partition(".")
            if method and method in _methods(cls, port_classes):
                continue  # inherited from a base class the port defines
            missing.append((module, name))
    return missing


def test_every_public_name_of_the_reference_has_a_counterpart():
    assert _missing() == []


def test_the_map_names_only_what_the_reference_has():
    """No stale entries: each mapped name exists in the reference, each
    rename's target in the port."""
    ref, _ = _scan(REF)
    port, _ = _scan(PORT)
    for module, name in list(NOT_PORTED) + list(NAME_RENAMES):
        assert name in ref[module], (module, name)
    for (module, _name), target in NAME_RENAMES.items():
        assert target in port[MODULE_RENAMES.get(module, module)], (module, target)
    for module, target in MODULE_RENAMES.items():
        assert module in ref and target in port


def test_the_surface_added_by_this_slice_is_there():
    port, _ = _scan(PORT)
    want = {
        "core/abstractions.py": {"locality", "iterative", "map_and_process", "global_pipeline"},
        "core/machine.py": {"GEMProgram", "GEMProgram.fused", "DEMProgram", "DEMProgram.fused",
                            "run_gem", "run_dem", "jitted_dem"},
        "core/zfp.py": {"ZFPCompressed", "ZFPCompressed.nbytes", "ZFPCompressed.dims",
                        "compress", "decompress", "compression_ratio", "compress_jit",
                        "decompress_jit"},
        "core/mgard.py": {"MGARDCompressed", "MGARDCompressed.nbytes", "compress", "decompress",
                          "compression_ratio"},
        "core/quantize.py": {"quantize", "dequantize"},
        "core/huffman.py": {"histogram", "symbol_lengths_total"},
        "core/adapters.py": {"default_adapter", "resolve", "registered_ops"},
        "core/engine.py": {"data_devices", "make_data_mesh"},
        "launch/mesh.py": {"make_data_mesh", "data_axis_size"},
        "kernels/huffman_encode/ops.py": {"pack_stream"},
        "runtime/executor.py": {"DeviceExecutor.map"},
    }
    for module, names in want.items():
        assert names <= port[module], (module, names - port[module])


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

# parameters the port adds, each with its reason: allowed in any function
# where the port gives them a default after all of the reference's
# parameters, or makes them keyword-only, so a reference-style call means
# the same in the port
ADDED_PARAMS = {
    "device": "where the port makes or places its tensors (JAX puts arrays on its default device)",
    "devices": "the engine's device ring without a mesh (the reference builds a Mesh of them)",
    "backend": "the port's backend, torch or cuda (the reference's follows its arrays' platform)",
    "adapter": "binds the kernel's backend where the reference's op takes it from the plan",
    "mesh": "a DeviceMesh to place on, where the reference places through jax.sharding",
    "lead": "leading stacked dims: the port draws a stack of layers in one call",
    "thomas": "the tridiagonal solve to run (the tridiag kernel or its plain version)",
    "pinned": "the io lane's fetch into page-locked host memory for the card's copy",
    "perm": "the ZFP coefficient order handed in once, not rebuilt a call",
    "scale": "the ZFP transform's scale handed in once, not rebuilt a call",
    "out": "the caller's card array a stream's field is decoded into (MGARD-X's "
           "output_pre_allocated)",
    "timings": "the stream read-back's per-chunk lane timings, filled on request",
    "graphs": "the stream's lanes replay MGARD's transforms from CUDA graphs",
}

# a reference parameter the port names otherwise wherever it occurs, with its
# reason; a renamed parameter's default value is not compared
RENAMED_PARAMS = {
    "key": ({"gen", "generator"}, "a torch.Generator in place of a JAX PRNG key"),
    "block": ({"blocks"}, "the batched ZFP helpers take (n, 4^d) blocks in one call"),
    "axis_name": ({"group"}, "a process group (default: the whole world) in place of a mesh "
                             "axis name"),
}


def _sig(reason: str, *, dropped=(), added=(), renamed=None, keyword_only=()) -> dict:
    return {"reason": reason, "dropped": set(dropped), "added": set(added),
            "renamed": dict(renamed or {}), "keyword_only": set(keyword_only)}


_TILE = "the TPU kernel's Pallas tile and interpret flag: the CUDA kernel sizes its own launch"
_INIT_KW = "dtype follows the keyword-only lead, so it is keyword-only too"
_STACKED = "draws n stacked layers in one call (init_stack folded in)"

# (reference module, function) -> what its parameters become in the port,
# beyond the kinds above, with the reason
SIGNATURES = {
    # the seven kernel files' entry points
    ("kernels/histogram/kernel.py", "histogram"): _sig(_TILE, dropped={"kt", "bt", "interpret"}),
    ("kernels/huffman_decode/kernel.py", "decode_chunks"): _sig(_TILE, dropped={"interpret"}),
    ("kernels/huffman_encode/kernel.py", "encode_lookup"): _sig(_TILE, dropped={"t", "interpret"}),
    ("kernels/mgard_lerp/kernel.py", "lerp_coefficients"): _sig(_TILE, dropped={"r", "interpret"}),
    ("kernels/quantize_map/kernel.py", "quantize"): _sig(_TILE, dropped={"t", "interpret"}),
    ("kernels/quantize_map/kernel.py", "dequantize"): _sig(_TILE, dropped={"t", "interpret"}),
    ("kernels/tridiag/kernel.py", "solve_mass"): _sig(_TILE, dropped={"b", "interpret"}),
    ("kernels/zfp_block/kernel.py", "compress_blocks"): _sig(_TILE, dropped={"tb", "interpret"}),
    ("kernels/zfp_block/kernel.py", "decompress_blocks"): _sig(_TILE,
                                                               dropped={"tb", "interpret"}),
    ("kernels/zfp_block/ref.py", "compress_blocks"): _sig(
        "the plain version encodes a chunk of blocks at a time to bound its memory, and takes "
        "the integer types' block exponents", added={"chunk", "emax"}),
    ("kernels/zfp_block/ref.py", "decompress_blocks"): _sig(
        "the plain version decodes a chunk of blocks at a time to bound its memory",
        added={"chunk"}),
    # ZFP's batched helpers: the tables come in from the caller
    ("core/zfp.py", "to_fixed_point"): _sig("the encoder's scale table handed in once",
                                            added={"enc_scale"}),
    ("core/zfp.py", "from_fixed_point"): _sig(
        "float32 only, with the decoder's scale table handed in (the caller converts the dtype)",
        dropped={"dtype"}, added={"dec_scale"}),
    # internal: XLA donation and the stacked shard_map of the reference
    ("core/bitstream.py", "pack_bits"): _sig(
        "the bit total is implied by the lengths; the offsets may be handed in when known",
        dropped={"total_bits"}, added={"offsets"}),
    ("core/codecs/base.py", "Codec.encode_begin"): _sig(
        "XLA donation of a workspace; eager stages donate nothing", dropped={"workspace"}),
    ("core/stages/base.py", "CompiledPipeline.run"): _sig(
        "XLA donation of a workspace; eager stages donate nothing", dropped={"workspace"}),
    ("core/stages/base.py", "CompiledPipeline.run_batched"): _sig(
        "leaves stacked on one card, not mapped over a mesh by shard_map",
        renamed={"state0": "states0"}, dropped={"device_mapper", "transfers"}),
    ("core/stages/base.py", "CompiledPipeline.invert_batched"): _sig(
        "leaves stacked on one card, not mapped over a mesh by shard_map",
        renamed={"states": "states0"}, dropped={"device_mapper", "transfers"}),
    ("core/stages/base.py", "LeafView.__init__"): _sig(
        "a view of a leaf's own state, not of row index of a shard_map's stacked state",
        dropped={"index", "transfers"}),
    ("launch/dryrun.py", "run_cell"): _sig(
        "a config of the caller's and a time limit on DTensor's placement search",
        added={"cfg", "limit_s"}),
    ("data/pipeline.py", "SyntheticLMStream.__init__"): _sig(
        "the device the batches are made on comes second, before the optional mesh",
        added={"device"}),
    ("runtime/sharding.py", "param_spec"): _sig(
        "the parameter's path as a tuple of names, not a JAX key path", renamed={"path": "names"}),
    ("runtime/hlo_analysis.py", "cost_analysis_dict"): _sig(
        "counts a step's work by running fn on meta tensors: there is no compiled executable",
        dropped={"compiled"}, added={"fn", "*args", "**kwargs"}),
    # the models' initialisers
    ("models/attention.py", "init_gqa"): _sig(_INIT_KW, keyword_only={"dtype"}),
    ("models/attention.py", "init_mla"): _sig(_INIT_KW, keyword_only={"dtype"}),
    ("models/layers.py", "init_embedding"): _sig(
        "dtype is keyword-only, as in the other initialisers", keyword_only={"dtype"}),
    ("models/layers.py", "init_gelu_mlp"): _sig(_INIT_KW, keyword_only={"dtype"}),
    ("models/layers.py", "init_linear"): _sig(_INIT_KW, keyword_only={"dtype", "scale"}),
    ("models/layers.py", "init_rms_norm"): _sig(
        "every initialiser takes its generator first; " + _INIT_KW,
        added={"gen"}, keyword_only={"dtype"}),
    ("models/layers.py", "init_swiglu"): _sig(_INIT_KW, keyword_only={"dtype"}),
    ("models/moe.py", "init_moe"): _sig(_INIT_KW, keyword_only={"dtype"}),
    ("models/rglru.py", "init_rglru_block"): _sig(_INIT_KW, keyword_only={"dtype"}),
    ("models/ssm.py", "init_mamba2"): _sig(_INIT_KW, keyword_only={"dtype"}),
    ("models/transformer.py", "init_dense_layer"): _sig(_STACKED, added={"n"}),
    ("models/transformer.py", "init_moe_layer"): _sig(_STACKED, added={"n"}),
    ("models/transformer.py", "init_ssm_layer"): _sig(_STACKED, added={"n"}),
    ("models/transformer.py", "init_hybrid_sublayer"): _sig(_STACKED, added={"n"}),
    ("models/transformer.py", "init_stack"): _sig(
        _STACKED + ": the dense layer's config in place of an init function",
        dropped={"init_fn"}, added={"cfg", "dtype"}),
    ("models/encdec.py", "init_enc_layer"): _sig(_STACKED, added={"n"}),
    ("models/encdec.py", "init_dec_layer"): _sig(_STACKED, added={"n"}),
}

# the reference's API that the port took over as it is: no entry above
CLOSED_GAPS = {("core/pipeline.py", "ChunkedPipeline.__init__"),
               ("core/abstractions.py", "pad_to_blocks"),
               ("core/quantize.py", "dequantize_by_subset"),
               ("core/engine.py", "ExecutionEngine.__init__")}

_JNP_DTYPE = re.compile(r"\bjnp\.(bool_|bfloat16|float16|float32|float64|u?int(?:8|16|32|64))\b")


def _functions(root: Path) -> dict[str, dict[str, ast.FunctionDef]]:
    """``{module: {name or Class.method: def}}``, public names and ``__init__``."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        defs = {}
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
                defs[node.name] = node
            elif isinstance(node, ast.ClassDef) and _public(node.name):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                            _public(m.name) or m.name == "__init__"):
                        defs[f"{node.name}.{m.name}"] = m
        out[str(path.relative_to(root))] = defs
    return out


def _class_defs(root: Path) -> dict[str, tuple[dict, list]]:
    """``{class name: ({method: def}, base names)}`` of every class."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.ClassDef):
                methods = {m.name: m for m in node.body
                           if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
                bases = [b.id if isinstance(b, ast.Name) else getattr(b, "attr", "")
                         for b in node.bases]
                entry = out.setdefault(node.name, ({}, []))
                entry[0].update(methods)
                entry[1].extend(bases)
    return out


def _find(name: str, defs: dict, classes: dict, seen=None):
    """The def of ``name`` in a module's ``defs``, or of a method inherited
    from a base class the package defines."""
    if name in defs:
        return defs[name]
    cls, _, method = name.partition(".")
    seen = set() if seen is None else seen
    if not method or cls in seen or cls not in classes:
        return None
    seen.add(cls)
    methods, bases = classes[cls]
    if method in methods:
        return methods[method]
    for b in bases:
        found = _find(f"{b}.{method}", {}, classes, seen)
        if found is not None:
            return found
    return None


def _params(fn: ast.FunctionDef) -> list[tuple[str, str, str | None]]:
    """``(name, kind, default source or None)`` of each parameter in order;
    kind is ``positional``, ``keyword`` (keyword-only) or ``var``."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + [ast.unparse(d) for d in a.defaults]
    out = [(p.arg, "positional", d) for p, d in zip(pos, defaults)]
    if a.vararg:
        out.append(("*" + a.vararg.arg, "var", None))
    out += [(p.arg, "keyword", None if d is None else ast.unparse(d))
            for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.kwarg:
        out.append(("**" + a.kwarg.arg, "var", None))
    return out


def _mismatch(ref_fn, port_fn, entry: dict, used: dict | None = None) -> str | None:
    """What differs between the two parameter lists under ``entry`` and the
    kinds above (None when nothing does); ``used`` collects the kinds that
    applied."""
    used = {} if used is None else used
    want = []
    for name, kind, default in _params(ref_fn):
        if name in entry["dropped"]:
            continue
        if name in entry["renamed"]:
            names = {entry["renamed"][name]}
        else:
            names = {name} | RENAMED_PARAMS.get(name, (set(), ""))[0]
        if name in entry["keyword_only"]:
            kind = "keyword"
        if default is not None:
            default = _JNP_DTYPE.sub(r"torch.\1", default)
        want.append((name, names, kind, default))
    ref_names = set().union(*(w[1] for w in want)) if want else set()
    got = _params(port_fn)
    kept = []
    for i, (name, kind, default) in enumerate(got):
        if name in entry["added"]:
            continue
        generic = (name in ADDED_PARAMS and name not in ref_names and default is not None
                   and (kind == "keyword" or not any(
                       k == "positional" and n not in entry["added"]
                       and (n not in ADDED_PARAMS or n in ref_names)
                       for n, k, _d in got[i + 1:])))
        if generic:
            used.setdefault("added", set()).add(name)
            continue
        kept.append((name, kind, default))
    if len(kept) != len(want):
        return f"port {[k[0] for k in kept]} vs reference {[w[0] for w in want]}"
    for (name, kind, default), (rname, names, rkind, rdefault) in zip(kept, want):
        if name not in names:
            return f"parameter {name!r} where the reference has {rname!r}"
        if name != rname and rname not in entry["renamed"]:
            used.setdefault("renamed", set()).add(rname)
        if kind != rkind:
            return f"{name!r} is {kind}, the reference's {rkind}"
        if (default is None) != (rdefault is None):
            return f"{name!r} default {default!r}, the reference's {rdefault!r}"
        if name == rname and default != rdefault:
            return f"{name!r} default {default!r}, the reference's {rdefault!r}"
    return None


def _pairs():
    """``(module, name, reference def, port def)`` of every public function
    and method (and ``__init__``) written out in both packages."""
    ref, port = _functions(REF), _functions(PORT)
    port_classes = _class_defs(PORT)
    for module, defs in ref.items():
        counterpart = MODULE_RENAMES.get(module, module)
        for name, ref_fn in sorted(defs.items()):
            if (module, name) in NOT_PORTED or counterpart not in port:
                continue
            port_fn = _find(NAME_RENAMES.get((module, name), name), port[counterpart],
                            port_classes)
            if port_fn is not None:
                yield module, name, ref_fn, port_fn


_NO_ENTRY = _sig("")


def test_every_shared_function_takes_the_reference_s_parameters():
    bad = []
    for module, name, ref_fn, port_fn in _pairs():
        why = _mismatch(ref_fn, port_fn, SIGNATURES.get((module, name), _NO_ENTRY))
        if why is not None:
            bad.append((module, name, why))
    assert bad == []


def test_the_parameter_map_names_only_what_the_packages_have():
    """Each entry names a function of both packages and parameters of the
    reference (dropped, renamed, made keyword-only) or of the port (added,
    new names), each is needed, and each kind of the generic maps applies
    somewhere."""
    pairs = {(m, n): (r, p) for m, n, r, p in _pairs()}
    used: dict = {}
    for key, entry in SIGNATURES.items():
        assert key in pairs, key
        assert entry["reason"], key
        ref_fn, port_fn = pairs[key]
        ref_names = {p[0] for p in _params(ref_fn)}
        port_names = {p[0] for p in _params(port_fn)}
        assert entry["dropped"] | set(entry["renamed"]) | entry["keyword_only"] <= ref_names, key
        assert entry["added"] | set(entry["renamed"].values()) <= port_names, key
        assert _mismatch(ref_fn, port_fn, _NO_ENTRY) is not None, key   # not stale
    for ref_fn, port_fn in pairs.values():
        _mismatch(ref_fn, port_fn, _NO_ENTRY, used)
    for key, entry in SIGNATURES.items():
        _mismatch(*pairs[key], entry, used)
    assert set(ADDED_PARAMS) == used["added"]
    assert set(RENAMED_PARAMS) == used["renamed"]


def test_the_closed_api_gaps_need_no_entry():
    """The single-phase ``ChunkedPipeline``, ``pad_to_blocks(mode=)``,
    ``dequantize_by_subset(dtype=)`` and ``ExecutionEngine(mesh, ...)`` take
    the reference's parameters as they are."""
    pairs = {(m, n): (r, p) for m, n, r, p in _pairs()}
    for key in CLOSED_GAPS:
        assert key in pairs and key not in SIGNATURES, key
        assert _mismatch(*pairs[key], _NO_ENTRY) is None, key
    assert [p[0] for p in _params(pairs[("core/engine.py", "ExecutionEngine.__init__")][1])] == [
        "self", "mesh", "backend", "max_workers", "io_workers", "topology", "devices"]
