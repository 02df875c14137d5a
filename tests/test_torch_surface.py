"""Every public name of the reference (``src/repro/``) has a counterpart in the
port (``src/repro_torch/``), apart from a stated map.

Both packages are read with ``ast``; neither is imported.  A public name is
a top-level function, class or assignment whose name does not start with
``_``, and a public method of a public class (found in the class or a base
class the port defines).  Each module of the reference is matched with the
port's module of the same path; the map says where a name went instead, or
why it has no counterpart.
"""

import ast
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
