"""The port's progressive tier against the reference (``repro.core.progressive``
and the ``mgard-progressive`` codec), on the ``torch`` backend.

The cases of ``tests/test_progressive.py`` and
``tests/test_progressive_conformance.py``, held across the packages: equal
manifests; every tier within its bound in both; streams, containers and
segment files cross-decoding within the bound in both directions;
``retrieve(e)`` + ``refine(e')`` bit-identical to ``retrieve(e')`` in the
port; the same ``(offset, nbytes)`` preads as the reference's reader on one
file; a corrupted component raising in both.

Fields stay small: the plain Huffman decode costs ~0.5 s a tier on the CPU
whatever the size, so the module decodes a few streams once and checks many
properties on them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from conftest import smooth_field_3d
from repro.core import api as japi
from repro.core import mgard as jmgard
from repro.core import progressive as jp
from repro.core.container import ContainerError as JContainerError
from repro.runtime import io as jio
from repro_torch.core import api as tapi
from repro_torch.core import mgard as tmgard
from repro_torch.core import progressive as tp
from repro_torch.core.container import Compressed, ContainerError
from repro_torch.core.context import GLOBAL_CMM
from repro_torch.runtime import io as tio

EDGE = 13          # padded to 17^3: 4,913 nodes, two 4096-key chunks
TIERS = 3


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _err(out, f) -> float:
    return float(np.abs(_np(out).astype(np.float64) - f).max())


class _PreadLog:
    """Record every ``AggregatedReader.pread`` of one package."""

    def __init__(self, mod):
        self.mod, self.calls = mod, []

    def __enter__(self):
        orig = self.orig = self.mod.AggregatedReader.pread
        calls = self.calls

        def pread(reader, offset, nbytes):
            calls.append((int(offset), int(nbytes)))
            return orig(reader, offset, nbytes)

        self.mod.AggregatedReader.pread = pread
        return self

    def __exit__(self, *exc):
        self.mod.AggregatedReader.pread = self.orig


@pytest.fixture(scope="module")
def prog(tmp_path_factory):
    """Both packages' streams of one field, written as segment files, and
    each package's reader refining through the port's file tier by tier."""
    root = tmp_path_factory.mktemp("progressive")
    f = smooth_field_3d(EDGE)
    eb = 1e-3 * float(f.max() - f.min())
    ps = tp.refactor(f, eb, tiers=TIERS, backend="torch")
    js = jp.refactor(jnp.asarray(f), eb, tiers=TIERS)
    paths = {"port": root / "port.hpdr", "ref": root / "ref.hpdr"}
    ps.write(paths["port"])
    js.write(paths["ref"])
    chains = {}
    for name, mod, io in (("port", tp, tio), ("ref", jp, jio)):
        kw = {"backend": "torch"} if name == "port" else {}
        with _PreadLog(io) as log, mod.ProgressiveReader(paths["port"], **kw) as r:
            steps = []
            for k in range(1, TIERS + 1):
                out = r.refine(tiers=k)
                steps.append((_np(out).copy(), r.preads, r.bytes_fetched, r.tiers_loaded))
            r.refine(tiers=TIERS)  # idempotent: no re-read
            steps.append((None, r.preads, r.bytes_fetched, r.tiers_loaded))
        chains[name] = {"steps": steps, "preads": log.calls}
    return {"f": f, "eb": eb, "ps": ps, "js": js, "paths": paths, "chains": chains}


# ---------------------------------------------------------------------------
# manifests, ladders, plans
# ---------------------------------------------------------------------------


def test_manifests_equal_reference(prog):
    pm, jm = prog["ps"].manifest, prog["js"].manifest
    for key in ("shape", "padded", "L", "dict_size", "tier_bounds"):
        assert pm[key] == jm[key], key
    assert len(prog["ps"].components) == len(pm["component_nbytes"]) == TIERS
    assert pm["component_nbytes"] == [len(b) for b in prog["ps"].components]


@pytest.mark.parametrize("args", [(1e-4, 3, 8.0), (0.5, 1, 2.0), (3e-2, 4, 1.5)])
def test_tier_bounds_match_reference(args):
    assert tp.tier_bounds(*args) == jp.tier_bounds(*args)


@pytest.mark.parametrize("args", [(0.0, 3, 8.0), (1e-3, 0, 8.0), (1e-3, 3, 1.0)])
def test_tier_bounds_reject_like_reference(args):
    with pytest.raises(ValueError):
        tp.tier_bounds(*args)
    with pytest.raises(ValueError):
        jp.tier_bounds(*args)


def test_tiers_for_matches_reference(prog):
    b = prog["ps"].tier_bounds
    for err in (None, b[0] * 2, b[0], b[1], b[1] * 0.99, b[2] / 10):
        assert prog["ps"].tiers_for(err) == prog["js"].tiers_for(err)


def test_plans_resolve_through_cmm():
    f = smooth_field_3d(9)
    tp.refactor(f, 1e-2, tiers=2, backend="torch")
    m0, h0 = GLOBAL_CMM.miss_count, GLOBAL_CMM.hit_count
    tp.refactor(f, 1e-3, tiers=3, backend="torch")  # another bound: no new plan
    assert GLOBAL_CMM.miss_count == m0
    assert GLOBAL_CMM.hit_count > h0


def test_planned_executables_match_reference():
    """The mgard plan's quantize/dequantize executables against the
    reference's, on the same coefficients (outliers included)."""
    padded, dict_size = (9, 9, 9), 64
    rng = np.random.default_rng(3)
    coeffs = (rng.normal(size=padded) * 4).astype(np.float32)
    lmap = tmgard.level_map(padded).numpy()
    bins = np.asarray(tmgard.level_bins(0.05, tmgard.total_levels(padded)), np.float32)
    tq = tmgard.planned_quantize_stage(padded, dict_size, "torch")
    jq = jmgard.planned_quantize_stage(padded, dict_size, "xla")
    lmap_t = torch.from_numpy(lmap)
    t_out = tq(torch.from_numpy(coeffs), lmap_t, torch.from_numpy(bins))
    j_out = jq(jnp.asarray(coeffs), jnp.asarray(lmap), jnp.asarray(bins))
    assert (~_np(t_out[2])).sum() > 0  # some outliers
    for t, j in zip(t_out[:3], j_out[:3]):
        t = _np(t).reshape(-1)
        np.testing.assert_array_equal(t, np.asarray(j).reshape(-1).astype(t.dtype))
    assert t_out[3] is lmap_t  # handed back for the plan to re-store
    td = tmgard.planned_dequantize_stage("torch")(t_out[0], lmap_t, torch.from_numpy(bins))
    jd = jmgard.planned_dequantize_stage("xla")(j_out[0], jnp.asarray(lmap), jnp.asarray(bins))
    np.testing.assert_array_equal(_np(td[0]), np.asarray(jd[0]))


# ---------------------------------------------------------------------------
# tiers within their bounds; refinement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("package", ["port", "ref"])
def test_each_tier_within_its_bound(prog, package):
    """Reading the port's file tier by tier, in either package: each prefix
    within its tier's bound, the error never growing, each component read
    once."""
    steps = prog["chains"][package]["steps"]
    bounds = prog["ps"].tier_bounds
    errs = []
    for k, (out, preads, fetched, loaded) in enumerate(steps[:TIERS], start=1):
        errs.append(_err(out, prog["f"]))
        assert errs[-1] <= bounds[k - 1]
        assert preads == loaded == k
        assert fetched == prog["ps"].nbytes_upto(k)
    assert all(b <= a for a, b in zip(errs, errs[1:]))
    assert steps[-1][1:] == (TIERS, prog["ps"].nbytes(), TIERS)


def test_reader_preads_match_reference(prog):
    """On one file, the port's reader preads the same (offset, nbytes) list
    as the reference's."""
    port, ref = prog["chains"]["port"]["preads"], prog["chains"]["ref"]["preads"]
    assert port == ref and len(port) == TIERS
    assert sum(n for _, n in port) == prog["ps"].nbytes()


def test_refine_bit_identical_to_direct(prog):
    """retrieve(coarse) then refine(fine) from the segment file == a fresh
    retrieve(fine) from the monolithic bytes."""
    refined = prog["chains"]["port"]["steps"][TIERS - 1][0]
    fine = prog["ps"].tier_bounds[-1]
    mono = tp.ProgressiveReader.from_bytes(prog["ps"].to_bytes(), backend="torch")
    direct = _np(mono.retrieve(err=fine))
    assert mono.preads == TIERS
    assert np.array_equal(refined.view(np.int32), direct.view(np.int32))


# ---------------------------------------------------------------------------
# cross-decoding, both directions
# ---------------------------------------------------------------------------


def test_port_reads_reference_segment_file(prog):
    with tp.ProgressiveReader(prog["paths"]["ref"], backend="torch") as r:
        out = r.retrieve()
        assert r.preads == TIERS and r.bytes_fetched == prog["js"].nbytes()
    assert _err(out, prog["f"]) <= prog["js"].tier_bounds[-1]


def test_reference_reads_port_streams(prog):
    raw = prog["ps"].to_bytes()
    back = jp.ProgressiveStream.from_bytes(raw)
    assert back.manifest == prog["ps"].manifest and back.components == prog["ps"].components
    assert _err(jp.retrieve(back, tiers=1), prog["f"]) <= prog["ps"].tier_bounds[0]
    mono = jp.ProgressiveReader.from_bytes(raw)
    assert _err(mono.retrieve(), prog["f"]) <= prog["ps"].tier_bounds[-1]


def test_port_reads_reference_stream_prefix(prog):
    back = tp.ProgressiveStream.from_bytes(prog["js"].to_bytes())
    assert back.manifest == prog["js"].manifest and back.components == prog["js"].components
    coarse = tp.ProgressiveStream(manifest=back.manifest, components=back.components[:1])
    assert _err(tp.retrieve(coarse, backend="torch"), prog["f"]) <= back.tier_bounds[0]


@pytest.fixture(scope="module")
def containers():
    f = smooth_field_3d(EDGE, noise=0.01, seed=4)
    return f, tapi.compress(f, "mgard-progressive", backend="torch"), japi.compress(
        jnp.asarray(f), "mgard-progressive")


def test_codec_container_matches_reference(containers):
    f, tc, jc = containers
    assert tc.method == jc.method == "mgard-progressive"
    for key in ("shape", "padded", "L", "dict_size", "tier_bounds", "dtype",
                "error_bound", "relative"):
        assert tc.meta[key] == jc.meta[key], key
    assert sorted(tc.arrays) == sorted(jc.arrays) == [tp.component_name(t) for t in range(3)]


@pytest.mark.parametrize("direction", ["port-decodes-ref", "ref-decodes-port"])
def test_codec_containers_cross_decode(containers, direction):
    f, tc, jc = containers
    if direction == "port-decodes-ref":
        out = tapi.decompress(Compressed.from_bytes(jc.to_bytes()), backend="torch")
        assert out.dtype == torch.float32
        bound = jc.meta["tier_bounds"][-1]
    else:
        out = japi.decompress(japi.Compressed.from_bytes(tc.to_bytes()))
        bound = tc.meta["tier_bounds"][-1]
    assert tuple(out.shape) == f.shape
    assert _err(out, f) <= bound


def test_codec_relative_bound_matches_reference():
    """The relative bound takes the range in the data's dtype (float32
    subtraction; an unsigned range through a wider carrier)."""
    f = smooth_field_3d(7)
    u = np.round((f - f.min()) / (f.max() - f.min()) * 60000).astype(np.uint16)
    for x in (f, u):
        tc = tapi.compress(x, "mgard-progressive", tiers=1, backend="torch")
        jc = japi.compress(jnp.asarray(x), "mgard-progressive", tiers=1)
        assert tc.meta["tier_bounds"] == jc.meta["tier_bounds"]
        assert tc.meta["dtype"] == jc.meta["dtype"] == str(x.dtype)


# ---------------------------------------------------------------------------
# corruption
# ---------------------------------------------------------------------------


def test_corrupted_segment_component_raises_in_both(prog, tmp_path):
    path = tmp_path / "prog.hpdr"
    directory = prog["ps"].write(path)
    victim = tp.component_name(1)
    seg = directory["segments"][victim]
    raw = bytearray(path.read_bytes())
    raw[int(seg["offset"]) + int(seg["nbytes"]) // 2] ^= 0x01
    path.write_bytes(bytes(raw))
    with tp.ProgressiveReader(path, backend="torch") as r:
        assert _err(r.retrieve(tiers=1), prog["f"]) <= r.tier_bounds[0]
        with pytest.raises(ContainerError, match="component/00001"):
            r.refine(tiers=2)
    with jp.ProgressiveReader(path) as r:
        with pytest.raises(JContainerError, match="component/00001"):
            r.retrieve()


def test_corrupted_section_component_raises_in_both(prog):
    raw = bytearray(prog["ps"].to_bytes())
    header, base = tp.container.peek_header(bytes(raw))
    sec = header["sections"][tp.component_name(0)]
    raw[base + int(sec["offset"]) + 5] ^= 0x40
    with pytest.raises(ContainerError, match="component/00000"):
        tp.ProgressiveReader.from_bytes(bytes(raw), backend="torch").retrieve(tiers=1)
    with pytest.raises(JContainerError, match="component/00000"):
        jp.ProgressiveReader.from_bytes(bytes(raw)).retrieve(tiers=1)


def test_truncated_segment_file_raises_in_both(prog, tmp_path):
    path = tmp_path / "prog.hpdr"
    prog["ps"].write(path)
    path.write_bytes(path.read_bytes()[:-30])
    with pytest.raises(ContainerError):
        tp.ProgressiveReader(path, backend="torch")
    with pytest.raises(JContainerError):
        jp.ProgressiveReader(path)


def test_non_progressive_stream_rejected():
    c = Compressed(method="mgard", meta={}, arrays={"q": np.zeros(4, np.uint8)})
    with pytest.raises(ContainerError, match="progressive"):
        tp.ProgressiveReader.from_bytes(c.to_bytes(), backend="torch")


def test_component_outliers_past_the_grid_raise(prog):
    """A component whose outlier index lies past the grid is refused on the
    host (a device scatter there would fault)."""
    c = Compressed.from_bytes(prog["ps"].components[0])
    c.arrays["outlier_idx"] = np.array([10 ** 6], np.int64)
    c.arrays["outlier_val"] = np.array([1], np.int32)
    bad = tp.ProgressiveStream(manifest=prog["ps"].manifest, components=[c.to_bytes()])
    with pytest.raises(ContainerError, match="outlier"):
        tp.retrieve(bad, backend="torch")
