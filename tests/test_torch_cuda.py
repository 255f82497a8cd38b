"""The CUDA kernel on the card, against its plain PyTorch version.

Marked `cuda`: skips without a CUDA device.  The file imports no JAX (the
machine with the card has none), so it runs there without the suite's
conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -q
"""
import numpy as np
import pytest
import torch

import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.accel import cuda_intersect as tci
from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict
import torch_m10_scenes as ms
import torch_tiff_files as tf
from torch_tie_inputs import pack_rays, tie_inputs

# the kernel against its plain version (chip_smoke.py holds the same):
# u and v are contracted to FMA in the kernel, which may flip a hit within
# a few ulps of a triangle edge to the neighbour or, rarely, to a miss; t of
# a triangle both take is computed with the same roundings
HIT_AGREE_MIN, PRIM_AGREE_MIN, T_RTOL = 0.9999, 0.99, 1e-5


def _assert_agree(tk, pk, tr, pr, min_hits):
    hit = pr >= 0
    assert hit.sum() >= min_hits
    assert ((pk >= 0) == hit).float().mean() >= HIT_AGREE_MIN
    same = (pk == pr) & hit
    assert same.sum() >= PRIM_AGREE_MIN * hit.sum()
    torch.testing.assert_close(tk[same], tr[same], rtol=T_RTOL, atol=0)


def _proxy_rays(scene, n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.8, 0.8, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.where(rng.uniform(size=n) < 0.5, np.inf,
                    rng.uniform(0.02, 1.0, n))
    rays = pack_rays(o, d, maxt, scene.tri_center.cpu().numpy())
    return torch.from_numpy(rays).cuda()


@pytest.mark.cuda
def test_kernel_matches_plain_version():
    """Same tensors through the kernel and the plain version: hit sets,
    prims and t agree at the thresholds above (the kernel's chunk culling
    may also drop a grazing hit lying outside its chunk box by a rounding
    error)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = lrt.load_dict(liver_proxy_dict(64, 48, 1, 3, 0), device="cuda")
    rays = _proxy_rays(scene, 5000, 0)
    before = tci.LAUNCHES
    tk, pk = tci.intersect_closest(rays, scene.tri_buf, scene.tri_boxes)
    tr, pr = tci.intersect_closest_reference(rays, scene.tri_buf,
                                             scene.tri_boxes)
    torch.cuda.synchronize()
    assert tci.LAUNCHES == before + 1
    _assert_agree(tk, pk, tr, pr, min_hits=1000)


@pytest.mark.cuda
def test_kernel_ragged_wavefront():
    """N = 5,001 rays: no block size divides it; the last block masks its
    dead lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = lrt.load_dict(liver_proxy_dict(64, 48, 1, 3, 0))
    rays = _proxy_rays(scene, 5001, 1)
    tk, pk = tci.intersect_closest(rays, scene.tri_buf, scene.tri_boxes)
    tr, pr = tci.intersect_closest_reference(rays, scene.tri_buf,
                                             scene.tri_boxes)
    torch.cuda.synchronize()
    assert tk.shape == (5001,) and pk.shape == (5001,)
    _assert_agree(tk, pk, tr, pr, min_hits=1000)


@pytest.mark.cuda
def test_kernel_tie_rule_across_splits():
    """Duplicate and coplanar triangles hit at bitwise-equal t inside one
    chunk, across chunks and across the splits of the chunk range: the
    kernel and the merge keep the plain version's winner on every ray."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    v0, v1, v2, o, d, maxt, expected = tie_inputs(40_000, 4096, seed=3)
    buf, boxes, _, center = tci.pack_tris(v0, v1, v2)
    rays = torch.from_numpy(pack_rays(o, d, maxt, center)).cuda()
    tris, boxes = torch.from_numpy(buf).cuda(), torch.from_numpy(boxes).cuda()
    splits, _ = tci.split_plan(4096, boxes.shape[0], rays.device)
    assert splits > 1
    before = tci.MERGE_LAUNCHES
    tk, pk = tci.intersect_closest(rays, tris, boxes)
    tr, pr = tci.intersect_closest_reference(rays, tris, boxes)
    torch.cuda.synchronize()
    assert tci.MERGE_LAUNCHES == before + 1
    expected = torch.from_numpy(expected).to(torch.int32).cuda()
    assert torch.equal(pr, expected)
    _assert_agree(tk, pk, tr, pr, min_hits=2000)
    assert torch.equal(pk, expected)


@pytest.mark.cuda
def test_merge_kernel_matches_plain_version():
    """Partials with many equal t across splits: strict '<' in split
    order, exactly as the plain merge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(4)
    t = rng.choice([0.5, 1.0, 2.0, np.inf], size=(7, 3001)).astype(np.float32)
    prim = rng.integers(0, 1 << 20, size=t.shape).astype(np.int32)
    prim[np.isinf(t)] = -1
    t, prim = torch.from_numpy(t).cuda(), torch.from_numpy(prim).cuda()
    tk, pk = tci.merge_partials(t, prim)
    tr, pr = tci.merge_partials_reference(t, prim)
    torch.cuda.synchronize()
    assert torch.equal(tk, tr) and torch.equal(pk, pr)


@pytest.mark.cuda
def test_render_runs_through_kernel():
    """A small render on the card launches the kernel and agrees with the
    CPU render (plain version) pixel for pixel within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = liver_proxy_dict(16, 12, 4, 2, 0)
    ref = lrt.render(lrt.load_dict(d, device="cpu"), spp=4).numpy()
    before = tci.LAUNCHES
    img = lrt.render(lrt.load_dict(d, device="cuda"), spp=4).cpu().numpy()
    assert tci.LAUNCHES > before
    close = np.abs(img - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.all(-1).mean() >= 0.99


@pytest.mark.cuda
def test_render_grad_runs_through_kernel_in_the_replay():
    """render_grad on a card scene launches the sweep kernel in the replay
    walk too, and its media.params gradient agrees with the CPU gradient
    (plain version): cosine >= 0.999, norms within 1 % (the card sums the
    per-lane terms in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.integrators import prb_replay
    d = liver_proxy_dict(16, 12, 4, 2, 0)

    def grad(scene):
        _, g, _ = lrt.render_grad(scene, {"media.params": scene.media.params},
                                  lambda im: im.mean(), spp=4, seed=0)
        return g["media.params"].cpu().double()

    ref = grad(lrt.load_dict(d, device="cpu"))
    at_walk = []
    orig = prb_replay._replay_walk

    def walk(*args, **kw):
        at_walk.append(tci.LAUNCHES)
        return orig(*args, **kw)

    before = tci.LAUNCHES
    prb_replay._replay_walk = walk
    try:
        g = grad(lrt.load_dict(d, device="cuda"))
    finally:
        prb_replay._replay_walk = orig
    assert len(at_walk) == 1
    assert at_walk[0] > before and tci.LAUNCHES > at_walk[0]
    assert torch.isfinite(g).all() and ref.norm() > 0
    cos = float((g * ref).sum() / (g.norm() * ref.norm()))
    assert cos >= 0.999
    assert abs(float(g.norm() / ref.norm()) - 1.0) <= 1e-2


def _capture_shadow_queries(scene, spp):
    """Render with the kernel's wrapper wrapped to keep the rays of every
    shadow query -> [(rays, tris, boxes)]."""
    calls = []
    orig = tci.intersect_closest

    def keep(rays, tris, boxes, shadow=False):
        if shadow:
            calls.append((rays.clone(), tris, boxes))
        return orig(rays, tris, boxes, shadow=shadow)

    tci.intersect_closest = keep
    try:
        lrt.render(scene, spp=spp, seed=0)
    finally:
        tci.intersect_closest = orig
    return calls


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_shadow_rays():
    """NEE shadow queries of the fog Cornell box (finite maxt just short of
    the light, offset origins, no ray sort): the kernel against its plain
    version on the rays a render hands it, and the launches counted as
    shadow launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.scene.cornell import fog_cornell_box
    scene = lrt.load_dict(fog_cornell_box(64, max_depth=6))
    before = tci.SHADOW_LAUNCHES
    calls = _capture_shadow_queries(scene, 2)
    assert len(calls) > 0 and tci.SHADOW_LAUNCHES == before + len(calls)
    hits = total = 0
    for rays, tris, boxes in calls:
        assert torch.isfinite(rays[6]).all()          # maxt is finite
        tk, pk = tci.intersect_closest(rays, tris, boxes)
        tr, pr = tci.intersect_closest_reference(rays, tris, boxes)
        hits += int((pr >= 0).sum())
        total += int(((pk >= 0) == (pr >= 0)).sum())
        same = (pk == pr) & (pr >= 0)
        torch.testing.assert_close(tk[same], tr[same], rtol=T_RTOL, atol=0)
    assert hits > 0
    assert total >= HIT_AGREE_MIN * sum(r.shape[1] for r, _, _ in calls)


@pytest.mark.cuda
def test_fog_cornell_render_on_the_card_matches_cpu():
    """The fog Cornell box (surface NEE) rendered on the card against the
    CPU render (plain version): >= 99 % of pixels within rtol 1e-3 /
    atol 1e-4, and shadow queries launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.scene.cornell import fog_cornell_box
    d = fog_cornell_box(24, max_depth=6)
    ref = lrt.render(lrt.load_dict(d, device="cpu"), spp=4).numpy()
    before = tci.SHADOW_LAUNCHES
    img = lrt.render(lrt.load_dict(d), spp=4).cpu().numpy()
    assert tci.SHADOW_LAUNCHES > before
    close = np.abs(img - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.all(-1).mean() >= 0.99
    assert abs(img.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


def _card_vs_cpu(d, spp, variant=None):
    ref = lrt.render(lrt.load_dict(d, device="cpu", variant=variant),
                     spp=spp).numpy()
    img = lrt.render(lrt.load_dict(d, variant=variant),
                     spp=spp).cpu().numpy()
    close = np.abs(img - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.all(-1).mean() >= 0.99
    assert abs(img.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


@pytest.mark.cuda
def test_bump_env_render_on_the_card_matches_cpu():
    """The bumped, sky-lit liver proxy (bench.py's workload path at test
    size: a height map on the dielectric, a lat-long envmap) on the card
    against the CPU render (plain version), through the sweep kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = liver_proxy_dict(16, 12, 4, 2, 0, bump=(32, 0.05), sky=(64, 32))
    before = tci.LAUNCHES
    _card_vs_cpu(d, 4)
    assert tci.LAUNCHES > before


@pytest.mark.cuda
def test_env_nee_plane_on_the_card_matches_cpu():
    """A diffuse plane lit by the envmap alone: NEE samples the envmap's
    2-D importance map and the shadow queries launch the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.scene.cornell import plane_light_dict
    from liverrenderer_tpu_torch.scene.liver_proxy import sky_map
    d = plane_light_dict(12, light={"type": "envmap",
                                    "data": sky_map(64, 32)})
    before = tci.SHADOW_LAUNCHES
    _card_vs_cpu(d, 8)
    assert tci.SHADOW_LAUNCHES > before


def _cornell(res, rfilter):
    from liverrenderer_tpu_torch.scene.cornell import cornell_box
    d = cornell_box()
    d["sensor"]["film"].update(width=res, height=res,
                               rfilter={"type": rfilter})
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("rfilter", ["gaussian", "box"])
def test_cornell_box_on_the_card_matches_cpu(rfilter):
    """BASELINE's Cornell box (path, depth 8) on the card against the CPU
    render: its gaussian filter on the fixed wavefront, a box filter on the
    regenerating one; bounce and shadow queries both launch the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = (tci.LAUNCHES, tci.SHADOW_LAUNCHES)
    _card_vs_cpu(_cornell(24, rfilter), 4)
    assert tci.LAUNCHES - tci.SHADOW_LAUNCHES > before[0] - before[1]
    assert tci.SHADOW_LAUNCHES > before[1]


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_a_wide_wavefront():
    """The Cornell box's camera wavefront at 256x256, 64 spp: 4,194,304
    rays in one launch (16,384 blocks, one split over its one chunk)
    against the plain version run in blocks of 262,144 rays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.sensor.perspective import sample_ray
    scene = lrt.load_dict(_cornell(256, "gaussian"))
    n = 256 * 256 * 64
    g = torch.Generator(device="cuda").manual_seed(0)
    pos = torch.rand((n, 2), generator=g, device="cuda") * 256.0
    ray = sample_ray(scene, pos)
    o = ray.o - scene.tri_center
    rays = torch.cat([o.T, ray.d.T, torch.full((2, n), float("inf"),
                                               device="cuda")]).contiguous()
    rays[7] = 0.0
    assert tci.split_plan(n, scene.tri_boxes.shape[0], rays.device)[0] == 1
    tk, pk = tci.intersect_closest(rays, scene.tri_buf, scene.tri_boxes)
    blk = 1 << 18
    parts = [tci.intersect_closest_reference(rays[:, i:i + blk].contiguous(),
                                             scene.tri_buf, scene.tri_boxes)
             for i in range(0, n, blk)]
    tr = torch.cat([p[0] for p in parts])
    pr = torch.cat([p[1] for p in parts])
    assert tk.shape == (n,)
    _assert_agree(tk, pk, tr, pr, min_hits=n // 2)


@pytest.mark.cuda
def test_load_file_on_the_card_matches_cpu(tmp_path):
    """bench.py's workload path loaded from files (scene.xml, a binary
    PLY, a PNG height map, an EXR sky) at 16x12, 4 spp: the card's render
    against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch_xml_files import write_proxy_files
    path, _ = write_proxy_files(str(tmp_path), 16, 12, 4, subdiv=2,
                                bump_res=32, sky=(64, 32))
    ref = lrt.render(lrt.load_file(path, device="cpu"), spp=4).numpy()
    scene = lrt.load_file(path)
    assert scene.device.type == "cuda" and scene.has_heightmap
    before = tci.LAUNCHES
    img = lrt.render(scene, spp=4).cpu().numpy()
    assert tci.LAUNCHES > before
    close = np.abs(img - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.all(-1).mean() >= 0.99
    assert abs(img.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["stratified", "multijitter", "orthogonal",
                                  "ldsampler"])
def test_pattern_sampler_on_the_card_matches_cpu(kind):
    """The plane under its area light (path, depth 3) with each pattern
    sampler at 8 spp: the uint32-in-int64 streams on the card equal the
    CPU's, so the images agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.scene.cornell import plane_light_dict
    d = plane_light_dict(12, integrator="path", max_depth=3)
    d["sensor"]["sampler"] = {"type": kind, "sample_count": 8}
    _card_vs_cpu(d, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grid_cube", "grid_sggx", "volpathmis"])
def test_stock_media_on_the_card_match_cpu(kind):
    """A grid cube under a point light (medium NEE through the ratio-tracked
    walk across the grid), the same cube with an sggx phase, and
    volpathmis on a chromatic fog (the Cornell box at 16x16): the card's
    render through the sweep kernel against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.scene.cornell import (cornell_box,
                                                       grid_cube_dict,
                                                       smooth_noise_grid)
    point = {"type": "point", "position": [0.5, 2.2, 1.6],
             "intensity": {"type": "rgb", "value": [8.0] * 3}}
    if kind == "volpathmis":
        d = cornell_box()
        d["integrator"] = {"type": "volpathmis", "max_depth": 6}
        d["sensor"]["film"] = {"type": "hdrfilm", "width": 16, "height": 16,
                               "rfilter": {"type": "box"}}
        d["sensor"]["medium"] = {
            "type": "homogeneous",
            "sigma_t": {"type": "rgb", "value": [0.9, 0.3, 0.05]},
            "albedo": {"type": "rgb", "value": [0.8] * 3}}
    else:
        phase = {"type": "sggx", "S": [1.0, 0.3, 0.6, 0.0, 0.0, 0.0]} \
            if kind == "grid_sggx" else None
        d = grid_cube_dict(16, grid=smooth_noise_grid(16, 0), scale=2.0,
                           light=point, phase=phase)
    before = tci.LAUNCHES
    _card_vs_cpu(d, 4)
    assert tci.LAUNCHES > before


@pytest.mark.cuda
def test_bvh_traversal_on_the_card_matches_the_sweep():
    """intersector="bvh" on the card: the lockstep traversal's hits equal
    the sweep kernel's on the same rays (t re-derived from the same row
    where the prims agree)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.accel.intersect import ray_intersect
    from liverrenderer_tpu_torch.core.types import Ray
    scene = lrt.load_dict(liver_proxy_dict(64, 48, 1, 5, 0), device="cuda")
    rays = _proxy_rays(scene, 8192, 1)
    ray = Ray(o=rays[0:3].T + scene.tri_center, d=rays[3:6].T.contiguous(),
              maxt=rays[6].contiguous())
    sk = ray_intersect(scene, ray)
    sb = ray_intersect(scene.replace(intersector="bvh"), ray)
    assert sk.valid.sum() > 1000
    assert (sk.valid == sb.valid).float().mean() >= HIT_AGREE_MIN
    same = (sk.prim == sb.prim) & sk.valid
    assert same.sum() >= PRIM_AGREE_MIN * sk.valid.sum()
    torch.testing.assert_close(sb.t[same], sk.t[same], rtol=T_RTOL, atol=0)


def _sss_model(tmp_path):
    """The port's vae module pointed at a seeded synthetic model written
    under tmp_path (tests/torch_sss_inputs.py)."""
    from liverrenderer_tpu_torch.ssub import vae as tvae
    from torch_sss_inputs import substituted, write_model
    return substituted(*write_model(str(tmp_path), seed=3), tvae)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["vaescatter", "dipole"])
def test_sss_sphere_on_the_card_matches_cpu(kind, tmp_path):
    """A vaescatter and a dipole sphere on the card against the CPU render
    (plain version), through the sweep kernel (TF32 stays off, so the
    VAE's products are float32 on both)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch_sss_inputs import sphere_dict
    assert not torch.backends.cuda.matmul.allow_tf32
    d = sphere_dict(kind, res=16, rfilter="tent")
    before = tci.LAUNCHES
    with _sss_model(tmp_path):
        ref = lrt.render(lrt.load_dict(d, device="cpu"), spp=4).numpy()
        scene = lrt.load_dict(d)
        assert scene.ssub.enabled and scene.device.type == "cuda"
        img = lrt.render(scene, spp=4).cpu().numpy()
    assert tci.LAUNCHES > before
    close = np.abs(img - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.all(-1).mean() >= 0.99
    assert abs(img.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_sss_event_rays(tmp_path,
                                                        monkeypatch):
    """The SSS event's own queries (zero-scatter rays from inside the
    mesh, the short bounded projection rays and the unbounded ones, the
    exit shadow rays), captured from a render on the card, through the
    kernel and the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.scene.liver_proxy import sss_liver_dict
    from liverrenderer_tpu_torch.ssub import event as tevent
    calls, in_event = [], []
    orig_q, orig_ev = tci.intersect_closest, tevent.subsurface_event

    def query(rays, tris, boxes, shadow=False):
        if in_event:
            calls.append((rays.clone(), tris, boxes))
        return orig_q(rays, tris, boxes, shadow=shadow)

    def event(*a, **kw):
        in_event.append(1)
        try:
            return orig_ev(*a, **kw)
        finally:
            in_event.pop()

    with _sss_model(tmp_path):
        scene = lrt.load_dict(sss_liver_dict(32, 24, 1, subdiv=3,
                                             sky=(64, 32)))
    monkeypatch.setattr(tci, "intersect_closest", query)
    monkeypatch.setattr(tevent, "subsurface_event", event)
    from liverrenderer_tpu_torch.integrators import path as tpath
    monkeypatch.setattr(tpath, "subsurface_event", event)
    lrt.render(scene, spp=1)
    torch.cuda.synchronize()
    assert len(calls) >= 6 and len(calls) % 6 == 0
    for rays, tris, boxes in calls[:6]:
        tk, pk = orig_q(rays, tris, boxes)
        tr, pr = tci.intersect_closest_reference(rays, tris, boxes)
        torch.cuda.synchronize()
        _assert_agree(tk, pk, tr, pr, min_hits=1)


@pytest.mark.cuda
def test_piz_sky_decodes_on_the_cards_host(monkeypatch):
    """The committed PIZ sky through the C++ Huffman loop (built on this
    machine) and through its plain Python version: both equal
    sky_map(1024, 512) in half, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pathlib import Path
    from liverrenderer_tpu_torch.io import exr as texr
    from liverrenderer_tpu_torch.scene.liver_proxy import sky_map
    sky = str(Path(__file__).resolve().parent / "data" / "torch_sky_piz.exr")
    ref = sky_map(1024, 512).astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(texr.read_exr_any(sky), ref)
    monkeypatch.setattr(texr, "_huf_decode_native", texr._huf_decode_plain)
    np.testing.assert_array_equal(texr.read_exr_any(sky), ref)


@pytest.mark.cuda
def test_cli_on_the_card_matches_cli_on_the_cpu(tmp_path):
    """`python -m liverrenderer_tpu_torch.cli` without --cpu renders on
    the card (the kernels) and with it on the CPU; the two EXRs agree as
    the card and CPU renders do."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import subprocess
    import sys
    from pathlib import Path
    from torch_sensor_scenes import CLI_XML, images_agree
    root = Path(__file__).resolve().parents[1]
    xml = tmp_path / "scene.xml"
    xml.write_text(CLI_XML)
    for name, extra in (("card", []), ("cpu", ["--cpu"])):
        r = subprocess.run([sys.executable, "-m",
                            "liverrenderer_tpu_torch.cli", str(xml), "-o",
                            str(tmp_path / f"{name}.exr"), *extra],
                           capture_output=True, text=True, cwd=str(root),
                           timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        assert f"device={name if name == 'cpu' else 'cuda'}" in r.stdout
    card = lrt.read_image(str(tmp_path / "card.exr"))
    cpu = lrt.read_image(str(tmp_path / "cpu.exr"))
    frac, mean_rel = images_agree(card, cpu)
    assert frac >= 0.99 and mean_rel <= 1e-3


@pytest.mark.cuda
def test_render_control_stops_on_the_card(monkeypatch):
    """A control that cancels at half the progress stops, its partial
    frame is finite and the tiles not rendered are black; an uncancelled
    control renders the plain image (the splat's atomics aside)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.integrators import regen
    from torch_sensor_scenes import images_agree
    scene = lrt.load_dict(liver_proxy_dict(32, 24, 8, 2, 0))
    ref = lrt.render(scene, spp=8).cpu().numpy()
    monkeypatch.setattr(regen, "TILE_PIX", 256)      # 3 tiles
    got = lrt.render(scene, spp=8, control=lrt.RenderControl())
    frac, mean_rel = images_agree(got.cpu().numpy(), ref)
    assert frac >= 0.99 and mean_rel <= 1e-3
    ctl = lrt.RenderControl()
    ctl.on_progress = lambda f: ctl.cancel() if f >= 0.5 else None
    img = lrt.render(scene, spp=8, control=ctl).cpu().numpy()
    assert ctl.stopped
    assert torch.isfinite(ctl.frame()).all()
    assert img.reshape(-1, 3)[:256].sum() > 0
    assert img.reshape(-1, 3)[512:].sum() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["radiancemeter", "distant",
                                  "distant_target", "irradiancemeter",
                                  "batch", "thinlens", "orthographic"])
def test_sensor_on_the_card_matches_cpu(name):
    """Each sensor type at test size on the card against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch_sensor_scenes import sensor_scenes
    d, spp = sensor_scenes((16, 12))[name]
    _card_vs_cpu(d, spp)


def _pipeline_inputs(tmp_path, monkeypatch, w=16, h=12, spp=4, depth=4):
    """(settings, scenes dir) at test size, with medium_models.DATA_DIR on
    the synthetic spectra."""
    import torch_pipeline_inputs as pin
    from liverrenderer_tpu_torch.pipeline import medium_models
    monkeypatch.setattr(medium_models, "DATA_DIR",
                        pin.write_tables(str(tmp_path / "data")))
    scenes = str(tmp_path / "scenes")
    pin.write_scenes(scenes, w, h, spp, subdiv=2, bump_res=32, sky=(64, 32),
                     max_depth=depth)
    return pin.write_settings(str(tmp_path / "s.yml"), w, h, spp,
                              depth), scenes


@pytest.mark.cuda
def test_pipeline_driver_on_the_card_matches_cpu(tmp_path, monkeypatch):
    """`pipeline.driver` without --cpu renders on the card, with it on the
    CPU; the EXRs agree as the card and CPU renders do."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.pipeline import driver
    from torch_sensor_scenes import images_agree
    settings, scenes = _pipeline_inputs(tmp_path, monkeypatch)
    out = {}
    for name, extra in (("card", []), ("cpu", ["--cpu"])):
        assert driver.main([settings, "--scenes-dir", scenes, "--out-dir",
                            str(tmp_path / name), *extra]) == 0
        out[name] = lrt.read_image(str(tmp_path / name /
                                       "liver-singlemesh.exr"))
    frac, mean_rel = images_agree(out["card"], out["cpu"])
    assert frac >= 0.99 and mean_rel <= 1e-3


@pytest.mark.cuda
def test_evaluate_on_the_card_matches_cpu(tmp_path, monkeypatch):
    """`pipeline.evaluate` of the Liver-SingleMesh row (its denoise probe
    at 4 spp) on the card and on the CPU: no error row, metrics close."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os
    import torch_pipeline_inputs as pin
    from liverrenderer_tpu_torch.io.png import write_png
    from liverrenderer_tpu_torch.pipeline import evaluate
    from liverrenderer_tpu_torch.tonemap import tonemap
    _, scenes = _pipeline_inputs(tmp_path, monkeypatch)
    xml, gold, mask, opts = evaluate.CONFIGS["Liver-SingleMesh"]
    monkeypatch.setitem(evaluate.CONFIGS, "Liver-SingleMesh",
                        (xml, gold, mask, dict(opts, denoise_probe=4)))
    golden = os.path.join(scenes, pin.LIVER_GOLDEN)
    os.makedirs(os.path.dirname(golden))
    g = lrt.render(lrt.load_file(os.path.join(scenes, xml), res_width=64,
                                 res_height=48), spp=4, seed=9)
    write_png(golden, (tonemap(g.cpu().numpy()) * 255 + 0.5)
              .astype(np.uint8))
    rows = {dev: evaluate.evaluate(scenes, str(tmp_path / dev), 4, 4,
                                   ["Liver-SingleMesh"], device=dev)
            ["Liver-SingleMesh"] for dev in ("cuda", "cpu")}
    assert "error" not in rows["cuda"] and "error" not in rows["cpu"]
    for k in ("rmse", "ssim"):
        assert abs(rows["cuda"][k] - rows["cpu"][k]) <= 1e-3, k
        assert abs(rows["cuda"]["denoise"][f"denoised_{k}"]
                   - rows["cpu"]["denoise"][f"denoised_{k}"]) <= 1e-3, k


@pytest.mark.cuda
def test_denoise_on_the_card_matches_cpu(tmp_path):
    """atrous_denoise on card tensors against CPU tensors, and `denoise`
    without --cpu writing its EXR."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import subprocess
    import sys
    from pathlib import Path
    from liverrenderer_tpu_torch import denoise
    from torch_sensor_scenes import CLI_XML
    rng = np.random.default_rng(3)
    bufs = [torch.as_tensor(rng.random(s).astype(np.float32))
            for s in ((24, 32, 3), (24, 32, 3), (24, 32, 3), (24, 32))]
    cpu = denoise.atrous_denoise(*bufs)
    card = denoise.atrous_denoise(*[b.cuda() for b in bufs])
    assert card.device.type == "cuda"
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-5, atol=1e-6)
    xml = tmp_path / "scene.xml"
    xml.write_text(CLI_XML)
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-m", "liverrenderer_tpu_torch."
                        "denoise", str(xml), "-o", str(tmp_path / "d.exr"),
                        "--spp", "4"], capture_output=True, text=True,
                       cwd=str(root), timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert np.isfinite(lrt.read_image(str(tmp_path / "d.exr"))).all()


@pytest.mark.cuda
def test_largesteps_on_the_card_matches_cpu():
    """from_differential and its gradient on the card against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.scene.liver_proxy import liver_mesh
    v, f, _, _ = liver_mesh(3, 0)
    w = torch.as_tensor(np.random.default_rng(1).normal(size=v.shape)
                        .astype(np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        ls = lrt.LargeSteps(len(v), f, device=dev)
        u = torch.tensor(v * 1.1, device=dev, requires_grad=True)
        x = ls.from_differential(u)
        (x * w.to(dev)).sum().backward()
        out[dev] = (x.detach().cpu(), u.grad.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.cuda
def test_checkpoint_restores_onto_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.checkpoint import OptimizationCheckpointer
    p = torch.zeros(5, device="cuda", requires_grad=True)
    opt = torch.optim.Adam([p], lr=0.1)
    p.sum().backward()
    opt.step()
    ck = OptimizationCheckpointer(str(tmp_path))
    ck.save(1, {"p": p.detach()}, opt.state_dict())
    q = torch.zeros(5, device="cuda", requires_grad=True)
    fresh = torch.optim.Adam([q], lr=0.1)
    step, params, state = ck.restore({"p": q.detach()}, fresh.state_dict())
    assert step == 1 and params["p"].device.type == "cuda"
    fresh.load_state_dict(state)
    torch.testing.assert_close(fresh.state_dict()["state"][0]["exp_avg"],
                               opt.state_dict()["state"][0]["exp_avg"])


@pytest.mark.cuda
def test_spectral_proxy_on_the_card_matches_cpu():
    """The spectral variant of the bumped, sky-lit liver proxy
    (hero-wavelength packets on the biovolpath regen wavefront) on the card
    against the CPU render, through the sweep kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = liver_proxy_dict(16, 12, 4, 2, 0, bump=(32, 0.05), sky=(64, 32))
    before = tci.LAUNCHES
    _card_vs_cpu(d, 4, variant="spectral")
    assert tci.LAUNCHES > before


@pytest.mark.cuda
def test_specfilm_on_the_card_matches_cpu():
    """render_specfilm of the spectral Cornell box on the card against the
    CPU, per bin: >= 99 % of the (pixel, bin) entries within rtol 1e-3 /
    atol 1e-4, the means within 1e-3 (the card's scatter-add sums in
    another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = _cornell(16, "box")
    d["integrator"] = {"type": "path", "max_depth": 4}
    bins = {}
    for dev in ("cpu", "cuda"):
        sc = lrt.load_dict(d, device=dev, variant="spectral")
        bins[dev] = lrt.render_specfilm(sc, n_bins=16, spp=8).cpu().numpy()
    img, ref = bins["cuda"], bins["cpu"]
    assert img.shape == (16, 16, 16)
    close = np.abs(img - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.mean() >= 0.99
    assert abs(img.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


def _close(img, ref, mean_scale=None):
    """>= 99 % of the pixels within rtol 1e-3 / atol 1e-4 over the
    trailing axis, and the means within 1e-3 of mean_scale (|CPU mean|
    unless given)."""
    close = np.abs(img - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.all(-1).mean() >= 0.99
    scale = abs(ref.mean()) if mean_scale is None else mean_scale
    assert abs(img.mean() - ref.mean()) <= 1e-3 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [None, "spectral"])
def test_stokes_stack_on_the_card_matches_cpu(variant):
    """render_stokes of a polarizer-retarder-polarizer stack and of the
    gold mirror on the card against the CPU, per pixel and Stokes
    component.  S0's mean is held against |CPU mean|; the signed S1..S3,
    whose mean cancels to ~1e-5 of their magnitude, against their mean
    magnitude (as chip_smoke.py's arrays_agree)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = tci.LAUNCHES
    for d in (ms.stack_dict([{"type": "polarizer", "theta": 90.0},
                             {"type": "retarder", "theta": 45.0},
                             {"type": "polarizer", "theta": 30.0}]),
              ms.gold_mirror_dict()):
        out = [lrt.render_stokes(lrt.load_dict(d, device=dev,
                                               variant=variant),
                                 spp=8).cpu().numpy()
               for dev in ("cpu", "cuda")]
        img, ref = out[1], out[0]                  # (h, w, 4, 3)
        _close(img.reshape(img.shape[:2] + (-1,)),
               ref.reshape(ref.shape[:2] + (-1,)),
               mean_scale=np.inf)                  # the per-pixel gate
        _close(img[:, :, 0], ref[:, :, 0])         # S0
        _close(img[:, :, 1:].reshape(img.shape[:2] + (-1,)),
               ref[:, :, 1:].reshape(ref.shape[:2] + (-1,)),
               mean_scale=float(np.abs(ref[:, :, 1:]).mean()))
    assert tci.LAUNCHES > before


@pytest.mark.cuda
def test_ptracer_on_the_card_matches_cpu():
    """render_ptracer of the Cornell box at 16x16 on the card against the
    CPU: the intersections and camera connections launch the sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = _cornell(16, "box")
    before = tci.LAUNCHES
    out = [lrt.render_ptracer(lrt.load_dict(d, device=dev), spp=16)
           .cpu().numpy() for dev in ("cpu", "cuda")]
    assert tci.LAUNCHES >= before + 2 * 8
    _close(out[1], out[0])


@pytest.mark.cuda
def test_volprim_on_the_card_matches_cpu():
    """Three splats (volprim_rf_basic, SH degree 2) on the card against
    the CPU: the image, and the volprims.opacity and volprims.sh
    gradients through the scan adjoint (cosine >= 0.999, norms within
    1 %)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = ms.three_splats(srgb=True, degree=2)
    before = tci.LAUNCHES
    _card_vs_cpu(d, 4)
    assert tci.LAUNCHES > before
    keys = ("volprims.opacity", "volprims.sh")
    g = {}
    for dev in ("cpu", "cuda"):
        sc = lrt.load_dict(d, device=dev)
        prm = lrt.traverse(sc, keys)
        _, gr, _ = lrt.render_grad(sc, {k: prm[k] for k in keys},
                                   lambda im: im.mean(), spp=4)
        g[dev] = torch.cat([gr[k].cpu().double().reshape(-1) for k in keys])
    a, b = g["cuda"], g["cpu"]
    assert float((a * b).sum() / (a.norm() * b.norm())) >= 0.999
    assert abs(float(a.norm() / b.norm()) - 1.0) <= 1e-2


def _vertex_grad(d, device):
    sc = lrt.load_dict(d, device=device)
    _, g, _ = lrt.render_grad(sc, {"vertices": sc.vertices},
                              lambda im: im.mean(), spp=8)
    return g["vertices"].cpu().double()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["occluder", "bumped_proxy"])
def test_vertex_gradient_on_the_card_matches_cpu(name):
    """render_grad of the vertices (the replay adjoint and both boundary
    terms, their visibility tests, side probes and side radiance through
    the sweep kernel) on the card against the CPU: cosine >= 0.999, norms
    within 1 %; the primary term's 65,536 samples pick the same edges and
    >= 99.9 % of them the same visibility and side."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.integrators import projective as proj
    d = ms.occluder_dict(16) if name == "occluder" else \
        liver_proxy_dict(16, 12, 4, 2, 0, bump=(32, 0.05), sky=(64, 32))
    before = tci.LAUNCHES
    a, b = _vertex_grad(d, "cuda"), _vertex_grad(d, "cpu")
    assert tci.LAUNCHES > before
    assert torch.isfinite(a).all() and float(b.norm()) > 0
    assert float((a * b).sum() / (a.norm() * b.norm())) >= 0.999
    assert abs(float(a.norm() / b.norm()) - 1.0) <= 1e-2
    out = []
    for dev in ("cuda", "cpu"):
        sc = lrt.load_dict(d, device=dev)
        ev, ef = proj.edge_table(sc.faces, sc.n_tris)
        w = proj.silhouette_weights(sc, sc.vertices, ev, ef)[0]
        delta = torch.full((sc.film_h, sc.film_w, 3), 1e-3, device=dev)
        lanes = {}
        _, _, e = proj._boundary_grad(sc, sc.vertices, ev, ef, delta, w, 7,
                                      1 << 16, 6, lanes=lanes)
        out.append((e.cpu(), {k: v.cpu() for k, v in lanes.items()}))
    assert torch.equal(out[0][0], out[1][0])
    same = torch.ones_like(out[0][1]["visible"])
    for k in ("visible", "fg_p", "fg_m"):
        same &= out[0][1][k] == out[1][1][k]
    assert same.float().mean() >= 0.999 and out[0][1]["visible"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["clearcoat_sheen", "anisotropic",
                                  "spec_trans", "thin", "measured"])
def test_principled_and_measured_on_the_card_match_cpu(case, tmp_path):
    """The principled and principledthin planes and a measured plate (a
    seeded synthetic RGL file) at 32x32, 16 spp on the card against the
    CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if case == "measured":
        from liverrenderer_tpu_torch.bsdf.measured import write_tensor_file
        path = str(tmp_path / "m.bsdf")
        write_tensor_file(path, ms.synthetic_measured())
        d = ms.measured_plate_dict(path, 32)
    else:
        d = ms.bsdf_plane_dict(ms.PRINCIPLED[case], 32,
                               from_below=case in ("spec_trans", "thin"))
    before = tci.LAUNCHES
    _card_vs_cpu(d, 16)
    assert tci.LAUNCHES > before


def _m10b_scene(case, tmp_path):
    """The rest of M10 at test size (tests/torch_m10_scenes.py)."""
    if case == "sunsky_proxy":
        return ms.sunsky_proxy(liver_proxy_dict(16, 12, 4, 2, 0,
                                                bump=(32, 0.05)), hour=10.0)
    if case == "mesh_attribute":
        return ms.attr_quad_dict(16)
    if case == "volume":
        return ms.volume_wall_dict(16)
    if case == "instances":
        return ms.instancing_dict(4, "point", (24, 18))
    if case == "sdf":
        return ms.sdf_dict(ms.sphere_sdf(32), 16, light="point")
    path = str(tmp_path / "tuft.txt")
    ms.write_hair_tuft(path, 24, 0, n_ctrl=6)
    return ms.hair_tuft_dict(path, 16, 8, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sunsky_proxy", "mesh_attribute", "volume",
                                  "instances", "sdf", "hair_tuft"])
def test_m10_rest_on_the_card_matches_cpu(case, tmp_path):
    """The sun-lit bumped proxy, the mesh-attribute and volume textures,
    four instances, an SDF blob in the Cornell box and a hair tuft at test
    size on the card against the CPU, per pixel, through the sweep
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = _m10b_scene(case, tmp_path)
    if case == "sdf":
        # the SDF alone has no triangle: put it in the Cornell box
        d = ms.sdf_cornell(lambda: _cornell(16, "box"), 32)
    before = tci.LAUNCHES
    _card_vs_cpu(d, 8)
    assert tci.LAUNCHES > before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["instances", "sdf"])
def test_instance_pass_and_sdf_march_on_the_card_match_cpu(case, tmp_path):
    """ray_intersect_preliminary on 16,384 seeded rays of the instanced
    scene (its instance pass) and of the SDF scene (its march) on the card
    against the CPU: >= 99.9 % of the hit sets and prims (codes) alike,
    t within 1e-5 where they are."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.accel import intersect as tint
    from liverrenderer_tpu_torch.core.types import Ray
    d = _m10b_scene(case, tmp_path)
    rng = np.random.default_rng(1)
    n = 1 << 14
    if case == "instances":
        o = np.float32([0, -6, 2]) + rng.normal(0, 0.02, (n, 3))
        tgt = rng.uniform([-2.6, -1.6, -0.4], [2.6, 1.6, 0.5], (n, 3))
    else:
        o = np.float32([0.5, 0.5, 2.5]) + rng.normal(0, 0.02, (n, 3))
        tgt = rng.uniform(0.1, 0.9, (n, 3))
    dd = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
    out = []
    for dev in ("cpu", "cuda"):
        sc = lrt.load_dict(d, device=dev)
        r = Ray(o=torch.tensor(o, dtype=torch.float32, device=dev),
                d=torch.tensor(dd, dtype=torch.float32, device=dev),
                maxt=torch.full((n,), float("inf"), device=dev))
        t, prim, _, _, sph = tint.ray_intersect_preliminary(sc, r)
        out.append((t.cpu(), prim.cpu(), sph.cpu()))
    (tc, pc, sc_), (tg, pg, sg) = out
    hit = (pc >= 0) | (sc_ >= 0)
    assert hit.float().mean() > 0.2
    same = (pg == pc) & (sg == sc_)
    assert same.float().mean() >= 0.999
    torch.testing.assert_close(tg[same & hit], tc[same & hit], rtol=1e-5,
                               atol=0)


def _apps_cornell(res=16):
    """The Cornell box (path depth 3, box filter), its camera turned 1.3
    degrees off the box's diagonals, where two walls tie."""
    from liverrenderer_tpu_torch.scene.cornell import cornell_box
    from liverrenderer_tpu_torch.scene.transform import Transform
    d = cornell_box()
    d["integrator"] = {"type": "path", "max_depth": 3}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": res, "height": res,
                           "rfilter": {"type": "box"}}
    d["sensor"]["to_world"] = d["sensor"]["to_world"].matrix @ Transform() \
        .rotate([0.3, 1.0, 0.1], 1.3).matrix
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("mode, kw", [
    ("ema", dict(n_frames=3, spp=2, ema_alpha=0.3)),
    ("accum", dict(n_frames=2, spp=2, camera_orbit_deg=40.0)),
    ("denoise", dict(n_frames=2, spp=2))])
def test_viewer_on_the_card_matches_cpu(mode, kw):
    """run_viewer's frames on the card against the CPU's, frame by frame;
    the accumulation stays on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch import viewer
    d = _apps_cornell()
    frames, last = {}, {}
    before = tci.LAUNCHES
    for dev in ("cpu", "cuda"):
        fr = []
        last[dev] = viewer.run_viewer(
            lrt.load_dict(d, device=dev), mode=mode,
            frame_callback=lambda i, im: fr.append(np.array(im)), **kw)
        frames[dev] = fr
    assert last["cuda"].device.type == "cuda" and tci.LAUNCHES > before
    assert len(frames["cuda"]) == kw["n_frames"]
    for a, b in zip(frames["cuda"], frames["cpu"]):
        _close(a, b)


@pytest.mark.cuda
def test_interactive_loop_on_the_card_matches_cpu():
    """The scripted loop (moves, a look key, the spp keys, a reset) on the
    card against the CPU: frames, camera positions and the final blit
    (each channel within one 8-bit level: a pixel an ulp off may round to
    the next level)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import re
    from liverrenderer_tpu_torch import interactive
    d = _apps_cornell()
    keys = ["w", None, "LEFT", "+", "r", "a", None]
    runs = {}
    for dev in ("cpu", "cuda"):
        frames, cams = [], []
        acc, n = interactive.run_interactive(
            lrt.load_dict(d, device=dev), spp=1, keys=keys, display=False,
            max_frames=len(keys),
            frame_callback=lambda f, a, c: (frames.append(np.array(a)),
                                            cams.append(c.pos.copy())))
        runs[dev] = (frames, cams, acc, n)
    (gf, gc, gacc, gn), (cf, cc, cacc, cn) = runs["cuda"], runs["cpu"]
    assert gn == cn == len(keys) and gacc.device.type == "cuda"
    for a, b in zip(gf, cf):
        _close(a, b)
    for a, b in zip(gc, cc):
        np.testing.assert_array_equal(a, b)

    def levels(s):
        return np.array([int(x) for x in re.findall(r"\d+", s)])

    lg = levels(interactive.blit_ansi(gacc))
    lc = levels(interactive.blit_ansi(cacc))
    assert lg.shape == lc.shape and np.abs(lg - lc).max() <= 1


@pytest.mark.cuda
def test_sharded_world_of_one_over_nccl_matches_unsharded():
    """An NCCL world of one on the card: render_sharded, render_tiled (both
    layouts) and render_regen_sharded equal the unsharded renders, the
    sharded replay gradient equals render_grad's, and the collectives are
    issued (film all-reduces, the tiled film's all-gather)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import socket
    import torch.distributed as dist
    from liverrenderer_tpu_torch import film
    from liverrenderer_tpu_torch.integrators import regen
    from liverrenderer_tpu_torch.integrators.common import render_pass
    from liverrenderer_tpu_torch.parallel import mesh as tmesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = tmesh.make_mesh(device="cuda")
        assert mesh.group is not None and mesh.size == 1
        sc = lrt.load_dict(liver_proxy_dict(16, 12, 4, 2, 0,
                                            bump=(32, 0.05), sky=(64, 32)))
        plain = film.develop(render_pass(sc, 0, 4, 0)).cpu().numpy()
        st = tmesh.collective_stats(tmesh.render_sharded, sc, mesh, spp=4)
        assert st["all-reduce"]["ops"] == 1
        _close(tmesh.render_sharded(sc, mesh, spp=4).cpu().numpy(), plain)
        for il in (True, False):
            _close(tmesh.render_tiled(sc, mesh, spp=4, interleave=il)
                   .cpu().numpy(), plain)
        _close(tmesh.render_regen_sharded(sc, mesh, spp=4).cpu().numpy(),
               regen.render_regen(sc, 0, 4).cpu().numpy())
        p = {"media.params": sc.media.params}
        _, g, _ = tmesh.render_grad_replay_sharded(
            sc, mesh, p, lambda im: im.mean(), spp=4)
        _, g_ref, _ = lrt.render_grad(sc, p, lambda im: im.mean(), spp=4)
        a = g["media.params"].double().cpu().reshape(-1)
        b = g_ref["media.params"].double().cpu().reshape(-1)
        assert float((a * b).sum() / (a.norm() * b.norm())) >= 0.999
        assert abs(float(a.norm() / b.norm()) - 1.0) <= 1e-2
    finally:
        dist.destroy_process_group()


# ---- the rest of the loader (M9): the host decoders on the card's machine
# (its compiler builds the C++ loops) and the scene from those files
def _data(name):
    from pathlib import Path
    return str(Path(__file__).resolve().parent / "data" / name)


@pytest.mark.cuda
def test_jpeg_decode_on_the_card_host_matches_plain():
    """The committed JPEG height map: the C++ entropy loop against its
    plain version on a crop, and the full decode against the PNG codes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.io import jpeg
    from liverrenderer_tpu_torch.scene.liver_proxy import height_map
    with open(_data("torch_height.jpg"), "rb") as fh:
        full = jpeg.read_jpeg(fh.read())
    codes = np.round(height_map(1024, 0) * 255.0).astype(np.uint8)
    assert np.abs(full[..., 0].astype(int) - codes).max() <= 3
    crop = jpeg.encode_jpeg(full[:64, :96, 0])
    np.testing.assert_array_equal(jpeg.read_jpeg(crop, jpeg._scan_plain),
                                  jpeg.read_jpeg(crop))


@pytest.mark.cuda
def test_dwa_decode_on_the_card_host_matches_plain(monkeypatch):
    """The committed DWAA sky through the C++ Huffman loop and its plain
    version, and within the lossy bound of the PIZ sky."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.io import exr as texr
    native = texr.read_exr_any(_data("torch_sky_dwaa.exr"))
    piz = texr.read_exr_any(_data("torch_sky_piz.exr"))
    rel = np.abs(native - piz) / np.maximum(np.abs(piz), 1e-6)
    assert rel.max() <= 0.0102 and rel.mean() <= 7.0e-4
    monkeypatch.setattr(texr, "_huf_decode_native", texr._huf_decode_plain)
    np.testing.assert_array_equal(texr.read_exr_any(
        _data("torch_sky_dwaa.exr")), native)


@pytest.mark.cuda
def test_obj_parse_on_the_card_host_matches_plain(tmp_path):
    """The liver proxy (subdivision 5) as OBJ: the C++ parse and its plain
    version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.scene import meshio
    from liverrenderer_tpu_torch.scene.liver_proxy import liver_mesh
    v, f, n, uv = liver_mesh(5, 0)
    lines = [f"v {a!r} {b!r} {c!r}" for a, b, c in v.tolist()]
    lines += [f"vt {a!r} {b!r}" for a, b in uv.tolist()]
    lines += [f"vn {a!r} {b!r} {c!r}" for a, b, c in n.tolist()]
    lines += ["f " + " ".join(f"{i + 1}/{i + 1}/{i + 1}" for i in tri)
              for tri in f.tolist()]
    p = tmp_path / "liver.obj"
    p.write_text("\n".join(lines) + "\n")
    a, b = meshio.load_mesh(str(p)), meshio._load_obj(str(p))
    for k in ("vertices", "faces", "normals", "uvs"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.mark.cuda
def test_m9_scene_on_the_card_matches_cpu(tmp_path):
    """bench.py's workload path from XML with a 32^2 JPEG height map (the
    port's encoder) and the committed DWAA sky at 16x12, 4 spp: the
    card's render against the CPU's.  (The committed 1,024^2 height map
    at 16x12 puts texel edges inside pixels, where an ulp of hit uv bends
    a path: card = CPU on only ~95 % of pixels, PNG or JPEG alike.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.io import jpeg
    from liverrenderer_tpu_torch.scene.liver_proxy import height_map
    from torch_xml_files import write_proxy_files
    jpg = tmp_path / "h.jpg"
    jpg.write_bytes(jpeg.encode_jpeg(
        np.round(height_map(32, 0) * 255.0).astype(np.uint8)))
    path, _ = write_proxy_files(str(tmp_path / "scene"), 16, 12, 4,
                                subdiv=2, height_file=str(jpg),
                                sky_file=_data("torch_sky_dwaa.exr"))
    ref = lrt.render(lrt.load_file(path, device="cpu"), spp=4).numpy()
    scene = lrt.load_file(path)
    assert scene.device.type == "cuda" and scene.has_heightmap
    before = tci.LAUNCHES
    img = lrt.render(scene, spp=4).cpu().numpy()
    assert tci.LAUNCHES > before
    close = np.abs(img - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.all(-1).mean() >= 0.99
    assert abs(img.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


@pytest.mark.cuda
def test_tiff_and_gif_decode_on_the_card_host_match_plain(monkeypatch):
    """The committed LZW TIFF height map and GIF floor through the C++ LZW
    loops and their plain versions, the height map equal to its 8-bit
    codes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.io import gif, lzw, tiff
    from liverrenderer_tpu_torch.scene.liver_proxy import height_map
    with open(_data("torch_height.tif"), "rb") as fh:
        tif = fh.read()
    with open(_data("torch_floor.gif"), "rb") as fh:
        gf = fh.read()
    height, floor = tiff.read_tiff(tif), gif.read_gif(gf)
    codes = np.round(height_map(1024, 0) * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(height[..., 0], codes)
    monkeypatch.setattr(lzw, "lzw_tiff", lzw._lzw_tiff_plain)
    monkeypatch.setattr(lzw, "lzw_gif", lzw._lzw_gif_plain)
    np.testing.assert_array_equal(tiff.read_tiff(tif), height)
    np.testing.assert_array_equal(gif.read_gif(gf), floor)


@pytest.mark.cuda
def test_m9b_scene_on_the_card_matches_cpu(tmp_path):
    """bench.py's workload path from XML with a 32^2 LZW TIFF height map
    (tests/torch_raster_files' writer) and the committed GIF floor at
    16x12, 4 spp: the card's render against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.scene.liver_proxy import height_map
    from torch_raster_files import write_tiff
    from torch_xml_files import write_proxy_files
    tif = tmp_path / "h.tif"
    tif.write_bytes(write_tiff(np.round(height_map(32, 0) * 255.0).astype(
        np.uint8), 1, compression=5, predictor=2, rows_per_strip=8))
    path, _ = write_proxy_files(str(tmp_path / "scene"), 16, 12, 4,
                                subdiv=2, height_file=str(tif),
                                floor_file=_data("torch_floor.gif"))
    ref = lrt.render(lrt.load_file(path, device="cpu"), spp=4).numpy()
    scene = lrt.load_file(path)
    assert scene.device.type == "cuda" and scene.has_heightmap
    before = tci.LAUNCHES
    img = lrt.render(scene, spp=4).cpu().numpy()
    assert tci.LAUNCHES > before
    close = np.abs(img - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.all(-1).mean() >= 0.99
    assert abs(img.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


@pytest.mark.cuda
def test_m9c_scene_on_the_card_matches_cpu(tmp_path):
    """bench.py's workload path from XML with the committed 32^2 lossy
    WebP height map and BC7 DDS floor at 16x12, 4 spp: the card's render
    against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch_xml_files import write_proxy_files
    path, _ = write_proxy_files(str(tmp_path / "scene"), 16, 12, 4,
                                subdiv=2,
                                height_file=_data("torch_height32.webp"),
                                floor_file=_data("torch_floor_bc7.dds"))
    ref = lrt.render(lrt.load_file(path, device="cpu"), spp=4).numpy()
    scene = lrt.load_file(path)
    assert scene.device.type == "cuda" and scene.has_heightmap
    before = tci.LAUNCHES
    img = lrt.render(scene, spp=4).cpu().numpy()
    assert tci.LAUNCHES > before
    close = np.abs(img - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.all(-1).mean() >= 0.99
    assert abs(img.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


@pytest.mark.cuda
def test_m9c_decoders_on_the_cards_host():
    """The committed WebP and DDS files decode on the card's machine (no
    Pillow there) to the pixels the CPU tests hold to Pillow's: the C++
    loops against the plain ones, the BC7 floor against its PNG twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.io import image as timage
    from liverrenderer_tpu_torch.io import webp
    for name in ("torch_alpha64.webp", "torch_anim.webp",
                 "torch_height_crop.webp"):
        with open(_data(name), "rb") as fh:
            data = fh.read()
        cw, ch, frame = webp.demux(data)
        np.testing.assert_array_equal(
            webp.first_frame(data, cw, ch, frame),
            webp.first_frame(data, cw, ch, frame, plain=True))
    np.testing.assert_array_equal(
        timage.read_8bit(_data("torch_floor_bc7.dds")),
        timage.read_8bit(_data("torch_floor_bc7.png")))


@pytest.mark.cuda
def test_m9d_scene_on_the_card_matches_cpu(tmp_path):
    """bench.py's workload path from XML with the committed 32^2
    arithmetic-coded height map and the YCbCr JPEG-in-TIFF floor at
    16x12, 4 spp: the card's render against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch_xml_files import write_proxy_files
    path, _ = write_proxy_files(str(tmp_path / "scene"), 16, 12, 4,
                                subdiv=2,
                                height_file=_data("torch_height32_arith.jpg"),
                                floor_file=_data("torch_floor_ycc.tif"))
    ref = lrt.render(lrt.load_file(path, device="cpu"), spp=4).numpy()
    scene = lrt.load_file(path)
    assert scene.device.type == "cuda" and scene.has_heightmap
    before = tci.LAUNCHES
    img = lrt.render(scene, spp=4).cpu().numpy()
    assert tci.LAUNCHES > before
    close = np.abs(img - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.all(-1).mean() >= 0.99
    assert abs(img.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["torch_height_arith_crop.jpg",
                                  "torch_height32_arith.jpg"])
def test_m9d_arith_loop_on_the_cards_host_matches_plain(name):
    """The C++ arithmetic loop built on the card's machine against its
    plain version: the same coefficients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.io import jpeg, jpeg_arith
    with open(_data(name), "rb") as fh:
        data = fh.read()
    coefs = []
    for fn in (jpeg_arith._scan_native, jpeg_arith._scan_plain):
        st = jpeg._new_state()
        jpeg._parse(data, st, None, fn)
        coefs.append(st["coefs"])
    for a, b in zip(*coefs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["torch_floor_ycc", "torch_cmyk"])
def test_m9d_decoders_on_the_cards_host(name):
    """The committed YCbCr JPEG-in-TIFF floor and CMYK JPEG decode on the
    card's machine (no Pillow there) to their PNG twins, the pixels
    Pillow decodes from them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.io import image as timage
    ext = ".tif" if name.endswith("ycc") else ".jpg"
    np.testing.assert_array_equal(timage.read_8bit(_data(name + ext)),
                                  timage.read_8bit(_data(name + ".png")))


@pytest.mark.cuda
def test_m9e_scene_on_the_card_matches_cpu(tmp_path):
    """bench.py's workload path from XML with the committed 32^2 ZSTD
    height map and the Group 4 fax floor at 16x12, 4 spp: the card's
    render against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch_xml_files import write_proxy_files
    path, _ = write_proxy_files(str(tmp_path / "scene"), 16, 12, 4,
                                subdiv=2,
                                height_file=_data("torch_height32_zstd.tif"),
                                floor_file=_data("torch_floor_g4.tif"))
    ref = lrt.render(lrt.load_file(path, device="cpu"), spp=4).numpy()
    scene = lrt.load_file(path)
    assert scene.device.type == "cuda" and scene.has_heightmap
    before = tci.LAUNCHES
    img = lrt.render(scene, spp=4).cpu().numpy()
    assert tci.LAUNCHES > before
    close = np.abs(img - ref) <= 1e-4 + 1e-3 * np.abs(ref)
    assert close.all(-1).mean() >= 0.99
    assert abs(img.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [0, 1, 7])
def test_m9e_fax_and_zstd_loops_on_the_cards_host_match_plain(cut):
    """The C++ fax and Zstandard loops built on the card's machine against
    their plain versions on the committed strips, whole and cut short."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.io import tiff_fax, zstd
    z = tf.first_strip(_data("torch_height_zstd.tif"))
    z = z[:len(z) - cut * len(z) // 8]
    assert zstd.decode(z, 65536) == zstd._decode_plain(z, 65536)
    g4 = tf.first_strip(_data("torch_floor_g4.tif"))
    g4 = g4[:len(g4) - cut * len(g4) // 8]
    outs = []
    for fn in (tiff_fax.decode, tiff_fax._decode_plain):
        runs = np.zeros(2 * tiff_fax.nruns(256, tiff_fax.G4), np.uint32)
        strip = np.full(32 * 256, 0x5A, np.uint8)
        status = fn(g4, tiff_fax.G4, 256, 256, 32, False, False, runs, strip,
                    np.zeros(1, np.int32))
        outs.append((status, strip.tobytes(), runs.tobytes()))
    assert outs[0] == outs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["torch_height_zstd.tif",
                                  "torch_height_lzma.tif",
                                  "torch_floor_g4.tif"])
def test_m9e_decoders_on_the_cards_host(name):
    """The committed ZSTD and LZMA height maps decode on the card's
    machine (no Pillow, no zstd package there) to the height map's codes,
    the G4 floor to its PNG twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from liverrenderer_tpu_torch.io import image as timage
    from liverrenderer_tpu_torch.scene.liver_proxy import BUMP, height_map
    got = timage.read_8bit(_data(name))
    if name.startswith("torch_height"):
        codes = np.round(height_map(BUMP[0], 0) * 255.0).astype(np.uint8)
        np.testing.assert_array_equal(got[..., 0], codes)
    else:
        np.testing.assert_array_equal(got, timage.read_8bit(
            _data("torch_floor_g4.png")))
