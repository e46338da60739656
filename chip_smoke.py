"""Smoke test of the frame path on one NVIDIA GPU (or four with --multi).

Drives the system through the entry points a user calls, at full size:
the 1024^3 procedural-terrain world built from ``--seed`` on the card,
1920x1080 frames in every render mode, the K-hit training step and a
brush edit.  Every kernel runs compiled for the card and is compared
with the repository's plain reference.  Any failed check raises; the
last line of standard output is one JSON object naming the device.

  python chip_smoke.py [--seed N]   # one card, phases 1-7
  python chip_smoke.py --multi      # four cards: sharded frame + train

There is no CPU fallback: without a GPU the script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

WORLD, CHUNK = 1024, 512
FULL_W, FULL_H = 1920, 1080
SMALL_W, SMALL_H = 480, 270
N_TIMED = 5

# traversal vs brick_trace (tests/test_wavefront.py contract)
HIT_AGREE_MIN, STRICT_MIN = 0.995, 0.98
T_TOL, NORMAL_TOL = 2e-4, 1e-5
# brick traversal vs the ESVO walk (tests/test_brick_trace.py contract)
ESVO_HIT_AGREE_MIN, VOXEL_POS_TOL = 0.99, 1e-3
# frames vs shade.render_image (tests/test_render_wave.py tolerances)
FRAME_COLOR_TOL, FRAME_MATCH_MIN, HEAT_HIT_MIN = 2e-3, 0.97, 0.99
# sharded vs one-card results (tests/test_wave_sharded.py, test_wave_diff.py)
SHARD_PIX_TOL, SHARD_MATCH_MIN = 1e-5, 0.999
SHARD_LOSS_RTOL, SHARD_PARAM_ATOL = 1e-4, 1e-5


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def gpu_name_and_power_limit():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def timed(fn, *args):
    """(median ms, max ms) of N_TIMED runs after one warm-up run."""
    import jax

    jax.block_until_ready(fn(*args))
    ms = []
    for _ in range(N_TIMED):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), float(np.max(ms))


def device_phase(n_cards):
    import jax

    devs = jax.devices()
    print(f"[1 device] jax {jax.__version__} devices {devs}", flush=True)
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU found (platform {devs[0].platform!r}); "
                         "this smoke test runs only on the card")
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, found {len(devs)}")
    print(f"[1 device] {gpu_name_and_power_limit()}", flush=True)
    return devs


def build_phase(seed, world=WORLD, chunk=CHUNK):
    import jax

    from svo_raytracer_tpu.models import world as world_mod
    from svo_raytracer_tpu.ops import brick_scene, wavefront

    t0 = time.perf_counter()
    tree = world_mod.build_terrain(world, chunk, seed=seed)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = brick_scene.brickify(tree)
    t_brick = time.perf_counter() - t0
    t0 = time.perf_counter()
    ws = wavefront.prepare(host)
    jax.block_until_ready(ws)
    t_up = time.perf_counter() - t0
    nbytes = sum(a.nbytes for a in (ws.l0, ws.brick_slot, ws.occ, ws.attrs))
    print(f"[2 build] {world}^3 seed {seed}: octree {t_build:.1f} s, "
          f"brickify {t_brick:.1f} s, upload {t_up:.1f} s; n_nodes "
          f"{tree.n_nodes} n_mixed {host.n_mixed} capacity {ws.capacity} "
          f"scene {nbytes / 2**20:.1f} MiB on device", flush=True)
    return tree, host, ws


def _agreement(ref, got, active, voxel_pos_tol=None):
    """(hit agreement over active rays, strict fraction over both-hit)."""
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    got = {k: np.asarray(v) for k, v in got._asdict().items()}
    active = np.asarray(active)
    agree = float((ref["hit"] == got["hit"])[active].mean())
    both = ref["hit"] & got["hit"] & active
    strict = ((ref["value"] == got["value"]) & (ref["depth"] == got["depth"])
              & (np.abs(ref["t"] - got["t"]) <= T_TOL)
              & (np.abs(ref["normal"] - got["normal"]).max(-1) <= NORMAL_TOL))
    if voxel_pos_tol is not None:
        strict &= (np.abs(ref["voxel_pos"] - got["voxel_pos"]).max(-1)
                   <= voxel_pos_tol)
    return agree, float(strict[both].mean()), int(both.sum())


def sample_rays(cam5, width, height, n, seed):
    """``n`` primary rays through random pixels of a width x height frame
    (with the pixel coordinates that seed the GI RNG)."""
    import jax.numpy as jnp

    from svo_raytracer_tpu.ops import shade

    d = shade.pixel_dirs_device(cam5, width, height)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    idx = np.random.default_rng(seed).choice(width * height, n,
                                             replace=False)
    px = jnp.asarray((idx % width).astype(np.float32))
    py = jnp.asarray((idx // width).astype(np.float32))
    d = d[jnp.asarray(idx)]
    return jnp.broadcast_to(cam5[0], d.shape), d, px, py


def bounce_rays(res, o, d, px, py, frame_number=1.0):
    """First GI-bounce rays from primary hits, as render mode 0 makes
    them (render_wave._gi_update)."""
    import jax.numpy as jnp

    from svo_raytracer_tpu.ops import render_wave

    accum, mask, depth, it, active, r = render_wave._gi_init(
        px, py, jnp.float32(frame_number), d)
    _, _, _, _, hit, o2, d2 = render_wave._gi_update(
        True, (), accum, mask, depth, it, active, o, d, r, res)
    return o2, d2, hit


def parity_phase(tree, ws, cam5, seed, n_rays=1 << 16, n_esvo=4096,
                 width=FULL_W, height=FULL_H):
    import jax.numpy as jnp

    from svo_raytracer_tpu.ops import brick_trace, traverse, wavefront

    o, d, px, py = sample_rays(cam5, width, height, n_rays, seed)
    ones = jnp.ones(n_rays, bool)
    got = wavefront.intersect(ws, o, d, ones)
    ref = brick_trace.intersect_scene(ws, o, d, ones)
    rows = [("primary", ref, got, ones)]
    bo, bd, bact = bounce_rays(got, o, d, px, py)
    rows.append(("bounce", brick_trace.intersect_scene(ws, bo, bd, bact),
                 wavefront.intersect(ws, bo, bd, bact), bact))
    for name, r, g, act in rows:
        agree, strict, n_both = _agreement(r, g, act)
        n_act = int(np.asarray(act).sum())
        print(f"[3 parity] {name} kernel vs brick_trace: {n_act} "
              f"rays, hit agreement {agree:.5f} (min {HIT_AGREE_MIN}), "
              f"strict {strict:.5f} over {n_both} hits (min {STRICT_MIN}; "
              f"|dt|<={T_TOL}, |dn|<={NORMAL_TOL})", flush=True)
        check(agree >= HIT_AGREE_MIN and strict >= STRICT_MIN,
              f"{name} traversal parity failed")
    dev = tree.to_device()
    esvo = traverse.intersect_octree(dev.arrays(), o[:n_esvo], d[:n_esvo],
                                     packed=dev.packed_table())
    g = wavefront.intersect(ws, o[:n_esvo], d[:n_esvo])
    agree, strict, n_both = _agreement(esvo, g, np.ones(n_esvo, bool),
                                       voxel_pos_tol=VOXEL_POS_TOL)
    print(f"[3 parity] kernel vs ESVO walk: {n_esvo} rays, hit agreement "
          f"{agree:.5f} (min {ESVO_HIT_AGREE_MIN}), strict {strict:.5f} over "
          f"{n_both} hits (min {STRICT_MIN})", flush=True)
    check(agree >= ESVO_HIT_AGREE_MIN and strict >= STRICT_MIN,
          "ESVO parity failed")
    return dev


def _frame_fn(ws, width, height, mode, bounces, intersect):
    """A compiled frame for (mode, bounces); returns (fn, compile s)."""
    import jax.numpy as jnp

    from svo_raytracer_tpu.ops import render_wave

    cam_shape = jnp.zeros((5, 3), jnp.float32)
    t0 = time.perf_counter()
    compiled = render_wave.render_frame.lower(
        ws, cam_shape, jnp.float32(1), width=width, height=height,
        render_mode=mode, gi_bounces=bounces, intersect=intersect).compile()
    return compiled, time.perf_counter() - t0


def frames_phase(ws, cam5, width=FULL_W, height=FULL_H):
    import jax
    import jax.numpy as jnp

    from svo_raytracer_tpu.ops import brick_trace, render_wave, wavefront

    for mode, bounces, label in ((0, 1, "GI-1"), (0, 3, "GI-3"),
                                 (2, 1, "direct+shadow"), (3, 1, "normals")):
        fn, comp_s = _frame_fn(ws, width, height, mode, bounces,
                               wavefront.intersect)
        frames = iter(range(2, 100))

        def run():
            return fn(ws, cam5, jnp.float32(next(frames)))

        col, depth, _ = run()
        col = np.asarray(col)
        check(col.shape == (height, width, 3), f"mode {mode} frame shape")
        fin = np.isfinite(col).all(-1) | (np.asarray(depth) > 0)
        check(fin.all(), f"mode {mode}: non-finite sky pixels")
        med, mx = timed(run)
        print(f"[4 frames] {width}x{height} mode {mode} {label}: compile "
              f"{comp_s:.2f} s, median {med:.3f} ms, max {mx:.3f} ms "
              f"({N_TIMED} frames; hit fraction "
              f"{float((np.asarray(depth) > 0).mean()):.3f})", flush=True)

    # the kernel decision: kernel vs XLA's compile of brick_trace
    o, d, px, py = render_wave._frame_rays(cam5, width, height)
    ones = jnp.ones(o.shape[0], bool)
    seg_k = jax.jit(wavefront.intersect)
    seg_x = jax.jit(brick_trace.intersect_scene)
    prim = seg_k(ws, o, d, ones)
    bo, bd, bact = bounce_rays(prim, o, d, px, py, 2.0)
    gi1_x, comp_x = _frame_fn(ws, width, height, 0, 1,
                              brick_trace.intersect_scene)
    gi1_k, _ = _frame_fn(ws, width, height, 0, 1, wavefront.intersect)
    fnum = jnp.float32(2)
    for name, kern, xla in (
            ("primary segment", lambda: seg_k(ws, o, d, ones),
             lambda: seg_x(ws, o, d, ones)),
            ("GI bounce segment", lambda: seg_k(ws, bo, bd, bact),
             lambda: seg_x(ws, bo, bd, bact)),
            ("GI-1 frame", lambda: gi1_k(ws, cam5, fnum),
             lambda: gi1_x(ws, cam5, fnum))):
        km, kx = timed(kern)
        xm, xx = timed(xla)
        print(f"[4 decision] {name} {width}x{height}: kernel median "
              f"{km:.3f} ms (max {kx:.3f}), XLA brick_trace median "
              f"{xm:.3f} ms (max {xx:.3f})", flush=True)
    print(f"[4 decision] XLA GI-1 frame compile {comp_x:.2f} s", flush=True)


def frame_parity_phase(dev, ws, cam5, width=SMALL_W, height=SMALL_H):
    import jax.numpy as jnp

    from svo_raytracer_tpu.ops import render_wave, shade

    for mode in (1, 2, 3, 0):
        ref_c, ref_d, _ = shade.render_image(
            dev.arrays(), cam5, width, height, render_mode=mode,
            frame_number=3, gi_bounces=1, packed=dev.packed_table())
        got_c, got_d, _ = render_wave.render_frame_wavefront(
            ws, cam5, width, height, render_mode=mode, frame_number=3,
            gi_bounces=1)
        ref_d, got_d = np.asarray(ref_d), np.asarray(got_d)
        if mode == 1:
            agree = float(((ref_d > 0) == (got_d > 0)).mean())
            print(f"[5 frame parity] mode 1 vs ESVO {width}x{height}: hit "
                  f"structure {agree:.4f} (min {HEAT_HIT_MIN})", flush=True)
            check(agree >= HEAT_HIT_MIN, "mode 1 hit structure")
            continue
        dc = np.abs(np.asarray(ref_c) - np.asarray(got_c)).max(-1)
        fc = float((np.nan_to_num(dc, nan=0.0) <= FRAME_COLOR_TOL).mean())
        fd = float((np.abs(ref_d - got_d) <= FRAME_COLOR_TOL).mean())
        print(f"[5 frame parity] mode {mode} vs ESVO {width}x{height}: "
              f"colour match {fc:.4f}, depth match {fd:.4f} (min "
              f"{FRAME_MATCH_MIN}, tol {FRAME_COLOR_TOL})", flush=True)
        check(fc >= FRAME_MATCH_MIN and fd >= FRAME_MATCH_MIN,
              f"mode {mode} frame parity")


def train_phase(ws, cam5, width=SMALL_W, height=SMALL_H, steps=3):
    import jax.numpy as jnp

    from svo_raytracer_tpu.diff import wave_diff

    params = wave_diff.init_params(ws, init_density=4.0)
    # per-entry gradients of a mean loss scale as 1/pixels: an lr of one
    # pixel count moves a once-seen voxel by ~2/3 of its error
    step = wave_diff.make_wave_train_step(width, height, K=2,
                                          lr=float(width * height))
    target = jnp.zeros((height, width, 3), jnp.float32)
    losses = []
    t0 = time.perf_counter()
    p = params
    for _ in range(steps):
        p, loss = step(p, ws, cam5, target)
        losses.append(float(loss))
    moved = max(float(jnp.abs(a - b).max()) for a, b in zip(p, params))
    print(f"[6 train] K=2 {width}x{height}: losses {losses} (first step "
          f"incl. compile; {time.perf_counter() - t0:.1f} s total), max "
          f"param change {moved:.3e}", flush=True)
    check(all(np.isfinite(losses)), "non-finite loss")
    check(losses[-1] < losses[0], "loss did not fall")
    check(moved > 0, "zero gradients")


def edit_phase(tree, host, ws, cam5, cam, width=SMALL_W, height=SMALL_H):
    import copy

    from svo_raytracer_tpu.core import sdf
    from svo_raytracer_tpu.ops import brick_scene, render_wave, wavefront

    _, depth, _ = render_wave.render_frame_wavefront(
        ws, cam5, width, height, render_mode=3)
    centre = float(np.asarray(depth)[height // 2, width // 2])
    check(centre > 0, "edit target: the view centre hits nothing")
    target = cam.ray_pick_location(centre, tree.world_size)
    ball = sdf.Sphere(target, max(2, tree.world_size // 128))
    t0 = time.perf_counter()
    tree2, _ = sdf.use_sdf_brush(tree, ball, 1)
    host = copy.deepcopy(host)
    patch = brick_scene.brickify_patch(tree2, host, ball.min, ball.max)
    ws2 = wavefront.apply_patch(ws, host, patch)
    _, d_patch, _ = render_wave.render_frame_wavefront(
        ws2, cam5, width, height, render_mode=3)
    d_patch = np.asarray(d_patch)
    t_edit = time.perf_counter() - t0
    full = wavefront.prepare(brick_scene.brickify(tree2),
                             capacity=ws2.capacity)
    _, d_full, _ = render_wave.render_frame_wavefront(
        full, cam5, width, height, render_mode=3)
    same = np.array_equal(d_patch > 0, np.asarray(d_full) > 0)
    changed = int(((np.asarray(depth) > 0) != (d_patch > 0)).sum()
                  + (np.abs(np.asarray(depth) - d_patch) > 1e-6).sum())
    print(f"[7 edit] sphere r={ball.radius} at {target.tolist()}: edit + "
          f"patch + render {t_edit:.2f} s, {len(patch.cells)} brick cells, "
          f"{changed} pixels changed; hit mask equals full re-brickify: "
          f"{same}", flush=True)
    check(same, "patched scene renders differently from a full rebuild")
    check(changed > 0, "the edit changed no pixel")


def multi_phase(ws, cam5, n_cards=4):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from svo_raytracer_tpu.diff import wave_diff
    from svo_raytracer_tpu.ops import render_wave
    from svo_raytracer_tpu.parallel import mesh as mesh_mod
    from svo_raytracer_tpu.parallel import render_wave_sharded as rws

    m = mesh_mod.tile_mesh(n_cards)
    # the scene lives on every card once, not copied per call
    ws_rep = jax.device_put(ws, NamedSharding(m, P()))
    render = rws.make_wave_sharded_render(m, FULL_W, FULL_H, render_mode=0,
                                          gi_bounces=1)
    t0 = time.perf_counter()
    col = np.asarray(render(ws_rep, cam5, 2))
    comp_s = time.perf_counter() - t0
    med, mx = timed(render, ws_rep, cam5, 2)
    ref = np.asarray(render_wave.render_frame_wavefront(
        ws, cam5, FULL_W, FULL_H, render_mode=0, frame_number=2)[0])
    ok = np.abs(col - ref) <= SHARD_PIX_TOL
    frac = float((ok | (np.isnan(col) & np.isnan(ref))).mean())
    one_med, one_max = timed(lambda: render_wave.render_frame_wavefront(
        ws, cam5, FULL_W, FULL_H, render_mode=0, frame_number=2)[0])
    print(f"[multi] {n_cards}-card row-sharded GI-1 {FULL_W}x{FULL_H}: "
          f"first call {comp_s:.2f} s, median {med:.3f} ms (max {mx:.3f}); "
          f"1-card median {one_med:.3f} ms (max {one_max:.3f}); pixels "
          f"within {SHARD_PIX_TOL}: {frac:.5f} (min {SHARD_MATCH_MIN})",
          flush=True)
    check(frac >= SHARD_MATCH_MIN, "sharded frame differs from one card")

    W, H = SMALL_W, 272          # rows divide over the cards
    params = wave_diff.init_params(ws, init_density=4.0)
    target = jnp.zeros((H, W, 3), jnp.float32)
    lr = 2.0
    step_sh = wave_diff.make_wave_sharded_train_step(m, W, H, K=2, lr=lr)
    step_un = wave_diff.make_wave_train_step(W, H, K=2, lr=lr)
    p_sh, loss_sh = step_sh(jax.device_put(params, NamedSharding(m, P())),
                            ws_rep, cam5, target)
    p_un, loss_un = step_un(params, ws, cam5, target)
    jax.block_until_ready((p_sh, p_un))
    dd = max(float(jnp.abs(a - b).max()) for a, b in zip(p_sh, p_un))
    moved = max(float(jnp.abs(a - b).max()) for a, b in zip(p_sh, params))
    rel = abs(float(loss_sh) - float(loss_un)) / abs(float(loss_un))
    print(f"[multi] {n_cards}-card K=2 train step {W}x{H}: loss "
          f"{float(loss_sh):.6f} vs 1-card {float(loss_un):.6f} (rel "
          f"{rel:.2e}, max {SHARD_LOSS_RTOL}); max |param diff| {dd:.3e} "
          f"(max {SHARD_PARAM_ATOL}); max param change {moved:.3e}",
          flush=True)
    check(rel <= SHARD_LOSS_RTOL and dd <= SHARD_PARAM_ATOL,
          "sharded train step differs from one card")
    check(moved > 0, "zero gradients in the sharded step")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="four cards: sharded frame and train step only")
    args = ap.parse_args(argv)
    n_cards = 4 if args.multi else 1

    import jax
    import jax.numpy as jnp

    from svo_raytracer_tpu.models import world as world_mod
    from svo_raytracer_tpu.utils import compile_cache

    compile_cache.enable()
    devs = device_phase(n_cards)
    tree, host, ws = build_phase(args.seed)
    cam = world_mod.terrain_camera(ws)
    cam5 = jnp.asarray(cam.uniform(), jnp.float32)
    print(f"camera at {np.round(cam.pos, 4).tolist()}", flush=True)
    if args.multi:
        multi_phase(ws, cam5, n_cards)
    else:
        dev = parity_phase(tree, ws, cam5, args.seed)
        frames_phase(ws, cam5)
        frame_parity_phase(dev, ws, cam5)
        train_phase(ws, cam5)
        edit_phase(tree, host, ws, cam5, cam)
    print(f"card: {gpu_name_and_power_limit()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
