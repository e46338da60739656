"""Per-ray brick traversal — the production engine.

Re-expresses the reference's per-pixel octree walk
(src/shaders/svotrace.comp:211-432: one compute-shader invocation per
pixel, walking the tree in registers) as one Pallas kernel on the Triton
route.  A program traces a block of ``BLOCK`` rays; every lane runs the
two-level DDA of the XLA reference ops/brick_trace.py as a small state
machine inside one ``lax.while_loop``:

  L0_INIT   slab-test the world box from the current round origin and
            set up the brick-grid march (cell 32);
  STEP      one DDA step at the current level: probe the cell; at L0 a
            solid cell either resolves (uniform-solid brick) or enters
            its mixed brick; inside a brick a solid voxel resolves;
  FINE_INIT set up the voxel march (cell 1) inside the mixed brick;
  DONE      hit recorded, or the ray left the world.

The loop ends when every lane of the block is DONE.  Tables are read by
gathers from device memory: the flat L0 bits, ``brick_slot``, the 32^3
occupancy words of mixed bricks and the attribute words.  Arithmetic
mirrors brick_trace op for op (slab test, push, first cell, exit nudge,
round cap), so the two engines agree to FP contraction slop; the kernel
writes the same raw hit record and :func:`brick_trace.decode_hits`
builds the HitResult, so decode semantics are shared, not re-derived.

Scene format (:class:`WaveScene`): the BrickScene tables flattened, with
mixed-brick payloads allocated at ``capacity`` >= n_mixed slots so edits
(:func:`apply_patch`) keep every shape and never recompile.  ``attrs``
holds the mixed-brick voxel words (slot*32768 + widx) followed by one
word per brick cell (capacity*32768 + cell); that index is
``HitResult.node``, the per-voxel id diff/wave_diff.py keys its
parameters by.  It must fit in int32 (:func:`prepare` raises otherwise).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import brick_trace

f32 = jnp.float32
i32 = jnp.int32

#: rays per kernel program (a power of two, as Triton requires; 128
#: measured faster than 64 and 256 on the H100, PERF.md)
BLOCK = 128
#: brick_trace's default round cap: one round = one L0 march + one brick
MAX_ROUNDS = 64
BRICK_WORDS = 32 * 32 * 32   # attribute words per mixed brick
OCC_WORDS = 32 * 32          # occupancy words per mixed brick
_INT32_MAX = (1 << 31) - 1

L0_INIT, STEP, FINE_INIT, DONE = 0, 1, 2, 3


def use_interpret() -> bool:
    """The one place that decides how Pallas kernels run: interpreted on
    the CPU (the test route), compiled for the GPU; any other platform
    has no route and raises."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(f"no Pallas route for platform {backend!r}; the "
                       "traversal kernel runs on 'gpu' (or 'cpu' "
                       "interpreted)")


# --------------------------------------------------------------------- scene
@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["n_mixed", "l0", "brick_slot", "occ",
                                "attrs"],
                   meta_fields=["world_size", "grid_size", "capacity"])
@dataclasses.dataclass
class WaveScene:
    """Device-ready brick scene (a pytree: pass it straight into jit)."""

    world_size: int
    grid_size: int
    capacity: int     # mixed-brick slots allocated (>= n_mixed)
    n_mixed: Any      # mixed bricks in use (host int; traced under jit)
    l0: Any           # (G*G*ceil(G/32),) i32 — z-packed occupied-brick bits
    brick_slot: Any   # (G^3,) i32 — mixed slot per brick cell, -1 if uniform
    occ: Any          # (capacity*1024,) i32 — 32^3 occupancy bits per slot
    attrs: Any        # (capacity*32768 + G^3,) i32 — voxel ++ brick words


def check_index_range(capacity: int, grid_size: int) -> None:
    """Attribute indices (HitResult.node) must fit in int32."""
    n = capacity * BRICK_WORDS + grid_size ** 3
    if n > _INT32_MAX:
        raise ValueError(
            f"scene needs {n} attribute words (capacity {capacity}, G="
            f"{grid_size}); the traversal indexes them in int32 "
            f"(max {_INT32_MAX})")


def default_capacity(n_mixed: int) -> int:
    return n_mixed + max(64, n_mixed // 8)


def prepare(scene, capacity: int | None = None) -> WaveScene:
    """Upload a host BrickScene (ops/brick_scene.py) as a WaveScene."""
    G = scene.grid_size
    if capacity is None:
        capacity = default_capacity(scene.n_mixed)
    if capacity < scene.n_mixed:
        raise ValueError(f"capacity {capacity} < n_mixed {scene.n_mixed}")
    check_index_range(capacity, G)
    nm = min(scene.occ_words.shape[0], capacity)
    occ = np.zeros(capacity * OCC_WORDS, np.int32)
    occ[:nm * OCC_WORDS] = np.asarray(scene.occ_words[:nm]).reshape(-1)
    attrs = np.zeros(capacity * BRICK_WORDS + G ** 3, np.int32)
    attrs[:nm * BRICK_WORDS] = np.asarray(scene.attrs[:nm]).reshape(-1)
    attrs[capacity * BRICK_WORDS:] = np.asarray(scene.brick_attr)
    return WaveScene(
        world_size=scene.world_size, grid_size=G, capacity=capacity,
        n_mixed=int(scene.n_mixed),
        l0=jnp.asarray(_l0_words(scene), i32),
        brick_slot=jnp.asarray(scene.brick_slot, i32),
        occ=jnp.asarray(occ), attrs=jnp.asarray(attrs))


def _l0_words(scene):
    G = scene.grid_size
    W = -(-G // 32)
    return np.asarray(scene.l0_table, np.int32).reshape(-1)[:G * G * W]


@functools.partial(jax.jit, donate_argnums=(0,))
def _apply_patch_dev(ws, l0, upd_slots, occ_rows, attr_rows, cells,
                     cell_slot, cell_attr):
    cap = ws.capacity
    occ = ws.occ.reshape(cap, OCC_WORDS).at[upd_slots].set(occ_rows)
    head = ws.attrs[:cap * BRICK_WORDS].reshape(cap, BRICK_WORDS)
    head = head.at[upd_slots].set(attr_rows)
    tail = ws.attrs[cap * BRICK_WORDS:].at[cells].set(cell_attr)
    return dataclasses.replace(
        ws, l0=l0, brick_slot=ws.brick_slot.at[cells].set(cell_slot),
        occ=occ.reshape(-1),
        attrs=jnp.concatenate([head.reshape(-1), tail]))


def apply_patch(ws: WaveScene, scene, patch) -> WaveScene:
    """Apply a brick_scene.ScenePatch (host scene already updated) to the
    device scene: upload only the changed brick rows and the L0 bits —
    the analog of the reference's ranged SSBO uploads after an edit
    (Main.java:349-350).  A patch that outgrows ``capacity`` re-prepares
    with more headroom (new shapes, so the next frame recompiles).
    ``ws`` is donated."""
    if patch.n_mixed > ws.capacity:
        return prepare(scene, capacity=default_capacity(patch.n_mixed))
    p = len(patch.upd_slots)
    new = _apply_patch_dev(
        ws, jnp.asarray(_l0_words(scene), i32),
        jnp.asarray(patch.upd_slots, i32),
        jnp.asarray(np.asarray(patch.occ_rows).reshape(p, OCC_WORDS), i32),
        jnp.asarray(np.asarray(patch.attr_rows).reshape(p, BRICK_WORDS), i32),
        jnp.asarray(patch.cells, i32), jnp.asarray(patch.cell_slot, i32),
        jnp.asarray(patch.cell_attr, i32))
    new.n_mixed = int(patch.n_mixed)
    return new


# -------------------------------------------------------------------- kernel
class _Lanes(NamedTuple):
    """Per-lane loop state of the traversal kernel."""

    phase: Any
    level: Any      # 0: brick-grid march, 1: voxel march in a mixed brick
    ix: Any
    iy: Any
    iz: Any
    tx: Any
    ty: Any
    tz: Any
    t: Any          # march distance from the march origin (last crossing)
    msteps: Any     # steps taken by the current march
    t_vox: Any      # round origin distance along the ray
    t_a: Any        # L0 march distance to the entered brick
    bx: Any
    by: Any
    bz: Any
    slot: Any
    rnd: Any
    iters: Any
    node: Any       # attribute index of the hit, -1 if none
    attr: Any
    hvx: Any
    hvy: Any
    hvz: Any
    t_hit: Any


def _clamp_dir(d):
    # brick_trace._clamp_dir with Python-float constants (Triton cannot
    # negate a folded array constant)
    return jnp.where(jnp.abs(d) < 1e-4, jnp.where(d >= 0, 1e-4, -1e-4), d)


def _any(mask):
    # block-wide any; Triton lowers integer max reductions, not bool ones
    return jnp.max(mask.astype(i32)) > 0


def _trace_kernel(l0_ref, slot_ref, occ_ref, attr_ref, ox_ref, oy_ref,
                  oz_ref, dx_ref, dy_ref, dz_ref, act_ref, node_ref,
                  attr_out_ref, t_ref, it_ref, vx_ref, vy_ref, vz_ref, *,
                  G, cap, max_rounds):
    ws = G * 32
    W = -(-G // 32)
    uni_base = cap * BRICK_WORDS
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]   # voxel units
    rx, ry, rz = dx_ref[...], dy_ref[...], dz_ref[...]   # unit direction
    cx, cy, cz = (_clamp_dir(c) for c in (rx, ry, rz))
    inv_x, inv_y, inv_z = 1.0 / cx, 1.0 / cy, 1.0 / cz
    sx = jnp.where(cx > 0, i32(1), i32(-1))
    sy = jnp.where(cy > 0, i32(1), i32(-1))
    sz = jnp.where(cz > 0, i32(1), i32(-1))
    alive = act_ref[...] != 0

    def load(ref, idx, mask):
        return plgpu.load(ref.at[jnp.where(mask, idx, 0)], mask=mask,
                          other=0)

    def march_init(px, py, pz, extent, cell):
        # brick_trace._march set-up: slab test, push inside, first cell
        gf = f32(extent)
        t1x, t2x = (0.0 - px) * inv_x, (gf - px) * inv_x
        t1y, t2y = (0.0 - py) * inv_y, (gf - py) * inv_y
        t1z, t2z = (0.0 - pz) * inv_z, (gf - pz) * inv_z
        t_ent = jnp.maximum(jnp.maximum(jnp.minimum(t1x, t2x),
                                        jnp.minimum(t1y, t2y)),
                            jnp.minimum(t1z, t2z))
        t_exit = jnp.minimum(jnp.minimum(jnp.maximum(t1x, t2x),
                                         jnp.maximum(t1y, t2y)),
                             jnp.maximum(t1z, t2z))
        t0 = jnp.maximum(t_ent, 0.0)
        misses = (t_ent > t_exit) | (t_exit < 0.0)
        push = jnp.where(t0 > 0.0, t0 + f32(1e-4) * cell, 0.0)
        qx, qy, qz = px + push * cx, py + push * cy, pz + push * cz
        n = extent // cell
        inv_cell = f32(1.0 / cell)   # exact: cell is a power of two
        ix = jnp.clip((qx * inv_cell).astype(i32), 0, n - 1)
        iy = jnp.clip((qy * inv_cell).astype(i32), 0, n - 1)
        iz = jnp.clip((qz * inv_cell).astype(i32), 0, n - 1)
        tx = push + (jnp.where(cx > 0, ix + 1, ix).astype(f32) * cell
                     - qx) * inv_x
        ty = push + (jnp.where(cy > 0, iy + 1, iy).astype(f32) * cell
                     - qy) * inv_y
        tz = push + (jnp.where(cz > 0, iz + 1, iz).astype(f32) * cell
                     - qz) * inv_z
        return misses, ix, iy, iz, tx, ty, tz, push

    def start(s, go, level, init):
        misses, ix, iy, iz, tx, ty, tz, push = init
        return s._replace(
            phase=jnp.where(go, STEP, s.phase),
            level=jnp.where(go, level, s.level),
            ix=jnp.where(go, ix, s.ix), iy=jnp.where(go, iy, s.iy),
            iz=jnp.where(go, iz, s.iz), tx=jnp.where(go, tx, s.tx),
            ty=jnp.where(go, ty, s.ty), tz=jnp.where(go, tz, s.tz),
            t=jnp.where(go, push, s.t), msteps=jnp.where(go, 0, s.msteps))

    def l0_init(s):
        # a new round: march the brick grid from the round origin
        want = s.phase == L0_INIT
        init = march_init(ox + s.t_vox * rx, oy + s.t_vox * ry,
                          oz + s.t_vox * rz, ws, 32)
        dead = want & ((s.rnd >= max_rounds) | init[0])
        go = want & ~dead
        s = start(s, go, 0, init)
        return s._replace(phase=jnp.where(dead, DONE, s.phase),
                          rnd=s.rnd + go.astype(i32))

    def fine_init(s):
        # march the voxels of the entered mixed brick from its entry point
        want = s.phase == FINE_INIT
        init = march_init(
            ox + s.t_vox * rx + s.t_a * rx - (s.bx * 32).astype(f32),
            oy + s.t_vox * ry + s.t_a * ry - (s.by * 32).astype(f32),
            oz + s.t_vox * rz + s.t_a * rz - (s.bz * 32).astype(f32), 32, 1)
        skip = want & init[0]
        s = start(s, want & ~skip, 1, init)
        # a brick the slab test misses (FP edge) is crossed as empty
        return s._replace(
            phase=jnp.where(skip, L0_INIT, s.phase),
            t_vox=jnp.where(skip, s.t_vox + s.t_a + f32(brick_trace._EXIT_EPS),
                            s.t_vox))

    def step(s):
        lvl0 = s.level == 0
        n = jnp.where(lvl0, G, 32)
        stepping = s.phase == STEP
        inside = ((s.ix >= 0) & (s.ix < n) & (s.iy >= 0) & (s.iy < n)
                  & (s.iz >= 0) & (s.iz < n))
        probe = stepping & inside
        m0, m1 = probe & lvl0, probe & ~lvl0
        word0 = load(l0_ref, (s.ix * G + s.iy) * W + (s.iz >> 5), m0)
        word1 = load(occ_ref, s.slot * OCC_WORDS + s.ix * 32 + s.iy, m1)
        bit = jnp.where(lvl0, (word0 >> (s.iz & 31)) & 1,
                        (word1 >> s.iz) & 1)
        solid = probe & (bit != 0)
        s0, s1 = solid & lvl0, solid & ~lvl0

        # resolve the solid cell: the brick's slot (L0) and attr word
        cell = (s.ix * G + s.iy) * G + s.iz
        slot_n = load(slot_ref, cell, s0)
        aidx = jnp.where(lvl0, uni_base + cell,
                         s.slot * BRICK_WORDS + s.ix * 1024 + s.iy * 32
                         + s.iz)
        word = load(attr_ref, aidx, solid & (~lvl0 | (slot_n < 0)))
        uni_hit = s0 & (slot_n < 0) & ((word & 0xFF) != 0)
        enter = s0 & (slot_n >= 0)
        hit = uni_hit | s1

        # uniform-solid brick: the hit voxel is where the ray enters it
        px = ox + s.t_vox * rx + s.t * rx
        py = oy + s.t_vox * ry + s.t * ry
        pz = oz + s.t_vox * rz + s.t * rz
        bx32, by32, bz32 = s.ix * 32, s.iy * 32, s.iz * 32
        hvx = jnp.where(lvl0, jnp.clip(px.astype(i32), bx32, bx32 + 31),
                        s.bx * 32 + s.ix)
        hvy = jnp.where(lvl0, jnp.clip(py.astype(i32), by32, by32 + 31),
                        s.by * 32 + s.iy)
        hvz = jnp.where(lvl0, jnp.clip(pz.astype(i32), bz32, bz32 + 31),
                        s.bz * 32 + s.iz)
        t_hit = jnp.where(lvl0, s.t_vox + s.t, (s.t_vox + s.t_a) + s.t)

        # advance empty cells one DDA step
        adv = probe & ~solid
        mx = (s.tx <= s.ty) & (s.tx <= s.tz)
        my = ~mx & (s.ty <= s.tz)
        mz = ~mx & ~my
        cell_sz = jnp.where(lvl0, f32(32.0), f32(1.0))
        tcur = jnp.minimum(jnp.minimum(s.tx, s.ty), s.tz)
        t = jnp.where(adv, tcur, s.t)
        ix = jnp.where(adv & mx, s.ix + sx, s.ix)
        iy = jnp.where(adv & my, s.iy + sy, s.iy)
        iz = jnp.where(adv & mz, s.iz + sz, s.iz)
        tx = jnp.where(adv & mx, s.tx + jnp.abs(inv_x) * cell_sz, s.tx)
        ty = jnp.where(adv & my, s.ty + jnp.abs(inv_y) * cell_sz, s.ty)
        tz = jnp.where(adv & mz, s.tz + jnp.abs(inv_z) * cell_sz, s.tz)
        msteps = s.msteps + adv.astype(i32)
        capped = adv & (msteps == jnp.where(lvl0, 3 * G + 4, 100))
        inside_new = ((ix >= 0) & (ix < n) & (iy >= 0) & (iy < n)
                      & (iz >= 0) & (iz < n))

        # leaving a march: the world (miss), a brick (next round), or the
        # step cap (next round from the last crossing, as brick_trace)
        exit_ = stepping & ~inside
        done = (hit | (exit_ & lvl0) | (capped & lvl0 & ~inside_new)
                | (s0 & (slot_n < 0) & ~uni_hit))
        next_round = (exit_ | capped) & ~done
        t_next = jnp.where(lvl0, s.t_vox + t,
                           (s.t_vox + s.t_a) + t) + f32(brick_trace._EXIT_EPS)
        phase = jnp.where(done, DONE, s.phase)
        phase = jnp.where(next_round, L0_INIT, phase)
        phase = jnp.where(enter, FINE_INIT, phase)
        return s._replace(
            phase=phase, ix=ix, iy=iy, iz=iz, tx=tx, ty=ty, tz=tz, t=t,
            msteps=msteps,
            t_vox=jnp.where(next_round, t_next, s.t_vox),
            t_a=jnp.where(enter, s.t, s.t_a),
            bx=jnp.where(enter, s.ix, s.bx), by=jnp.where(enter, s.iy, s.by),
            bz=jnp.where(enter, s.iz, s.bz),
            slot=jnp.where(enter, slot_n, s.slot),
            iters=s.iters + adv.astype(i32),
            node=jnp.where(hit, aidx, s.node),
            attr=jnp.where(hit, word, s.attr),
            hvx=jnp.where(hit, hvx, s.hvx), hvy=jnp.where(hit, hvy, s.hvy),
            hvz=jnp.where(hit, hvz, s.hvz),
            t_hit=jnp.where(hit, t_hit, s.t_hit))

    def body(s):
        s = jax.lax.cond(_any(s.phase == L0_INIT), l0_init, lambda s: s, s)
        s = jax.lax.cond(_any(s.phase == FINE_INIT), fine_init,
                         lambda s: s, s)
        return step(s)

    zi = jnp.zeros_like(ox, dtype=i32)
    zf = jnp.zeros_like(ox)
    s = _Lanes(phase=jnp.where(alive, L0_INIT, DONE), level=zi, ix=zi,
               iy=zi, iz=zi, tx=zf, ty=zf, tz=zf, t=zf, msteps=zi, t_vox=zf,
               t_a=zf, bx=zi, by=zi, bz=zi, slot=zi, rnd=zi, iters=zi,
               node=zi - 1, attr=zi, hvx=zi, hvy=zi, hvz=zi, t_hit=zf)
    s = jax.lax.while_loop(lambda s: _any(s.phase != DONE), body, s)
    node_ref[...] = s.node
    attr_out_ref[...] = s.attr
    t_ref[...] = s.t_hit
    it_ref[...] = s.iters
    vx_ref[...] = s.hvx
    vy_ref[...] = s.hvy
    vz_ref[...] = s.hvz


def _trace_call(wscene, ov, d, alive):
    """Run the kernel over (Bp,) SoA rays, Bp a multiple of BLOCK."""
    Bp = ov.shape[0]
    kern = functools.partial(_trace_kernel, G=wscene.grid_size,
                             cap=wscene.capacity, max_rounds=MAX_ROUNDS)
    tables = (wscene.l0, wscene.brick_slot, wscene.occ, wscene.attrs)
    ray = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = [pl.BlockSpec(a.shape, lambda i: (0,)) for a in tables]
    out_shape = [jax.ShapeDtypeStruct((Bp,), dt)
                 for dt in (i32, i32, f32, i32, i32, i32, i32)]
    return pl.pallas_call(
        kern, out_shape=out_shape, grid=(Bp // BLOCK,),
        in_specs=whole + [ray] * 7, out_specs=[ray] * 7,
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend="triton", interpret=use_interpret(),
        name="brick_traversal",
    )(*tables, ov[:, 0], ov[:, 1], ov[:, 2], d[:, 0], d[:, 1], d[:, 2],
      alive.astype(i32))


@jax.jit
def intersect(wscene: WaveScene, origins, dirs, active=None):
    """Trace (B,3) rays against a WaveScene; returns a HitResult.

    ``dirs`` should be unit length (t is measured along them, as in
    brick_trace).  Rays that are inactive or not finite miss.  LOD caps
    do not apply: the engine always resolves the finest leaf.
    """
    B = origins.shape[0]
    o = origins.astype(f32)
    d = dirs.astype(f32)
    alive = jnp.all(jnp.isfinite(o) & jnp.isfinite(d), axis=1)
    if active is not None:
        alive = alive & active.astype(bool)
    ov = jnp.where(alive[:, None], (o - 1.0) * f32(wscene.world_size), 0.0)
    dv = jnp.where(alive[:, None], d, 1.0)
    pad = (-B) % BLOCK
    if pad:
        ov = jnp.pad(ov, ((0, pad), (0, 0)))
        dv = jnp.pad(dv, ((0, pad), (0, 0)), constant_values=1.0)
        alive = jnp.pad(alive, (0, pad))
    node, attr, t, iters, vx, vy, vz = (
        a[:B] for a in _trace_call(wscene, ov, dv, alive))
    return brick_trace.decode_hits(wscene.world_size, o, d, node >= 0, attr,
                                   vx, vy, vz, t, iters, node=node)
