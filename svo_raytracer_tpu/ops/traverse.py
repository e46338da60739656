"""Batched ESVO ray traversal — jitted XLA implementation.

The reference runs the Laine-Karras stack traversal one GL thread per pixel
with data-dependent `while`/`break` (``src/shaders/svotrace.comp:211-432``).
On a lock-step vector machine that becomes a while_loop whose body advances
*every ray in the batch* one traversal step, with per-ray active masks
instead of ``break`` (SURVEY.md §2.2 row 1).

Design:

* Ray state is (R, 128) 2-D.
* The hot loop fetches ONE packed word per ray per step:
  ``packed[i] = (effective_child_base << 1) | (value != 0)`` — the node's
  2-bit type tag (stored in the *parent's* mask in the SoA/byte formats,
  Octree.java:589-599) is folded into its own word, zeroing the child base
  for non-branch tags exactly like the extract* functions
  (svotrace.comp:103-130).
* The loop is two-level: an inner K-step fori_loop whose carries stay in
  registers (XLA fuses counter-conditioned loops into one kernel; an
  any-ray-alive reduction in the cond forces a materialization, so it is
  only checked once per K steps in the outer while_loop).
* Iteration caps are per-ray (iters < max_iterations), exactly the
  reference's per-thread `iter > MAX ? return false` (svotrace.comp:264-266).
* The t_max stack of the reference is algebraically redundant (the popped
  parent cube's exit t is recomputable from the truncated corner position —
  bit-exactly), so only parent node ids are stacked, in a
  (stack_depth, R, 128) window indexed by absolute scale.

The float-mantissa POP trick (svotrace.comp:347-368) carries over unchanged:
pure int32/float32 bit math (``bitcast_convert_type`` + ``clz``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import constants as C

f32 = jnp.float32
i32 = jnp.int32

MAX_SCALE = C.MAX_SCALE
_EPS = f32(C.EPSILON)

LANES = 128
#: inner fused steps between outer all-done checks (fewer materialized
#: convergence checks vs over-stepping of done lanes; not tuned on the GPU)
INNER_STEPS = 4


class HitResult(NamedTuple):
    """Batched castResult (svotrace.comp:186-197); fields are (B,) / (B,3)."""

    hit: jax.Array         # bool — scale < MAX_SCALE && t_min <= t_max
    value: jax.Array       # i32 material of hit node
    t: jax.Array           # f32 hit distance (t_min)
    iters: jax.Array       # i32 traversal iterations spent
    scale_exp2: jax.Array  # f32 edge length of the hit cube
    depth: jax.Array       # i32 MAX_SCALE - scale
    normal: jax.Array      # f32 (B,3) decoded digit-packed normal
    hit_pos: jax.Array     # f32 (B,3) origin + t*dir + normal*scale_exp2*2
    voxel_pos: jax.Array   # f32 (B,3) un-mirrored cube corner + normal offset
    node: jax.Array        # i32 SoA index of hit node (-1-free; mask with hit)


def _bits(x):
    return jax.lax.bitcast_convert_type(x, jnp.uint32)


def _float(b):
    return jax.lax.bitcast_convert_type(b.astype(jnp.uint32), jnp.float32)


def _find_msb(x):
    """findMSB on uint32: 31 - clz (svotrace.comp:352)."""
    return i32(31) - jax.lax.clz(x.astype(jnp.uint32)).astype(i32)


@jax.jit
def make_packed_table(tree_arrays):
    """(N,) int32 per-node word: (effective child base << 1) | value_nonzero."""
    child, mask, value, normal = tree_arrays
    n = child.shape[0]
    tags = jnp.zeros(n, i32)
    is_branch = child != 0
    base = jnp.where(is_branch, child, n)  # n = dropped scatter sentinel
    for k in range(8):
        tags = tags.at[base + k].set(
            jnp.where(is_branch, (mask >> (2 * k)) & 3, 0), mode="drop")
    eff_child = jnp.where(tags == C.TAG_BRANCH, child, 0)
    return (eff_child << 1) | (value != 0).astype(i32)


def _setup(origin, direction, max_depth, cone_trace, active, stack_depth):
    """Shared ray/state initialization (svotrace.comp:226-257).

    Returns ``(state, const)`` dicts of (R, 128)-shaped arrays: ``state``
    evolves per step; ``const`` holds per-ray constants (t-coefficients,
    mirror octant, clamped dirs, retirement mask) the step/decode read.
    """
    o = origin.astype(f32)
    d = direction.astype(f32)
    B = o.shape[0]
    pad = (-B) % LANES
    R = (B + pad) // LANES

    def shape2(a):
        return jnp.pad(a, (0, pad)).reshape(R, LANES)

    ox, oy, oz = shape2(o[:, 0]), shape2(o[:, 1]), shape2(o[:, 2])
    dx0, dy0, dz0 = shape2(d[:, 0]), shape2(d[:, 1]), shape2(d[:, 2])

    def clamp(v):
        return jnp.where(jnp.abs(v) < _EPS, jnp.where(v >= 0, _EPS, -_EPS), v)

    dx, dy, dz = clamp(dx0), clamp(dy0), clamp(dz0)

    cx = f32(1.0) / -jnp.abs(dx)
    cy = f32(1.0) / -jnp.abs(dy)
    cz = f32(1.0) / -jnp.abs(dz)
    bx = cx * ox
    by = cy * oy
    bz = cz * oz

    octant = ((dx > 0).astype(i32) | ((dy > 0).astype(i32) << 1)
              | ((dz > 0).astype(i32) << 2))
    bx = jnp.where(dx > 0, f32(3.0) * cx - bx, bx)
    by = jnp.where(dy > 0, f32(3.0) * cy - by, by)
    bz = jnp.where(dz > 0, f32(3.0) * cz - bz, bz)

    t_min = jnp.maximum(jnp.maximum(f32(2.0) * cx - bx, f32(2.0) * cy - by),
                        f32(2.0) * cz - bz)
    t_max = jnp.minimum(jnp.minimum(cx - bx, cy - by), cz - bz)
    t_min = jnp.maximum(t_min, f32(0.0))
    h = t_max

    cond_x = f32(1.5) * cx - bx > t_min
    cond_y = f32(1.5) * cy - by > t_min
    cond_z = f32(1.5) * cz - bz > t_min
    idx = (cond_x.astype(i32) | (cond_y.astype(i32) << 1)
           | (cond_z.astype(i32) << 2))
    px = jnp.where(cond_x, f32(1.5), f32(1.0))
    py_ = jnp.where(cond_y, f32(1.5), f32(1.0))
    pz = jnp.where(cond_z, f32(1.5), f32(1.0))

    # NaN origins/directions never satisfy any step comparison and would
    # spin to the iteration cap; retire them immediately as misses.
    finite = (jnp.isfinite(ox) & jnp.isfinite(oy) & jnp.isfinite(oz)
              & jnp.isfinite(dx0) & jnp.isfinite(dy0) & jnp.isfinite(dz0))
    if active is None:
        dead0 = ~finite
    else:
        act2 = shape2(active.astype(i32)) != 0
        dead0 = ~act2 | ~finite

    parent = jnp.zeros((R, LANES), i32)
    scale = jnp.full((R, LANES), MAX_SCALE - 1, i32)
    scale_exp2 = jnp.full((R, LANES), 0.5, f32)
    max_depth_v = jnp.broadcast_to(jnp.asarray(max_depth, i32), (R, LANES))
    cone = jnp.asarray(cone_trace, bool)

    stack_node = jnp.zeros((stack_depth, R, LANES), i32)

    state = dict(
        t_min=t_min, t_max=t_max, h=h, idx=idx, px=px, py=py_, pz=pz,
        parent=parent, parent_word=jnp.zeros((R, LANES), i32), scale=scale,
        scale_exp2=scale_exp2, max_depth=max_depth_v,
        stack_node=stack_node, stack_word=jnp.zeros_like(stack_node),
        done=dead0, iters=jnp.zeros((R, LANES), i32),
    )
    const = dict(cx=cx, cy=cy, cz=cz, bx=bx, by=by, bz=bz, octant=octant,
                 dead0=dead0, dx=dx, dy=dy, dz=dz)
    return state, const, cone, B


def _make_step(const, packed, max_it, cone, stack_depth):
    """Build the one-traversal-step function over (R, 128) state."""
    cx, cy, cz = const["cx"], const["cy"], const["cz"]
    bx, by, bz = const["bx"], const["by"], const["bz"]
    octant = const["octant"]
    stack_lo = i32(MAX_SCALE - stack_depth)
    scale_iota = (jnp.arange(stack_depth, dtype=i32)[:, None, None]
                  + stack_lo)
    root_word = packed[0]  # loop-invariant; hoisted out of the hot loop

    def step(s):
        act = ~s["done"] & (s["iters"] < max_it)
        iters = s["iters"] + act.astype(i32)
        t_min, t_max, hh = s["t_min"], s["t_max"], s["h"]
        idx, scale, scale_exp2 = s["idx"], s["scale"], s["scale_exp2"]
        px, py_, pz = s["px"], s["py"], s["pz"]
        parent, parent_word = s["parent"], s["parent_word"]

        # cone-trace LOD clamp (svotrace.comp:275-277) — sticky like the
        # shader's in-place maxDepth assignment
        max_depth_v = jnp.where(cone & (t_min > f32(0.05)), i32(11),
                                s["max_depth"])

        tx_corner = px * cx - bx
        ty_corner = py_ * cy - by
        tz_corner = pz * cz - bz
        tc_max = jnp.minimum(jnp.minimum(tx_corner, ty_corner), tz_corner)

        child_shift = idx ^ octant
        ci = (parent_word >> 1) + child_shift
        cword = packed[ci]                      # THE gather
        cvalue_nz = (cword & 1) != 0
        ccp = cword >> 1

        hit_cond = act & cvalue_nz & (t_min <= t_max)
        depth_break = hit_cond & (MAX_SCALE - scale == max_depth_v)

        tv_max = jnp.minimum(t_max, tc_max)
        half = scale_exp2 * f32(0.5)
        descend = hit_cond & ~depth_break & (t_min <= tv_max)
        leaf_break = descend & (ccp == 0)
        push = descend & ~leaf_break

        # --- PUSH (svotrace.comp:315-334) ---
        # the parent's packed word is stacked alongside its id so POP needs
        # no table fetch — one random gather per step instead of two
        do_store = push & (tc_max < hh)
        store_row = (scale_iota == scale[None]) & do_store[None]
        stack_node = jnp.where(store_row, parent[None], s["stack_node"])
        stack_word = jnp.where(store_row, parent_word[None], s["stack_word"])
        hh = jnp.where(push, tc_max, hh)
        parent = jnp.where(push, ci, parent)
        parent_word = jnp.where(push, cword, parent_word)

        tx_center = half * cx + tx_corner
        ty_center = half * cy + ty_corner
        tz_center = half * cz + tz_corner
        cxm = tx_center > t_min
        cym = ty_center > t_min
        czm = tz_center > t_min
        pidx = (cxm.astype(i32) | (cym.astype(i32) << 1)
                | (czm.astype(i32) << 2))
        idx = jnp.where(push, pidx, idx)
        px = jnp.where(push & cxm, px + half, px)
        py_ = jnp.where(push & cym, py_ + half, py_)
        pz = jnp.where(push & czm, pz + half, pz)
        scale = jnp.where(push, scale - 1, scale)
        scale_exp2 = jnp.where(push, half, scale_exp2)
        t_max = jnp.where(push, tv_max, t_max)

        # --- ADVANCE (svotrace.comp:337-344) ---
        adv = act & ~depth_break & ~leaf_break & ~push
        sx = adv & (tx_corner <= tc_max)
        sy = adv & (ty_corner <= tc_max)
        sz = adv & (tz_corner <= tc_max)
        step_mask = (sx.astype(i32) | (sy.astype(i32) << 1)
                     | (sz.astype(i32) << 2))
        apx = jnp.where(sx, px - scale_exp2, px)
        apy = jnp.where(sy, py_ - scale_exp2, py_)
        apz = jnp.where(sz, pz - scale_exp2, pz)
        t_min = jnp.where(adv, tc_max, t_min)
        idx = jnp.where(adv, idx ^ step_mask, idx)

        # --- POP (svotrace.comp:347-368) ---
        pop = adv & ((idx & step_mask) != 0)
        zero_u = jnp.zeros_like(_bits(apx))
        differing = jnp.where(sx, _bits(apx) ^ _bits(apx + scale_exp2), zero_u)
        differing |= jnp.where(sy, _bits(apy) ^ _bits(apy + scale_exp2), zero_u)
        differing |= jnp.where(sz, _bits(apz) ^ _bits(apz + scale_exp2), zero_u)
        new_scale = _find_msb(differing)
        new_exp2 = _float(((new_scale - MAX_SCALE + 127).astype(jnp.uint32)
                           << 23))
        safe_scale = jnp.clip(new_scale, 0, MAX_SCALE)
        at_pop = scale_iota == safe_scale[None]
        pop_parent = jnp.sum(jnp.where(at_pop, stack_node, 0), axis=0)
        # unstored slots hold (node 0, word 0); node 0's true word is the
        # root's, so substitute it — matches the old packed[0] fetch exactly
        pop_word = jnp.sum(jnp.where(at_pop, stack_word, 0), axis=0)
        pop_word = jnp.where(pop_parent == 0, root_word, pop_word)

        su = safe_scale.astype(jnp.uint32)
        shx = _bits(apx) >> su
        shy = _bits(apy) >> su
        shz = _bits(apz) >> su
        pop_px = _float(shx << su)
        pop_py = _float(shy << su)
        pop_pz = _float(shz << su)
        pop_idx = ((shx & 1) | ((shy & 1) << 1) | ((shz & 1) << 2)).astype(i32)

        scale = jnp.where(pop, new_scale, scale)
        scale_exp2 = jnp.where(pop, new_exp2, scale_exp2)
        parent = jnp.where(pop, pop_parent, parent)
        parent_word = jnp.where(pop, pop_word, parent_word)
        # The stack entry at scale s holds the cube at scale s+1 (the parent
        # above the popped cell, svotrace.comp:316-317); the stored t_max
        # always equals that parent cube's exit t, recomputable bit-exactly
        # from pos truncated to scale+1 mantissa bits.
        up = (safe_scale + 1).astype(jnp.uint32)
        par_px = _float((_bits(apx) >> up) << up)
        par_py = _float((_bits(apy) >> up) << up)
        par_pz = _float((_bits(apz) >> up) << up)
        pop_tmax = jnp.minimum(jnp.minimum(par_px * cx - bx, par_py * cy - by),
                               par_pz * cz - bz)
        t_max = jnp.where(pop, pop_tmax, t_max)
        px = jnp.where(pop, pop_px, apx)
        py_ = jnp.where(pop, pop_py, apy)
        pz = jnp.where(pop, pop_pz, apz)
        idx = jnp.where(pop, pop_idx, idx)
        hh = jnp.where(pop, f32(0.0), hh)

        done = (s["done"] | leaf_break | depth_break
                | (act & (scale >= MAX_SCALE)))

        return dict(t_min=t_min, t_max=t_max, h=hh, idx=idx, px=px, py=py_,
                    pz=pz, parent=parent, parent_word=parent_word,
                    scale=scale, scale_exp2=scale_exp2,
                    max_depth=max_depth_v, stack_node=stack_node,
                    stack_word=stack_word, done=done, iters=iters)

    return step


def _decode(sf, tree_arrays, o, d):
    """Hit decode (svotrace.comp:380-431) over FLAT (B,) state+const fields."""
    child_t, mask_t, value_t, normal_t = tree_arrays
    t_min, t_max = sf["t_min"], sf["t_max"]
    idx = sf["idx"]
    scale, scale_exp2 = sf["scale"], sf["scale_exp2"]
    parent = sf["parent"]
    iters = sf["iters"]
    done = sf["done"]
    octant1 = sf["octant"]
    px1, py1, pz1 = sf["px"], sf["py"], sf["pz"]
    dead1 = sf["dead0"]

    # un-mirroring tests use the EPS-clamped direction (dir.x > 0 on the
    # clamped dir, svotrace.comp:414-416)
    dxo, dyo, dzo = sf["dx"], sf["dy"], sf["dz"]
    child_shift = idx ^ octant1
    ci = child_t[parent] + child_shift
    tag = (mask_t[parent] >> (2 * child_shift)) & 3
    cvalue = value_t[ci]

    # effective raw normal field (tag-dependent; see octree.effective_normal_raw)
    raw = jnp.where(tag == C.TAG_SURFACE_LEAF, normal_t[ci],
                    jnp.where(tag == C.TAG_NON_SURFACE_LEAF, i32(0),
                              mask_t[ci]))
    nx = ((raw % 10) - 5).astype(f32)
    ny = (((raw % 100) - (raw % 10)) // 10 - 5).astype(f32)
    nz = ((raw - (raw % 100)) // 100 - 5).astype(f32)
    nlen = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    has_normal = raw != 0
    nx = jnp.where(has_normal, nx / nlen, f32(0.0))
    ny = jnp.where(has_normal, ny / nlen, f32(0.0))
    nz = jnp.where(has_normal, nz / nlen, f32(0.0))
    normal = jnp.stack([nx, ny, nz], axis=-1)

    # Rays still active at the per-ray cap are misses, matching the early
    # `return false` at svotrace.comp:264-266; pre-retired rays too.
    hit = done & (scale < MAX_SCALE) & (t_min <= t_max) & ~dead1
    hit_pos = o + t_min[:, None] * d + normal * (scale_exp2 * 2)[:, None]

    vx = jnp.where(dxo > 0, f32(3.0) - px1 - scale_exp2, px1)
    vy = jnp.where(dyo > 0, f32(3.0) - py1 - scale_exp2, py1)
    vz = jnp.where(dzo > 0, f32(3.0) - pz1 - scale_exp2, pz1)
    voxel_pos = (jnp.stack([vx, vy, vz], axis=-1)
                 + normal * (scale_exp2 * 2 * f32(1.74))[:, None])

    return HitResult(
        hit=hit, value=jnp.where(hit, cvalue, 0), t=t_min, iters=iters,
        scale_exp2=scale_exp2, depth=(MAX_SCALE - scale), normal=normal,
        hit_pos=hit_pos, voxel_pos=voxel_pos,
        node=jnp.where(hit, ci, -1),
    )


@functools.partial(jax.jit,
                   static_argnames=("max_iterations", "stack_depth",
                                    "inner_steps"))
def intersect_octree(tree_arrays, origin, direction, max_depth=C.MAX_DEPTH,
                     cone_trace=False, max_iterations=C.MAX_RAYCAST_ITERATIONS,
                     active=None, stack_depth=C.MAX_DEPTH, packed=None,
                     inner_steps=None):
    """Trace a batch of rays.  origin/direction: (B, 3) float32.

    ``tree_arrays`` is the (child, mask, value, normal) tuple of int32 device
    arrays from :meth:`Octree.arrays`.  Returns a :class:`HitResult` of (B,)
    arrays.  ``max_depth``/``cone_trace`` may be python or traced scalars;
    ``max_depth`` must not exceed the static ``stack_depth``.

    ``active`` (optional bool (B,)): rays marked inactive are never stepped
    and report a miss — the "dead rays culled" strategy (benchmarks.md:5-6).
    ``packed`` (optional): precomputed :func:`make_packed_table` output.
    """
    if isinstance(max_depth, int) and max_depth > stack_depth:
        raise ValueError(f"max_depth={max_depth} exceeds the static "
                         f"stack_depth={stack_depth} stack window")
    if packed is None:
        packed = make_packed_table(tree_arrays)

    state, const, cone, B = _setup(origin, direction, max_depth, cone_trace,
                                   active, stack_depth)
    state["parent_word"] = jnp.broadcast_to(
        packed[0], state["parent"].shape).astype(i32)
    max_it = i32(max_iterations)
    step = _make_step(const, packed, max_it, cone, stack_depth)

    if inner_steps is None:
        # fused multi-step inner bodies mean fewer outer materialization
        # points on an accelerator; on CPU the masked over-stepping loses
        inner_steps = INNER_STEPS if jax.default_backend() != "cpu" else 1

    def cond_fn(s):
        return jnp.any(~s["done"] & (s["iters"] < max_it))

    def body_fn(s):
        for _ in range(inner_steps):
            s = step(s)
        return s

    s = jax.lax.while_loop(cond_fn, body_fn, state)

    def unshape(a):
        return a.reshape(-1)[:B]

    sf = {k: unshape(s[k]) for k in _DECODE_STATE}
    for k in _DECODE_CONST:
        sf[k] = unshape(const[k])
    return _decode(sf, tree_arrays, origin.astype(f32), direction.astype(f32))


#: state fields the decode needs (everything else is traversal scratch)
_DECODE_STATE = ("t_min", "t_max", "idx", "px", "py", "pz", "parent",
                 "scale", "scale_exp2", "iters", "done")
_DECODE_CONST = ("octant", "dead0", "dx", "dy", "dz")


@functools.partial(jax.jit, static_argnames=("stack_depth",))
def _setup_jit(origin, direction, max_depth, cone_trace, active, stack_depth,
               packed):
    """One-program ray setup for host-driven drivers (~30 eager dispatches
    otherwise).  Note the standalone
    program's FMA contraction differs by ulps from the setup fused inside
    :func:`intersect_octree`'s single program — integer step counts are
    chaotic under that, so cross-path comparisons are statistical only."""
    state, const, _, _ = _setup(origin, direction, max_depth, cone_trace,
                                active, stack_depth)
    state["parent_word"] = jnp.broadcast_to(
        packed[0], state["parent"].shape).astype(i32)
    return state, const


_decode_jit = jax.jit(_decode)


@functools.partial(jax.jit, static_argnames=("steps", "max_iterations",
                                             "stack_depth", "inner_steps"))
def _run_block(state, const, packed, cone, steps, max_iterations,
               stack_depth, inner_steps=INNER_STEPS):
    """Advance every ray ``steps`` traversal steps (no convergence check);
    returns the new state and the number of still-active rays (one scalar —
    the only device->host traffic of the staged driver's loop)."""
    max_it = i32(max_iterations)
    step = _make_step(const, packed, max_it, cone, stack_depth)

    def body(_, s):
        for _ in range(inner_steps):
            s = step(s)
        return s

    s = jax.lax.fori_loop(0, steps // inner_steps, body, state)
    n_active = jnp.sum((~s["done"] & (s["iters"] < max_it)).astype(i32))
    return s, n_active


@functools.partial(jax.jit, static_argnames=("out_rows",))
def _compact(state, const, perm, acc, out_rows):
    """Retire finished rays and densify the survivors to ``out_rows``*128
    lanes: final state of every current ray is scattered into the full-size
    accumulator at its original slot, then still-active rays are gathered to
    the front (stable argsort keeps ray order deterministic)."""
    R, L = state["t_min"].shape

    def flat(a):
        return a.reshape(-1) if a.ndim == 2 else a.reshape(a.shape[0], -1)

    for k in _DECODE_STATE:
        acc[k] = acc[k].at[perm].set(flat(state[k]))

    # iteration-cap retirement is enforced by the driver's step budget;
    # here "active" is simply not-done
    active = flat(~state["done"])
    order = jnp.argsort(jnp.where(active, i32(0), i32(1)), stable=True)
    sel = order[: out_rows * LANES]

    new_state = {}
    for k, v in state.items():
        fv = flat(v)
        new_state[k] = (fv[sel].reshape(out_rows, LANES) if v.ndim == 2
                        else fv[:, sel].reshape(v.shape[0], out_rows, LANES))
    new_const = {k: flat(v)[sel].reshape(out_rows, LANES)
                 for k, v in const.items()}
    return new_state, new_const, perm[sel], acc


def intersect_octree_staged(tree_arrays, origin, direction,
                            max_depth=C.MAX_DEPTH, cone_trace=False,
                            max_iterations=C.MAX_RAYCAST_ITERATIONS,
                            active=None, stack_depth=C.MAX_DEPTH, packed=None,
                            round_steps=128, min_rows=32,
                            inner_steps=INNER_STEPS, grow_rounds=False,
                            max_round_steps=512, pipeline=False):
    """Host-driven traversal with ray compaction between rounds.

    The lock-step batch kernel pays max(iters) x batch: every lane executes
    until the *slowest* ray in the whole batch finishes (cap 1500,
    svotrace.comp:41), so a handful of grazing rays can cost 10-20x the
    median.  The reference never faces this — GL warps retire independently
    (SURVEY.md §2.2 row 1).  The fix here: run ``round_steps`` fused steps,
    read back ONE scalar (active-ray count), and when the survivor count has
    dropped below half the current batch, argsort-compact the survivors into
    a power-of-two-row batch and continue.  Total work approaches
    sum(per-ray iters) instead of batch * max(iters).

    Not jittable (host loop); use from frame drivers (bench, viewer).
    Compaction never changes a ray's own step sequence — it only regroups
    which lanes step together — so results are independent of round_steps /
    min_rows / grow_rounds / pipeline.  vs :func:`intersect_octree` the
    results agree to FP program variance: the fully-jitted kernel fuses ray
    setup into one program whose FMA contraction differs by ulps, which flips
    integer step counts on grazing rays (hits/colors are robust; see tests
    for the contract).

    Readback-latency design (each round reads one scalar back to the host):

    * ``grow_rounds`` doubles the round length each round (capped at
      ``max_round_steps``), so a full 1500-step traversal costs O(log)
      syncs instead of 1500/round_steps.
    * ``pipeline`` dispatches the NEXT block before reading the previous
      block's active-count scalar, overlapping the host round-trip with
      device compute.  The stale count is an upper bound on the current
      survivor count (actives only retire), so sizing the compaction from
      it can never drop a live ray.
    """
    if packed is None:
        packed = make_packed_table(tree_arrays)

    B = origin.shape[0]
    cone = jnp.asarray(cone_trace, bool)
    state, const = _setup_jit(origin, direction, max_depth, cone_trace,
                              active, stack_depth, packed)
    const_full = const  # full-size; compaction shrinks the working copy
    R = state["t_min"].shape[0]

    acc = {k: jnp.zeros(R * LANES, state[k].dtype) for k in _DECODE_STATE}
    perm = jnp.arange(R * LANES, dtype=i32)

    def block(s, steps):
        steps = -(-steps // inner_steps) * inner_steps
        s, n_active = _run_block(s, const, packed, cone, steps,
                                 max_iterations, stack_depth,
                                 inner_steps=inner_steps)
        return s, n_active, steps

    cur_steps = min(round_steps, max_iterations)
    state, n_dev, took = block(state, cur_steps)
    spent = took
    while spent < max_iterations:
        if grow_rounds:
            cur_steps = min(cur_steps * 2, max_round_steps)
        # never truncate the last round: the per-ray iters < max_iterations
        # mask inside _run_block enforces the exact cap, and reusing the same
        # static `steps` avoids compiling a one-off odd-sized program
        steps = cur_steps
        if pipeline:
            # dispatch the next block, THEN read the previous block's count:
            # the d2h round-trip rides on top of the block's execution
            state2, n2_dev, took = block(state, steps)
            n = int(n_dev)  # stale by one block — upper bound on survivors
            if n == 0:
                state = state2  # the speculative block was a masked no-op
                break
            state, n_dev = state2, n2_dev
            spent += took
        else:
            n = int(n_dev)
            if n == 0:
                break
            state, n_dev, took = block(state, steps)
            spent += took
        rows_needed = max(min_rows, 1 << (-(-n // LANES) - 1).bit_length())
        if rows_needed < state["t_min"].shape[0] and spent < max_iterations:
            state, const, perm, acc = _compact(state, const, perm, acc,
                                               out_rows=rows_needed)

    for k in _DECODE_STATE:
        acc[k] = acc[k].at[perm].set(state[k].reshape(-1))

    # const fields are pure functions of (origin, direction) — the initial
    # full-size setup already holds them at every ray's original slot
    sf = {k: acc[k][:B] for k in _DECODE_STATE}
    for k in _DECODE_CONST:
        sf[k] = const_full[k].reshape(-1)[:B]
    return _decode_jit(sf, tree_arrays, origin.astype(f32),
                       direction.astype(f32))
