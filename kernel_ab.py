#!/usr/bin/env python3
"""A/B of the flash forward kernel's batch and depth, and of the redesigned
kernels against a parent's sources, on one CUDA card.

  * flash kernel (a): ``pytorch_geometric_tpu_torch/csrc/flash_softmax.cu``
    copied under ``_archive/ab/`` with its forward instanced at every
    (gathered row floats a batch, batches in flight) of {8, 16, 32} x {1,
    2} for the 16-byte layouts these shapes take (the library the package
    builds holds only the wrappers' choice), timed at path K's two layers
    (``chip_smoke.products_graph`` with a self loop per node; layer 2's C =
    47 padded to 48 as the flash route pads it), path L's layer 1 (GATv2, H
    = 4, C = 64, path C's graph with self loops) and path M's (the dot form,
    path C's graph), each output within 1e-5 of max(1, max |out|) of the
    package's kernel;
  * with ``--parent DIR`` (a directory holding a parent's
    ``flash_softmax.cu``, ``sddmm.cu`` and ``vec.cuh``, e.g. from ``git
    show``): the parent's kernel (a) at the same shapes (at layer 2 on the
    unpadded C = 47, as it ran) and its per-edge dot kernel at its own slice
    rule, beside the package's (as its wrapper chooses, path D saying its
    destinations come in runs as its grad_p_u does, so taking the runs arm;
    the other arm; and the tree arm at every slice shape it takes), at path
    I's shapes (edge order, H*F = 256 and 40, both dtypes at 256) and path
    D's (slot order). Parent and change in turns: parent, change, change,
    parent.

Device time per launch from ``torch.profiler`` over whole windows
(``chip_smoke.whole_window``), summed over the kernel's own launches. Prints
the card's name and power limit first, then every reading; ``--out FILE``
also writes them as JSON.

Usage: ``python3 kernel_ab.py [--seed 0] [--parent DIR] [--only flash|dot]
[--out FILE]`` from the root of a checkout, on a machine with one CUDA card
and ``nvcc``.
"""

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
AB_DIR = ROOT / '_archive' / 'ab'
# kernel (a)'s variants: gathered row floats a batch, batches in flight
FWD_VARIANTS = tuple((f, p) for f in (8, 16, 32) for p in (1, 2))
# the A/B copy's launch_batch: kernel (a) only, at every variant, for the
# 16-byte layouts of one slot a head per lane (K, L and M take no other)
AB_LAUNCH_BATCH = '''template <int FORM, int W, int NH, int PER>
cudaError_t launch_batch(int pass, const FlashArgs& a, cudaStream_t st) {
  constexpr int F = NH * PER * W;
  if constexpr (W == 4 && PER == 1 && NH <= 2) {
    if (pass != kFwd) return cudaErrorInvalidValue;
#define PGT_AB(FL, P)                                                     \\
  if (a.unroll == edges_a_batch(FL, F) && a.depth == P)                   \\
    return launch_pass<kFwd, FORM, W, NH, PER, edges_a_batch(FL, F), P>(a, \\
                                                                        st);
    PGT_AB(8, 1) PGT_AB(8, 2) PGT_AB(16, 1) PGT_AB(16, 2) PGT_AB(32, 1)
    PGT_AB(32, 2)
#undef PGT_AB
  }
  return cudaErrorInvalidValue;
}
'''


def log(*a):
    print(*a, flush=True)


def ab_source(src: str) -> str:
    """The flash source with ``launch_batch`` replaced by the A/B's."""
    pat = re.compile(r'template <int FORM, int W, int NH, int PER>\n'
                     r'cudaError_t launch_batch\(.*?\n}\n', re.S)
    out, n = pat.subn(lambda _: AB_LAUNCH_BATCH, src)
    if n != 1:
        raise RuntimeError('kernel_ab: launch_batch not found in the flash '
                           'source')
    return out


def build(jobs):
    """``{name: (source, library)}``, one nvcc each, all at once, with the
    package's flags."""
    from pytorch_geometric_tpu_torch import csrc
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [csrc.nvcc_path(), *csrc.NVCC_FLAGS, '-o', str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, lib) in jobs.items()}
    for name, p in procs.items():
        text = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f'kernel_ab: build of {name} failed:\n'
                               f'{text[-4000:]}')
        regs = [int(r) for r in re.findall(r'Used (\d+) registers', text)]
        spills = len(re.findall(r'[1-9]\d* bytes spill stores', text))
        log(f'[build] {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} '
            f'registers, {spills} spill')
        if len(regs) <= 32:
            for fn, r in re.findall(r'Function properties for (\S+)\n.*?'
                                    r'Used (\d+) registers', text, re.S):
                log(f'[build]   {name} {fn[:60]}: {r} registers')
    log(f'[build] {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s')
    return {name: ctypes.CDLL(str(lib)) for name, (_, lib) in jobs.items()}


def entry(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def kernel_ms(torch, fn, part, calls):
    """Device ms per call of the kernels whose name holds ``part``."""
    import chip_smoke as cs
    rows, _, _ = cs.whole_window(torch, fn, calls)
    return sum(t for name, t, _ in rows if part in name)


def fwd_call(torch, fn, ops, plan, shape, lanes=None):
    """One launch of a kernel (a) entry point ``fn`` over ``plan``; the
    output. ``lanes`` overrides the team's lanes (a parent's kernel (a)
    takes one team of ``team_lanes(c)`` lanes per (row, head))."""
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    h, c = ops.heads, ops.columns
    kw = dict(dtype=torch.float32, device='cuda')
    out = torch.empty((plan.n_rows, h * c), **kw)
    m = torch.empty((plan.n_rows, h), **kw)
    l = torch.empty((plan.n_rows, h), **kw)
    (ps, ps2, pv), tickets = fs._scratch(plan, h, h * c, out, 1)
    args = fs._args(ops, plan, shape, m=m, l=l, out=out, tickets=tickets,
                    part_s=ps, part_s2=ps2, part_v=pv)
    if lanes is not None:
        args.g_lanes = lanes
    err = fn(ctypes.addressof(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'kernel_ab: flash forward launch failed: {err}')
    return out


def flash_shapes(torch, seed):
    """``(label, ops, unpadded ops or None, s, d, rel, n_dst)`` at K's two
    layers, L's layer 1 and M's layer 1, random tables from ``seed``."""
    import chip_smoke as cs
    from pytorch_geometric_tpu_torch.ops import edge_attention as ea
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    g = torch.Generator(device='cuda').manual_seed(seed + 11)
    n = cs.N_PRODUCTS
    coo = cs.products_graph(n, cs.E_PRODUCTS, seed)
    loops = np.arange(n, dtype=np.int32)
    ks = torch.as_tensor(np.concatenate([coo[0], loops]), device='cuda')
    kd = torch.as_tensor(np.concatenate([coo[1], loops]), device='cuda')
    del coo
    rng = np.random.default_rng(seed)
    npc = cs.PC_NODES
    pc = rng.integers(0, npc, (2, cs.PC_EDGES)).astype(np.int32)
    lp = np.arange(npc, dtype=np.int32)
    keep = pc[0] != pc[1]
    ls = torch.as_tensor(np.concatenate([pc[0][keep], lp]), device='cuda')
    ld = torch.as_tensor(np.concatenate([pc[1][keep], lp]), device='cuda')
    ms, md = (torch.as_tensor(pc[0], device='cuda'),
              torch.as_tensor(pc[1], device='cuda'))
    hc = cs.PC_HIDDEN // cs.PC_HEADS
    for label, form, h, c, s, d, nn in (
            ('K layer 1', 'gat', 4, 16, ks, kd, n),
            ('K layer 2', 'gat', 1, cs.PR_CLASSES, ks, kd, n),
            ('L layer 1', 'gatv2', cs.PC_HEADS, hc, ls, ld, npc),
            ('M layer 1', 'dot', cs.PC_HEADS, hc, ms, md, npc)):
        sw = h if form == 'gat' else h * c
        src = torch.randn(nn, sw, device='cuda', generator=g)
        dst = torch.randn(nn, sw, device='cuda', generator=g)
        val = (src if form == 'gatv2' else
               torch.randn(nn, h * c, device='cuda', generator=g))
        extra = rel = None
        if form == 'gatv2':
            extra = torch.randn(h * c, device='cuda', generator=g) / \
                math.sqrt(c)
        if form == 'dot':
            extra = torch.full((1, h), 1 / math.sqrt(c), device='cuda')
            rel = torch.zeros(s.shape[0], dtype=torch.int64, device='cuda')
        ops = fs.FlashOperands(form, h, src, dst, val, extra, 0.2)
        cp = -(-c // ea.ALIGN_COLUMNS) * ea.ALIGN_COLUMNS
        padded = ops
        if cp != c:
            padded = ops._replace(val=ea._pad_heads(val, h, c, cp))
        yield (label, padded, ops if cp != c else None, s.long(), d.long(),
               rel, nn)


def flash_ab(torch, libs, seed, parent):
    from pytorch_geometric_tpu_torch.ops import flash_softmax as fs
    vp = [ctypes.c_void_p, ctypes.c_void_p]
    ab = entry(libs['ab'], 'pgt_flash_fwd', vp)
    shipped = fs._kernel('pgt_flash_fwd')
    old = entry(libs['parent_flash'], 'pgt_flash_fwd', vp) if parent else None
    rows = []
    for label, ops, unpadded, s, d, rel, nd in flash_shapes(torch, seed):
        plan = fs.dst_plan(s, d, rel, nd, False)
        h, c = ops.heads, ops.columns
        chosen = fs.kernel_shape(ops, 'fwd', torch.empty(
            (1, h * c), device='cuda'))
        ref = fwd_call(torch, shipped, ops, plan, chosen)
        lim = 1e-5 * max(1.0, float(ref.abs().max()))
        row = {'shape': label, 'form': ops.form, 'H': h, 'C': c,
               'edges': int(s.shape[0]), 'chosen': chosen._asdict(),
               'ms': {}}
        turns = []
        if old is not None:
            base = unpadded or ops
            lanes = min(fs._pow2(base.columns), 32)
            turns.append(('parent', lambda: fwd_call(
                torch, old, base, plan, chosen, lanes)))
        for floats, depth in FWD_VARIANTS:
            shape = chosen._replace(unroll=min(16, max(
                1, floats // (chosen.nv * chosen.vec))), depth=depth)
            out = fwd_call(torch, ab, ops, plan, shape)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if not err <= lim:
                raise AssertionError(f'kernel_ab: {label} variant {floats}, '
                                     f'{depth}: {err} from the package\'s '
                                     f'kernel (limit {lim})')
            turns.append((f'{floats} floats, depth {depth}',
                          lambda shape=shape: fwd_call(torch, ab, ops, plan,
                                                       shape)))
        turns.append(('package', lambda: fwd_call(torch, shipped, ops, plan,
                                                  chosen)))
        order = turns + turns[::-1]
        for name, fn in order:
            ms = kernel_ms(torch, fn, 'flash_fwd_kernel', 5)
            row['ms'].setdefault(name, []).append(ms)
        for name, ts in row['ms'].items():
            log(f'[ab] flash (a) {label} ({ops.form} H={h} C={c}): {name}: '
                + ' / '.join(f'{t:.4f}' for t in ts) + ' ms')
        rows.append(row)
        del plan, ref
        torch.cuda.empty_cache()
    return rows


def dot_ab(torch, libs, seed, parent):
    import chip_smoke as cs
    from pytorch_geometric_tpu_torch.ops.edge_dot import (dot_slice_widths,
                                                          dot_vec, edge_dot,
                                                          runs_arm)
    from pytorch_geometric_tpu_torch.ops.gather import MIX_L2_SHARE
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    old = {arm: entry(libs['parent_dot'], f'pgt_edge_dot_{arm}',
                      [vp] * 6 + [ll] * 5 + [i] * 5 + [vp])
           for arm in ('f32', 'bf16')}
    # variants of the package's source: the package's interface
    variants = {name[4:]: {arm: entry(lib, f'pgt_edge_dot_{arm}',
                                      [vp] * 7 + [ll] * 5 + [i] * 7 + [vp])
                           for arm in ('f32', 'bf16')}
                for name, lib in libs.items() if name.startswith('dot ')}
    pc = cs.build_path_c(torch, seed)
    ei, n = pc['ei'], cs.PC_NODES
    blk = ei.blocked
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    g = torch.Generator('cuda').manual_seed(seed + 8)
    rows = []

    def parent_call(a, b, ia, ib):
        h, f = a.shape[1:]
        fit = [k for k in range(1, h + 1) if h % k == 0 and max(
            a.shape[0], b.shape[0]) * k * f * a.element_size()
            <= MIX_L2_SHARE * l2]
        hs = max(fit) if fit else 1
        out = torch.empty((ia.shape[0], h), dtype=a.dtype, device='cuda')
        err = old['bf16' if a.dtype == torch.bfloat16 else 'f32'](
            a.data_ptr(), b.data_ptr(), ia.data_ptr(), ib.data_ptr(), None,
            out.data_ptr(), ia.shape[0], a.shape[0], b.shape[0],
            a.stride(0), b.stride(0), h, f, hs,
            int(ia.dtype == torch.int64), int(ib.dtype == torch.int64),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f'kernel_ab: parent dot launch failed: {err}')
        return out

    def variant_call(fns, a, b, ia, ib, vec, hs, cs):
        h, f = a.shape[1:]
        e = ia.shape[0]
        p = 1 << (f // vec - 1).bit_length()
        leaves = p // cs
        ncs = -(-(f // vec) // leaves)
        out = torch.empty((e, h), dtype=a.dtype, device='cuda')
        part = (torch.empty((ncs, e, h), device='cuda') if ncs > 1
                else None)
        err = fns['bf16' if a.dtype == torch.bfloat16 else 'f32'](
            a.data_ptr(), b.data_ptr(), ia.data_ptr(), ib.data_ptr(), None,
            out.data_ptr(), None if part is None else part.data_ptr(), e,
            a.shape[0], b.shape[0], a.stride(0), b.stride(0), h, f, vec, hs,
            leaves, int(ia.dtype == torch.int64),
            int(ib.dtype == torch.int64),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f'kernel_ab: dot variant launch failed: {err}')
        return out

    with torch.inference_mode():
        for path, order, ia, ib in (('I', 'edge', ei.coo[0], ei.coo[1]),
                                    ('D', 'slot', blk.src, blk.dst)):
            for f, dt in ((cs.PC_HIDDEN // cs.PC_HEADS, torch.float32),
                          (cs.PC_CLASSES, torch.float32),
                          (cs.PC_HIDDEN // cs.PC_HEADS, torch.bfloat16)):
                h = cs.PC_HEADS
                a = torch.randn(n, h, f, device='cuda', generator=g).to(dt)
                b = torch.randn(n, h, f, device='cuda', generator=g).to(dt)
                ref = parent_call(a, b, ia, ib)
                named = True if path == 'D' else None
                runs = runs_arm(f, named)
                new = edge_dot(a, b, ia, ib, runs=named)
                torch.cuda.synchronize()
                lim = (1e-5 if dt == torch.float32 else 1e-2) * float(
                    ref.float().abs().max())
                err = float((new.float() - ref.float()).abs().max())
                if not err <= lim:
                    raise AssertionError(f'kernel_ab: dot path {path} F={f} '
                                         f'{dt}: {err} from the parent')
                vec = dot_vec(a, b, f, h * f, h * f)
                turns = [('parent', lambda: parent_call(a, b, ia, ib)),
                         ('package', lambda: edge_dot(a, b, ia, ib,
                                                      runs=named)),
                         (f"package, the {'tree' if runs else 'runs'} arm",
                          lambda: edge_dot(a, b, ia, ib, runs=not runs))]
                # the tree arm at every slice shape
                widths = dot_slice_widths(h, f, vec)
                turns += [(f'package, {hs} heads in {cs} column slices',
                           lambda hs=hs, cs=cs: edge_dot(
                               a, b, ia, ib, slice_heads=hs, col_slices=cs,
                               runs=False))
                          for hs, cs in widths]
                for name, fns in variants.items():
                    first = None
                    for hs, ncol in dot_slice_widths(h, f, vec)[:5]:
                        got = variant_call(fns, a, b, ia, ib, vec, hs, ncol)
                        torch.cuda.synchronize()
                        first = got if first is None else first
                        if not torch.equal(got, first):
                            raise AssertionError(f'kernel_ab: variant {name} '
                                                 'changes the bits with its '
                                                 'slices')
                        turns.append((f'{name}, {hs} heads in {ncol} column '
                                      'slices', lambda fns=fns, hs=hs,
                                      ncol=ncol: variant_call(
                                          fns, a, b, ia, ib, vec, hs, ncol)))
                row = {'path': path, 'order': order, 'F': f, 'H': h,
                       'dtype': str(dt).split('.')[-1], 'ms': {}}
                for name, fn in turns + turns[::-1]:
                    row['ms'].setdefault(name, []).append(
                        kernel_ms(torch, fn, 'edge_dot', 10))
                for name, ts in row['ms'].items():
                    log(f"[ab] edge_dot path {path} ({order} order) H*F="
                        f"{h * f} {row['dtype']}: {name}: "
                        + ' / '.join(f'{t:.4f}' for t in ts) + ' ms')
                rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--parent', type=Path, default=None)
    ap.add_argument('--only', choices=('flash', 'dot'), default=None)
    ap.add_argument('--out', type=Path, default=None)
    ap.add_argument('--dot-variant', action='append', default=[],
                    metavar='NAME=PATH',
                    help='a copy of csrc/sddmm.cu (with vec.cuh beside it) '
                         'to time beside the package\'s dot kernel at each '
                         'shape and slice shape')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        log('kernel_ab: no CUDA card is visible')
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from pytorch_geometric_tpu_torch import csrc
    cs.phase_device(torch)
    csrc.build_all(['flash_softmax', 'sddmm'])
    AB_DIR.mkdir(parents=True, exist_ok=True)
    src = (csrc.SOURCE_DIR / 'flash_softmax.cu').read_text()
    (AB_DIR / 'flash_ab.cu').write_text(ab_source(src))
    jobs = {}
    if args.only != 'dot':
        jobs['ab'] = (AB_DIR / 'flash_ab.cu', AB_DIR / 'libflash_ab.so')
    if args.parent is not None:
        par = AB_DIR / 'parent'
        par.mkdir(exist_ok=True)
        for name in ('flash_softmax.cu', 'sddmm.cu', 'vec.cuh'):
            shutil.copy(args.parent / name, par / name)
        if args.only != 'dot':
            jobs['parent_flash'] = (par / 'flash_softmax.cu',
                                    par / 'libflash_parent.so')
        if args.only != 'flash':
            jobs['parent_dot'] = (par / 'sddmm.cu',
                                  par / 'libsddmm_parent.so')
    for spec in args.dot_variant:
        name, path = spec.split('=', 1)
        jobs[f'dot {name}'] = (Path(path), AB_DIR / f'libsddmm_{name}.so')
    libs = build(jobs)
    res = {'device': torch.cuda.get_device_name(0)}
    if args.only != 'dot':
        res['flash_fwd'] = flash_ab(torch, libs, args.seed,
                                    args.parent is not None)
        torch.cuda.empty_cache()
    if args.parent is not None and args.only != 'flash':
        res['edge_dot'] = dot_ab(torch, libs, args.seed, True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    log(json.dumps({'kernel_ab': 'done', 'device': res['device']}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
