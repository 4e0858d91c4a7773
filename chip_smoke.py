#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_pbrt_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. build  — compile every CUDA kernel from tpu_pbrt_torch/csrc/ (nvcc,
     sm_90a, all sources in parallel) and print the build seconds and
     the ptxas register / shared-memory report;
  2. check  — run each kernel against its plain PyTorch version on the
     card, on inputs captured from two real traversals of the killeroo
     scene: the persistent pool's 2^19-ray fused camera+shadow wave (the
     main path's shape: wave 1 of the middle chunk, the first wave whose
     shadow half carries rays with a finite t_max; flush F=16; expand at
     S=2^17 with 10 entry-distance key bits, closest-hit), and the fixed
     batch's first 2^20-ray camera wave
     (flush F=16; expand in closest-hit and any-hit mode); a synthetic
     F=64 (motion feature) flush on that wave's chunk with random ray
     times (its plain version's and torch.bmm's times beside it, under
     "synthetic_f64"), and the seeded exact-tie flush chunk of
     kernels/fixtures.py at L=512 (prim must match exactly); print each
     kernel's device time per call (torch.profiler, summed over its
     kernels), the wrapper's host time per call, the plain version's and
     the library call's device time, and the bound;
  3. render — the port's main path: make_killeroo_like() at its full
     mesh, 128x128, 256 spp, maxdepth 5, through compile_scene and
     PathIntegrator.render on the card, through the persistent pool
     (chunks of 2^20 work items, 2^18 slots); the kernel launch counters
     are zeroed just before and read just after; the image must be finite
     and within per-pixel MSE 1e-4 of refimg/killeroo_cpu_128x128_256spp.npz.
     Then the same render through the fixed batch (TORCH_PBRT_REGEN=0's
     path), its launches counted the same way, which must trace the same
     rays; and both paths at 64x64, 16 spp, whose images must agree
     within rtol 1e-4 / atol 1e-5 with equal rays;
     [analysis] the measuring analysis layers on that scene and result,
     rendering nothing new at full size: one pool chunk of one refill
     (the render's 2^18-slot pool) under torch.cuda.set_sync_debug_mode
     ("warn"), whose sync warnings must equal the stream tracer's tally
     of host reads (the traversal's plus the loop's: host_reads_per_wave
     + loop_host_reads_per_wave); the same chunk recorded
     (tpu_pbrt_torch/analysis/record.py), whose host syncs must equal the
     warnings, rolled up into the cuda FLOPs, bytes and ops per wave
     (analysis/cost.py); the audit's tiny pool chunk recorded on the card
     and gated against the committed cuda budget of
     tpu_pbrt_torch/analysis/budgets.json, printed beside the committed
     cpu entry; the [render] pool's live_vs_static_ratio and
     host_overlap_fraction with the card's name and power limit; and the
     bench line's telemetry block (tpu_pbrt_torch/bench.py
     telemetry_block); and hbmcheck (tpu_pbrt_torch/analysis/hbmcheck.py):
     its static pass and the card's capacity beside the committed table
     (its model against the allocator's peaks is checked in [serve]).
     Runs with [render] (asked for alone, it runs [render] first);
     [walkers] (in a full run a subprocess, `chip_smoke.py walkers`, beside
     [mesh]) the packet, wide and binary walkers
     (TORCH_PBRT_BVH=packet|wide|binary) on the full killeroo under
     `path`: each renders 32x32x4 on the card (chunks of 2^13), within
     the repo's MSE bar of the stream render of the same image with its
     rays beside, and 12x12x1 on the card against the CPU port (MSE below
     1e-8, rays equal); each prints its Mray/s and host reads per wave
     beside the stream render's;
  4. crown  — the crown-class path: make_crown_like() at its full
     geometry (1,153,682 triangles in 3,279 treelets under a 1,079-node
     top tree; glass, two metal-GGX pieces, a matte ground, the HDR sky
     as an infinite light) at 512x512:
     [scene] its sizes and compile seconds, and the 64x128 sky (not the
     constant fallback map);
     [check] both kernels against their plain versions on the pool's
     first wave with live shadow rays (2^19 rays: the packed flush key)
     and on the fixed batch's first 2^20-ray camera wave of the middle chunk
     (the unpacked 2-array sort), EXACT: t 0 ulp, no prim flip; the
     expand bit-exact in closest-hit and any-hit mode; times and bounds
     as in phase 2;
     [branch] that camera wave's rays traced as one 2^20-ray wave
     (unpacked key) and as two 2^19-ray waves (packed key): the same
     (t, prim) bits, no pair dropped;
     [render] the pool at 64x64, 64 spp, maxdepth 5 against the JAX
     package's CPU render tests/torch_golden/crown_cpu_64x64_64spp.npz
     (MSE bar 1e-4, finite, no pair dropped), the fixed batch at the same
     size (the same rays; images within rtol 1e-4 / atol 1e-5), and the
     512x512 crown at CROWN_SPP (4) through the pool, its kernel launches
     counted as in phase 3;
  5. direct — the direct-lighting family (fixed batch, shadow rays as
     any-hit waves):
     [direct] both kernels against their plain versions, exact, on the
     first any-hit shadow wave of the full killeroo's `directlighting`
     chunk at 128x128x64 (the expand step after the wave's first flush,
     where answered rays are culled, and the first flush chunk after it;
     the wave's first of each where no expand follows a flush), timed as
     in phase 2; that render's Mray/s, its launches and its any-hit
     waves' counters; `python -m tpu_pbrt_torch.main
     scenes/cornell-box.pbrt` in a subprocess on the card at the file's
     own 256x256x16 (brute feature intersector), its image against
     tests/torch_golden/cornell_direct_cpu_256x256_16spp.npz and its rays
     (from the checkpoint) against the reference's; the full killeroo
     under `directlighting` and `ao` (finite maxdistance) at 64x64x16
     against killeroo_{direct,ao}_cpu_64x64_16spp.npz (MSE bar 1e-4,
     rays printed beside the reference's, no pair dropped);
     [samplers] every sampler kind's draws on the card equal the CPU
     port's bit for bit on a 2^20-item grid (int and per-lane salts, and
     the Sobol' film jitter);
  6. cloud  — participating media and null interfaces: make_cloud_like()
     (the killeroo's 128,880-triangle displaced sphere as a `Material
     "none"` container of a homogeneous medium, the ground, the quad area
     and point lights and the HDR sky) under `volpath` (fixed batch,
     maxdepth 5 + 4 pass-through iterations, shadow rays walking up to 4
     closest-hit segments through the container):
     [scene] its sizes and compile seconds;
     [check] both kernels against their plain versions, EXACT, on the
     first shadow-walk segment wave of the 256x256x16 render's chunk
     (closest hit with a finite per-ray t_max: the expand step after the
     wave's first flush and the first flush chunk after it), timed as in
     phase 2;
     [render] 64x64x16 against the JAX CPU render
     tests/torch_golden/cloud_volpath_cpu_64x64_16spp.npz (MSE bar 1e-4,
     no pair dropped, rays printed beside the reference's); the card
     against the CPU port per pixel at 32x32x16, and at 16x16x16 with
     Russian roulette off (MSE bar 1e-4, rays printed); the 256x256x16
     render timed (Mray/s, waves, wave_modes),
     its kernel launches counted as in phase 3;
  7. caustic — the light-transport integrators on make_caustic_like()
     (the killeroo's 128,880-triangle displaced sphere in glass over its
     matte ground, lit by its quad area light and by a point light that
     the glass focuses onto the ground; maxdepth 5):
     [scene] its sizes and compile seconds;
     [check] both kernels against their plain versions, EXACT, on two
     captured waves, timed as in phase 2: BDPT's fused connection wave of
     the 256x256x16 chunk (every strategy's visibility ray, 20 x 2^20
     rays, any hit with a finite per-ray t_max: the expand step after its
     first flush and the first flush chunk after it) and SPPM's first
     photon wave (closest hit, 2^20 rays leaving the lights);
     [render] BDPT at 256x256x16, SPPM at 256x256 (2 iterations of 2^20
     photons) and MLT at 128x128 (65,536 chains) timed (Mray/s, waves,
     wave_modes), each with its kernel launches counted as in phase 3;
     BDPT and SPPM against the JAX CPU references of
     tests/torch_golden/make_caustic_reference.py (MSE bar 1e-4, no pair
     dropped, rays printed beside the reference's), MLT against its
     reference by the image mean (within 2%: one accept that flips
     reroutes a chain for good) with the MSE printed; BDPT and SPPM on
     the card against the CPU port at 16x16 (MSE bar 1e-4);
  8. breadth — scene breadth on make_breadth_like() at its full geometry
     (1,178,624 triangles: eight `ObjectInstance`s of a 128,880-triangle
     `plymesh` blob, a 257x257 `heightfield2` ground, a disk, cylinder,
     cone, paraboloid and hyperboloid, a level-4 `loopsubdiv` tetrahedron
     and 256 `curve` strands; a spot, a goniometric, a projection and an
     infinite light; `path` at maxdepth 5):
     [scene] its sizes and compile seconds;
     [check] both kernels against their plain versions, EXACT, on the
     512x512x8 (gaussian filter) render's pool wave 1 of its middle chunk
     (packed flush key) and its middle chunk's first fixed-batch 2^20-ray
     camera wave (unpacked key), timed as in phase 2;
     [render] that render through the pool and the fixed batch (the same
     rays; images within rtol 1e-4 / atol 1e-5), timed (Mray/s), its
     launches counted as in phase 3; the perspective camera under the
     gaussian and the realistic camera (the built-in doublet) under the
     mitchell filter at 64x64x16 against the JAX CPU references
     tests/torch_golden/breadth_{perspective,realistic}_cpu_64x64_16spp.npz
     (MSE bar 1e-4, no pair dropped, rays printed beside the
     reference's); the realistic camera's rays for every work item of
     that render on the card and on the CPU port (the vignetting masks
     equal); the orthographic camera under the triangle and the
     environment camera under the sinc filter on the card against the
     CPU port at 32x32x4 on the small tessellation (MSE below 1e-8, the
     same rays);
  9. textured — textures and the layered materials on make_textured_like()
     at its full geometry (1,166,214 triangles: eight `ObjectInstance`s
     of the 128,880-triangle blob in uber, translucent, mix, matte,
     plastic, substrate materials under every procedural texture kind, a
     257x257 `heightfield2` ground in substrate with a 2048^2 sRGB PNG
     albedo and a PFM-driven roughness, a uv-textured sphere and two PNG
     panels under wrap black and clamp; an atlas of 8,738,132 texels; the
     crown's sky and a quad area light; `path` at maxdepth 5):
     [scene] its sizes, textures, atlas and compile seconds;
     [check] both kernels against their plain versions, EXACT, on the
     512x512x4 render's pool wave with live shadow rays (packed flush
     key) and its middle chunk's first fixed-batch 2^20-ray camera wave
     (unpacked key), timed as in phase 2;
     [render] that render through the pool and the fixed batch (the same
     rays; images within rtol 1e-4 / atol 1e-5), timed (Mray/s, waves),
     its launches counted as in phase 3 (the texture evaluation's
     device share is `python -m tpu_pbrt_torch.profile_render --scene
     textured`'s, not this script's: a profiled chunk's trace takes
     minutes to read); 64x64x16 through
     the pool and the fixed batch against the JAX CPU reference
     tests/torch_golden/textured_path_cpu_64x64_16spp.npz (MSE bar 1e-4,
     no pair dropped, rays printed beside the reference's); the card
     against the CPU port at 32x32x4 on the small variant
     (TEXTURED_SMALL; MSE bar 1e-4, rays printed); `bdpt` (mix lanes
     resolved per vertex) at 32x32x16 against
     tests/torch_golden/textured_bdpt_cpu_32x32_16spp.npz (MSE bar 1e-4);
 10. motion — motion blur, disney and hair on make_motion_like() at its
     full geometry (1,042,004 triangles: 20,480 cubic-Bezier hair
     segments in three `curve` shapes under `Material "hair"`, one per way
     it resolves sigma_a, translating over the shutter; three
     `ObjectInstance`s of the 128,880-triangle blob in disney, one of them
     translating and one rotating; a disney ground, the crown's sky and a
     quad area light; `path` at maxdepth 5, shutter [0, 1]):
     [scene] its sizes, treelets, the F = 64 featT's bytes and compile
     seconds;
     [check] both kernels against their plain versions, EXACT, on the
     512x512x4 render's pool wave with live shadow rays (packed flush
     key, F = 64, each lane's own shutter time in rayF row 7) and its
     middle chunk's first fixed-batch 2^20-ray camera wave (unpacked key,
     the camera samples' times), timed as in phase 2 (the bound, the
     plain version and torch.bmm of the same 64-row contraction);
     [render] that render through the pool and the fixed batch (the same
     rays; images within rtol 1e-4 / atol 1e-5), timed (Mray/s, waves,
     the card's name and power limit), its launches counted as in phase 3
     (the F = 64 flush must launch); `path` 64x64x16 through the pool
     against tests/torch_golden/motion_path_cpu_64x64_16spp.npz (MSE
     bar 1e-4: the port rounds as the reference's compiled program, a
     product fused into the sum that consumes it, ROADMAP Queue 3 item
     12); `path` 64x64x64 through the pool and the fixed batch against
     motion_path_cpu_64x64_64spp.npz and `bdpt` (the shutter-start
     frame, disney and hair shaded through BDPT) at
     32x32x16 against motion_bdpt_cpu_32x32_16spp.npz (MSE bar 1e-4, no
     pair dropped, rays printed beside the reference's); the card
     against the CPU port at 32x32x4 on the small variant (MSE below
     1e-8);
 11. subsurface — the BSSRDF probe wave and the fourier material on
     make_subsurface_like() at its full geometry (1,126,884 triangles: the
     displaced-sphere blob at the crown's tessellation in `subsurface`
     (the Skin2 preset at scale 500), a 128,880-triangle blob instance in
     `kdsubsurface`, a ground in `fourier` (a 3-channel table written at
     build time), the crown's sky and a quad area light; `path` at
     maxdepth 5):
     [scene] its sizes, material types, BSSRDF radii and compile seconds;
     [check] both kernels against their plain versions, EXACT, on the
     512x512x8 render's first probe-chord wave (the first chord of its
     middle chunk's first probe through the pool: closest hit, each
     chord's short t_max, most chords missing), timed as in phase 2;
     [render] that render through the pool and the fixed batch (the same
     rays; images within rtol 1e-4 / atol 1e-5), timed (Mray/s, waves,
     launches, the card's name and power limit); `path` 64x64x16 through
     the pool and the fixed batch against the JAX CPU reference
     tests/torch_golden/subsurface_path_cpu_64x64_16spp.npz (MSE bar
     1e-4, no pair dropped, rays printed beside the reference's); the
     card against the CPU port at 32x32x4 on the small variant (MSE below
     1e-8);
 12. infra  — the render infrastructure on the main path: the killeroo
     at 128x128x256 through the dispatch window at depth 1 and 2
     (bit-identical), the capacity audit, three chaos recoveries and the
     strict firewall at 128x128x32;
 13. serve  — the serving stack on the main path's scene at full
     geometry (scenes.killeroo_file: the killeroo as a .pbrt file with
     its blob as a PLY), `path` 128x128x64 in slices of 2^18 work items
     (4 a job): the solo render; two tenants on one RenderService (one
     scene compile), bob preempted after 3 slices (a checkpoint-v4 park,
     his film dropped), resumed after 2 more, drained: both films
     bit-identical to the solo render, rays equal; under max_active=1 a
     priority-5 job displaces a running one (three films bit-identical);
     a warm resubmit with 0 scene compiles, 0 kernel builds and one more
     residency hit; a cancel that releases the pin and the spool file;
     the metrics exposition valid, `health` ok, the FLIGHT files valid;
     `python -m tpu_pbrt_torch.serve` and `python -m tpu_pbrt_torch.main
     --serve` as subprocesses on a JSONL session (submit, poll, preview,
     result, metrics, health, shutdown), each result equal to the solo
     render; a fleet of two LocalReplicas: two same-scene submits routed
     to one replica, that replica drained mid-render, both jobs resumed
     on the other from the spool, bit-identical; prints each job's
     Mray/s beside the solo's, slices, preemptions, parks, the queue-wait
     p90, scene_hbm_bytes beside the compile's memory_allocated delta,
     the flush and expand launches, and the phase's wall time; and
     hbmcheck's model on the card: the allocator's peaks
     (torch.cuda.max_memory_allocated) of the scene compile, the solo
     render and the two tenants' session, the working set of a slice of
     2^18 (the solo render's peak above the model's count; the [render]
     pool gives the default slice's, 2^20), the session's peak predicted
     by the model plus that working set and the compile's transient (at
     or above the measured peak, its ratio printed), and the default
     slice's working set with the allocator's measured slack (peak
     reserved beyond peak allocated bytes) within the share of the card
     the 80% headroom leaves beside the worst case;
 14. cli    — `python -m tpu_pbrt_torch.main scenes/cornell-path.pbrt
     --quick` in subprocesses on the card with a checkpoint every chunk:
     one uninterrupted render (the image must be written and finite), one
     killed after its first checkpoint and then resumed, whose image and
     final film must equal the uninterrupted one bit for bit;
 15. mesh   — several ranks on the main path (tpu_pbrt_torch/parallel/
     mesh.py): the full killeroo `path` at 128x128x256 through the pool
     over a mesh of ranks, each a spawned process that compiles the
     scene on its device and renders its half (or quarter) of every
     chunk; the film all-reduced after each chunk. With two or more cards
     NCCL over min(cards, 4) ranks, one card each; on one card two ranks
     share it over gloo (the launcher's explicit share_device layout),
     which measures no scaling. Prints the backend and layout, each
     rank's waves (wave_spread), the all-reduce ms per chunk, the flush
     and expand launches per rank (counters zeroed just before the mesh
     render, in every rank) and Mray/s beside the solo render's; checks
     the ranks' films equal, the rays equal the solo render's (phase 3),
     the film within rtol 1e-4 / atol 1e-5 of it and within MSE 1e-4 of
     refimg/killeroo_cpu_128x128_256spp.npz; then, on the killeroo as the
     daemons take it (scenes.killeroo_file: its blob a PLY) that the
     ranks compile at 128x128x64, in chunks of 2^18 (4 a render):
     the mesh solo render, a `mesh:lost@chunk=1` recovery bit-identical
     to it, and serving over the mesh (serve/service.py): the same ranks
     serve two tenants' jobs of that compiled scene through
     RenderService(mesh=...) in slices of 2^18 (rank 0 decides, the
     other rank follows its records), three steps, the second job
     preempted, a step, resumed, drained, with `mesh:lost@chunk=1` armed
     on every rank (it fires on the first slice 1 and the job rolls back
     to its checkpoint): both films and rays equal to the mesh solo
     render's; prints each job's Mray/s beside the mesh solo's, the
     queue-wait p90, the decision records' ms and the flush and expand
     launches per rank (counters zeroed on every rank just before the
     served run); `python -m tpu_pbrt_torch.serve --mesh 2` (the same
     layout) in a subprocess on a JSONL session (submit, poll, preview,
     result, metrics, health, shutdown), its result equal to the mesh
     solo render (in a full run beside `[infra]`, see phase 16); a
     small caustic SPPM (64x64, 2 x 4,096
     photons) over the mesh against the solo SPPM (max relative
     difference below 2e-2, mean below 2e-3);
 16. chaos  — `python -m tpu_pbrt_torch.chaos`, the recovery matrix on
     the card (its 17 rows under the reference's names: the device's
     fused tracer through a dispatch failure, the in-flight window, the
     ladder's re-dispatch, rollback and restart, torn / crashed /
     bit-flipped checkpoints, the NaN wave under retry and scrub, retry
     exhaustion and a corrupt resume, a mesh rank lost over two ranks on
     the card, the watchdog rows and the fleet rows), in a subprocess
     started with `[infra]` and read after `[serve]` and `[cli]`; every
     row must PASS; the phase prints each row and the `chaos_matrix`
     line. In a full run, host-bound work runs beside `[infra]` and
     `[serve]` (their pools leave the card and most cores idle): this
     matrix and `[mesh]`'s `serve --mesh 2` daemon beside `[infra]`,
     `[cli]` in a thread beside `[serve]`; and `[cloud]`, `[caustic]`
     and `[breadth]` run in a second process (`chip_smoke.py --beside
     cloud caustic breadth`, four CPU threads) beside `[crown]` to
     `[subsurface]`: each process is bound by its host thread, so the
     card and most cores are idle. The times of those phases, and the
     kernel times of the phases in either process from `[crown]` on, are
     taken beside the other's work: the kernels line names, under
     "timed_beside", each entry timed while other work shared the card
     and what that work was (SHARED_CARD);
 17. summary — one {"kernels": [...]} line (times and bounds at the pool
     wave, the fixed wave's under "at_fixed_wave"; launches of the pool
     and of the fixed path; the crown's under "crown"; the any-hit wave's
     under "direct"; the cloud's shadow-walk wave under "cloud"; the
     caustic's connection and photon waves under "caustic"; the breadth
     scene's pool and fixed waves under "breadth", the textured scene's
     under "textured", the motion scene's under "motion", the subsurface
     scene's probe-chord wave under "subsurface", the infra phase's under
     "infra", the serve phase's under "serve", the mesh's launches per
     rank under "mesh", the served mesh's jobs, Mray/s, queue-wait p90
     and launches per rank under "servemesh"), the whole script's time,
     the card's name and power limit (nvidia-smi), and as the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

It imports nothing of JAX or of the JAX package, and it fails without a
CUDA device or outside a checkout of the repo.

`python3 chip_smoke.py PHASE ...` (build, check, render, analysis, walkers, crown,
direct, samplers, cloud, caustic, breadth, textured, motion, subsurface,
infra, serve, cli, mesh, chaos) runs the build and the named phases only, for
development, and prints no kernels line and no result line.
`python3 chip_smoke.py --beside PHASE ...` is the second process of a full
run: it runs the named phases after the build the first process made and
prints their results on a line of its own, tagged BESIDE_TAG.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "torch_golden")
REF_IMAGE = os.path.join(HERE, "refimg", "killeroo_cpu_128x128_256spp.npz")
CROWN_REF = os.path.join(GOLDEN, "crown_cpu_64x64_64spp.npz")
CORNELL_REF = os.path.join(GOLDEN, "cornell_direct_cpu_256x256_16spp.npz")
KILLEROO_DIRECT_REF = os.path.join(GOLDEN, "killeroo_{}_cpu_64x64_16spp.npz")
CLOUD_REF = os.path.join(GOLDEN, "cloud_volpath_cpu_64x64_16spp.npz")
#: the timed cloud render, whose first shadow-walk wave the kernels are
#: checked on (one chunk of 2^20 camera rays)
CLOUD_RES, CLOUD_SPP = 256, 16
#: the killeroo directlighting render that is timed and whose first any-hit
#: wave the kernels are checked on (one chunk of 2^20 camera rays)
DIRECT_RES, DIRECT_SPP = 128, 64
MSE_BAR = 1e-4
#: the timed caustic BDPT render, whose connection wave the kernels are
#: checked on (one chunk of 2^20 camera rays)
CAUSTIC_RES, CAUSTIC_SPP = 256, 16
#: the timed caustic SPPM render (resolution, integrator parameters), whose
#: first photon wave the kernels are checked on
SPPM_TIMED = (256, '"integer numiterations" [2] "integer photonsperiteration" [1048576] '
                   '"float radius" [0.05]')
#: the timed caustic MLT render, with a chain count that fills the card
MLT_TIMED = (128, '"integer chains" [65536] "integer bootstrapsamples" [65536] '
                  '"integer mutationsperpixel" [32]')
#: SPPM on the card against the CPU port
SPPM_SMALL = '"integer numiterations" [2] "integer photonsperiteration" [4096] "float radius" [0.1]'
#: MLT on the card against its JAX CPU reference: the image means' bar
MLT_MEAN_BAR = 0.02
#: spp of the 512x512 crown render (the bench's 256 would not fit the time box)
CROWN_SPP = 4
#: the JAX CPU references of the breadth scene at 64x64x16, by camera
BREADTH_REF = os.path.join(GOLDEN, "breadth_{}_cpu_64x64_16spp.npz")
#: the timed breadth render, whose pool and fixed waves the kernels are checked on
BREADTH_RES, BREADTH_SPP = 512, 8
#: the 64x64x16 renders held against the JAX CPU references: camera -> filter
BREADTH_REFS = {"perspective": "gaussian", "realistic": "mitchell"}
#: the cameras held against the CPU port at 32x32x4 on the small tessellation
BREADTH_PORT = {"orthographic": "triangle", "environment": "sinc"}
#: the card against the CPU port on the breadth and subsurface scenes: the
#: MSE bar (the motion scene's card-vs-port MSE is printed beside it)
PORT_BAR = 1e-8
#: the JAX CPU references of the textured scene (path 64x64x16, bdpt 32x32x16)
TEXTURED_REF = os.path.join(GOLDEN, "textured_path_cpu_64x64_16spp.npz")
TEXTURED_BDPT_REF = os.path.join(GOLDEN, "textured_bdpt_cpu_32x32_16spp.npz")
#: the timed textured render, whose pool and fixed waves the kernels are checked on
TEXTURED_RES, TEXTURED_SPP = 512, 4
#: the JAX CPU references of the motion scene (path 64x64x16 and 64x64x64,
#: bdpt 32x32x16), each held to the bar
MOTION_REF = os.path.join(GOLDEN, "motion_path_cpu_64x64_64spp.npz")
MOTION_REF16 = os.path.join(GOLDEN, "motion_path_cpu_64x64_16spp.npz")
MOTION_BDPT_REF = os.path.join(GOLDEN, "motion_bdpt_cpu_32x32_16spp.npz")

#: the timed motion render, whose pool and fixed waves the kernels are checked on
MOTION_RES, MOTION_SPP = 512, 4
#: the JAX CPU reference of the subsurface scene (path 64x64x16)
SUBSURFACE_REF = os.path.join(GOLDEN, "subsurface_path_cpu_64x64_16spp.npz")
#: the timed subsurface render, whose first probe-chord wave the kernels are checked on
SUBSURFACE_RES, SUBSURFACE_SPP = 512, 8
#: the served killeroo: 128x128x64 = 2^20 work items in slices of 2^18, 4 a job
SERVE_RES, SERVE_SPP, SERVE_CHUNK = 128, 64, 262144

#: the walkers' renders (TORCH_PBRT_BVH=packet|wide|binary): the full
#: killeroo at this size on the card, each against the stream render of
#: the same image, and at the second size on the card and the CPU port
WALKER_RES, WALKER_SPP = 32, 4
WALKER_PORT_RES, WALKER_PORT_SPP = 12, 1
WALKERS_TIMEOUT_S = 400
#: the phases a full run hands to the second process, and its time limit
BESIDE = ("cloud", "caustic", "breadth")
#: in a full run, the kernel times under these keys of the kernels line are
#: taken while other work shares the card (named here); the top-level
#: times, from [check], are the idle card's. They compare only with times
#: taken the same way.
_MAIN_SIDE = "the second process ([cloud], [caustic], [breadth])"
_SECOND_SIDE = "the main process ([crown] to [subsurface])"
SHARED_CARD = {
    "mesh": "the [walkers] subprocess",
    "crown": _MAIN_SIDE, "direct": _MAIN_SIDE, "textured": _MAIN_SIDE, "motion": _MAIN_SIDE,
    "subsurface": _MAIN_SIDE,
    "cloud": _SECOND_SIDE, "caustic": _SECOND_SIDE, "breadth": _SECOND_SIDE,
    "infra": "the chaos matrix's subprocess and the `serve --mesh 2` daemon",
    "serve": "the chaos matrix's subprocess, the `serve --mesh 2` daemon and [cli]",
}
BESIDE_TIMEOUT_S = 900
BESIDE_TAG = "[beside-result] "

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12  # FP32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12


class SmokeFailure(Exception):
    pass


#: every subprocess the script starts: main() kills those still running
#: when it ends
CHILDREN = []


def spawn(argv, **kw):
    """subprocess.Popen(argv) from the repo's root, its output captured as
    text, registered in CHILDREN. Returns (process, start time)."""
    proc = subprocess.Popen(argv, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, **kw)
    CHILDREN.append(proc)
    return proc, time.perf_counter()


def collect(started, timeout):
    """Wait for a spawned process (killed at `timeout`). Returns (stdout,
    stderr, exit code, seconds since its start)."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return out, err, proc.returncode, time.perf_counter() - t0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout else \
            "nvidia-smi: not available"
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi: not available"


def _event_ms(fn, reps: int) -> float:
    """Device time per call from CUDA events around `reps` calls that the
    host enqueues while the card sleeps in a spin kernel, so the calls run
    back to back and no host launch gap enters (the device's own gaps
    between kernels do)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms of device cycles: the host enqueues meanwhile
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time_ms(fn, reps: int, warmup: int = 2):
    """Device time per call of `fn`: the CUDA kernels (and copies) that
    `reps` calls launch, summed by name from a torch.profiler trace, over
    `reps`. Returns (ms per call, {kernel name: ms per call}). The host's
    work around the launches is not in it (see host_ms). The trace is
    checked against CUDA events (_event_ms): where it holds less than
    half of their time, it has lost kernels (seen after a long profiled
    render earlier in the process) and the events' time is returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3 / reps
    total = sum(by_name.values())
    events = _event_ms(fn, reps)
    if total < 0.5 * events:
        log(f"[timing] the profiler holds {total:.4f} ms of {events:.4f} ms by CUDA events: "
            f"the events' time instead")
        if events <= 0:
            raise SmokeFailure("neither the profiler nor CUDA events recorded device time")
        total, by_name = events, {"(CUDA events)": events}
    return total, by_name


def host_ms(fn, reps: int, warmup: int = 2) -> float:
    """Wall time per call on the host: what the caller waits for before it
    can enqueue the next operation (the launches themselves run on)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def _by_kernel(parts) -> str:
    """'name ms' per kernel, the longest first; a C++ name is cut to the
    function and its template arguments."""
    import re

    def short(name):
        m = re.search(r"(\w+(?:<[^>]*>)?)\(", name.replace("(anonymous namespace)::", ""))
        return m.group(1) if m else name[:48]

    return ", ".join(f"{short(k)} {v:.4f}" for k, v in sorted(parts.items(), key=lambda kv: -kv[1]))


# -- phase 1 -------------------------------------------------------------------

def phase_build() -> None:
    from tpu_pbrt_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"[build] nvcc per source (parallel): "
        f"{ {k: round(v, 2) for k, v in secs.items()} }  total {time.perf_counter() - t0:.2f} s")
    for name in build.SOURCES:
        rep = os.path.join(build.BUILD_DIR, f"{name}.ptxas.txt")
        if os.path.exists(rep):
            for line in open(rep).read().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")
    for name in build.SOURCES:
        build.load(name)


# -- phase 2 -------------------------------------------------------------------

def _clone(args):
    """A kernel call's arguments, its tensors copied."""
    import torch

    return tuple(a.clone() if torch.is_tensor(a) else a for a in args)


def _hook_kernels(cap, want, past=None):
    """Wrap the stream tracer's two kernel seams: `want()` says whether
    the current call belongs to the traversal being captured; it records
    that traversal's first flush chunk and its first expand step after
    that flush (a popped slab of mixed nodes). With `past` given, the run
    is ended by raising _Captured once the expand is recorded or `past()`
    says the traversal is over. Returns the restore call."""
    from tpu_pbrt_torch.accel import stream

    real_expand, real_flush = stream.expand, stream.flush_chunk
    n_flush = [0]

    def expand_hook(*args):
        if past is not None and past():
            raise _Captured
        if want() and n_flush[0] > 0 and "expand" not in cap:
            cap["expand"] = _clone(args)
            if past is not None:
                raise _Captured
        return real_expand(*args)

    def flush_hook(*args):
        if past is not None and past():
            raise _Captured
        if want():
            n_flush[0] += 1
            if "flush" not in cap:  # the wave's first chunk: CH = min(512, block capacity)
                cap["flush"] = _clone(args)
        return real_flush(*args)

    stream.expand, stream.flush_chunk = expand_hook, flush_hook

    def restore():
        stream.expand, stream.flush_chunk = real_expand, real_flush

    return restore


class _Captured(Exception):
    """Raised from a kernel hook once its inputs are recorded, to stop
    the traversal it interrupts."""


def _capture_wave_inputs(scene, integ, chunk: int = 0):
    """Trace the fixed batch's first camera wave of chunk `chunk` of the
    render (closest hit), recording the inputs of its first flush chunk
    and of its first expand step after that flush. The any-hit expand
    input is that same slab with any_hit set and the wave's final hits on
    every other ray as the prim row, so the kernel's done-ray cull sees
    real data."""
    import torch

    from tpu_pbrt_torch.accel import stream

    from tpu_pbrt_torch.integrators.common import DIM_TIME

    dev = scene.dev
    plan = integ.prepare_chunks(scene)
    x0, x1, y0, _ = plan.bounds
    k = torch.arange(plan.chunk, dtype=torch.int32, device=scene.device)
    _, px, py, s, _, o, d, _ = integ.work_to_rays(
        scene.camera, plan.spp, x0, y0, x1 - x0, plan.npix, *plan.start(chunk), k
    )
    # a motion scene's camera samples trace at their shutter times, as the
    # fixed batch draws them
    ray_time = integ.u1d(px, py, s, DIM_TIME) if "tri_verts1" in dev else None
    cap = {"rays": (o, d)}
    restore = _hook_kernels(cap, lambda: True)
    try:
        hit = stream.stream_intersect(dev["tstream"], dev["tri_verts"], o, d, float("inf"),
                                      time=ray_time, tri_verts1=dev.get("tri_verts1"),
                                      tv9T=dev["tri_verts9T"], tv9T1=dev.get("tri_verts1_9T"))
    finally:
        restore()
    missing = {"flush", "expand"} - set(cap)
    if missing:
        raise SmokeFailure(f"could not capture kernel inputs for {sorted(missing)}")
    ea = cap["expand"]
    # every other ray keeps its final hit (culled as done), the rest are open
    rid = torch.arange(hit.prim.shape[0], device=hit.prim.device)
    prim = torch.where(rid % 2 == 0, hit.prim, torch.full_like(hit.prim, -1)).contiguous()
    cap["expand_anyhit"] = ea[:3] + (prim,) + ea[4:7] + (True,)
    return cap


def _capture_pool_wave(scene, integ, wave: int = 1):
    """Drain the render's middle chunk through the persistent pool up to
    its wave `wave` (0-based; wave 0's shadow half is empty, wave 1 is the
    first fused wave whose shadow rays carry a finite t_max) and record
    that wave's first flush chunk and first expand step after it. The
    chunks are pixel-major, so chunk 0 holds the top rows of the frame,
    mostly background: its early waves carry almost no shadow rays."""
    from tpu_pbrt_torch.accel import stream

    plan = integ.prepare_chunks(scene)
    if not plan.use_regen:
        raise SmokeFailure("the render plan does not take the persistent pool")
    cap = {"chunk": plan.n_chunks // 2}
    stream.WAVES.reset()
    restore = _hook_kernels(cap, lambda: stream.WAVES.waves == wave,
                            past=lambda: stream.WAVES.waves > wave)
    try:
        integ.pool_chunk(scene.dev, scene.film.init_state(scene.device),
                         *plan.start(cap["chunk"]), plan.chunk, plan.pool)
    except _Captured:
        pass
    finally:
        restore()
    missing = {"flush", "expand"} - set(cap)
    if missing:
        raise SmokeFailure(f"could not capture pool-wave kernel inputs for {sorted(missing)}")
    return cap, plan


def _motion_table(scene, flush_args):
    """A 64-feature (cubic-in-time) table over the scene's own treelets:
    every triangle moves by a small seeded offset over the shutter."""
    import numpy as np
    import torch

    from tpu_pbrt_torch.accel.mxu import tri_feature_weights_motion

    tp = scene.dev["tstream"]
    L = tp.leaf_tris
    off = tp.offset.cpu().numpy().astype(np.int64)
    cnt = tp.count.cpu().numpy()
    verts = scene.dev["tri_verts"].cpu().numpy()[: scene.n_tris]
    gidx = off[:, None] + np.arange(L)[None, :]
    valid = np.arange(L)[None, :] < cnt[:, None]
    tv0 = verts[np.clip(gidx, 0, len(verts) - 1)]
    tv0[~valid] = 0.0
    rng = np.random.default_rng(64)
    tv1 = (tv0 + rng.uniform(-0.01, 0.01, tv0.shape) * valid[..., None, None]).astype(np.float32)
    C = len(off)
    W = tri_feature_weights_motion(
        tv0.reshape(-1, 3, 3), tv1.reshape(-1, 3, 3),
        np.repeat(tp.center.cpu().numpy(), L, axis=0)[:, None, :], raw=True,
    ).reshape(C, L, 64, 4)
    featT = np.ascontiguousarray(W.transpose(0, 3, 1, 2).reshape(C, 4 * L, 64).transpose(0, 2, 1))
    feat, meta, rows, rayF, t_row, prim = flush_args
    rayF = rayF.clone()
    rayF[7] = torch.from_numpy(rng.uniform(0, 1, rayF.shape[1]).astype(np.float32)).to(rayF.device)
    return (torch.from_numpy(featT).to(rayF.device), meta, rows, rayF, t_row, prim)


def _compare_flush(a, b, label, exact=False):
    """t to 2 ulp; prim exact except at near-ties (t within 1e-6
    relative), which must stay under 0.1% of the rays. With `exact`, t
    to 0 ulp and no prim flip at all."""
    import numpy as np

    tk, pk = a[0].cpu().numpy(), a[1].cpu().numpy()
    tp_, pp = b[0].cpu().numpy(), b[1].cpu().numpy()
    if not np.array_equal(np.isfinite(tk), np.isfinite(tp_)):
        raise SmokeFailure(f"{label}: hit sets differ")
    fin = np.isfinite(tk)
    ulp = np.abs(tk.view(np.int32).astype(np.int64) - tp_.view(np.int32).astype(np.int64))
    ulp = np.where(tk == tp_, 0, ulp)
    flips = pk != pp
    with np.errstate(invalid="ignore"):
        near = np.abs(tk.astype(np.float64) - tp_) <= 1e-6 * np.abs(tk.astype(np.float64))
    err = float(np.max(np.abs(tk[fin] - tp_[fin]))) if fin.any() else 0.0
    log(f"[check] {label}: rays {len(tk)}, updated {int((pk >= 0).sum())}, max ulp {int(ulp.max())}, "
        f"max |dt| {err:.3e}, prim flips {int(flips.sum())} (all near-ties: {bool((near | ~flips).all())})")
    if ulp.max() > 2 or not (near | ~flips).all() or flips.sum() > 0.001 * len(pk):
        raise SmokeFailure(f"{label}: kernel disagrees with its plain version")
    if exact and (ulp.max() > 0 or flips.any()):
        raise SmokeFailure(f"{label}: kernel not exact against its plain version")
    return err


def _bound(flops, nbytes):
    """(least ms, what bounds it) of work moving `nbytes` and doing `flops`
    FP32 operations, at the card's peaks."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _flush_bound(args, count):
    """Least time for one flush chunk: what its data needs
    (kernels/flush.py::flush_work with the treelets' real triangle counts)."""
    from tpu_pbrt_torch.kernels.flush import flush_work

    return _bound(*flush_work(*args, count=count))


def _flush_bound_padded(args):
    """The padded figure, kept to compare with earlier records
    (kernels/flush.py::flush_work without the counts: every slot of the
    live blocks against all L triangle slots, zero padding included)."""
    from tpu_pbrt_torch.kernels.flush import flush_work

    return _bound(*flush_work(*args))


def _expand_bound(args):
    """Least time for one expand step (kernels/expand.py::expand_work)."""
    from tpu_pbrt_torch.kernels.expand import expand_work

    return _bound(*expand_work(*args))


def _check_tie_fixture(flush_chunk, flush_chunk_plain):
    """The seeded exact-tie chunk (kernels/fixtures.py) at the main path's
    treelet size L = 512: t as _compare_flush holds it, and prim EXACTLY
    equal — these are exact ties, decided by block order and then the
    lowest local index, so no near-tie leniency applies."""
    import torch

    from tpu_pbrt_torch.kernels.fixtures import flush_inputs

    for F in (16, 64):
        args = tuple(torch.from_numpy(x).cuda() for x in flush_inputs(F, L=512))
        a, b = flush_chunk(*args), flush_chunk_plain(*args)
        _compare_flush(a, b, f"tie fixture F={F} L=512")
        same = torch.equal(a[1], b[1])
        log(f"[check] tie fixture F={F} L=512: prim exact: {same} "
            f"(duplicate triangle -> 2: {int((a[1][:8] == 2).sum())}/8)")
        if not same:
            raise SmokeFailure(f"tie fixture F={F}: prim differs from the plain version")


def _flush_numbers(fa, count, label, exact=False):
    """Hold one captured flush chunk against the plain version, then time
    the kernel (device and host), the plain version and torch.bmm of the
    contraction alone, beside the bounds."""
    import torch

    from tpu_pbrt_torch.kernels.flush import flush_chunk, flush_chunk_plain

    CH, F = fa[1].shape[0], fa[0].shape[1]
    err = _compare_flush(flush_chunk(*fa), flush_chunk_plain(*fa), f"{label}: flush F={F} CH={CH}",
                         exact=exact)
    ms, parts = device_time_ms(lambda: flush_chunk(*fa), reps=20)
    h_ms = host_ms(lambda: flush_chunk(*fa), reps=20)
    plain_ms, _ = device_time_ms(lambda: flush_chunk_plain(*fa), reps=3, warmup=1)
    tids = fa[1][:, 0].long()
    n_live = int((fa[1][:, 5] > 0).sum())
    phiT = torch.randn(fa[1].shape[0], 128, F, device=fa[0].device)
    featg = fa[0][tids].contiguous()
    lib_ms, lib_parts = device_time_ms(lambda: torch.bmm(phiT, featg), reps=10)
    del phiT, featg
    bound, by = _flush_bound(fa, count)
    padded, _ = _flush_bound_padded(fa)
    log(f"[check] {label}: flush F={F}: kernel {ms:.4f} ms device ({_by_kernel(parts)}), host "
        f"{h_ms:.4f} ms per call, plain {plain_ms:.4f} ms, torch.bmm contraction {lib_ms:.4f} ms "
        f"({_by_kernel(lib_parts)}), bound {bound:.4f} ms ({by}; {padded:.4f} with the zero "
        f"padding); live blocks {n_live}")
    return dict(max_abs_err=err, ms=ms, host_ms=h_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, bound_padded_ms=padded, library_ms=lib_ms)


def _expand_numbers(ea, label):
    """Hold one captured expand step against the plain version (bit
    exact), then time it."""
    import torch

    from tpu_pbrt_torch.accel.stream import _tn_bits
    from tpu_pbrt_torch.kernels.expand import expand, expand_plain

    a, b = expand(*ea), expand_plain(*ea)
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    S, R = ea[0].shape[0], ea[2].shape[1]
    log(f"[check] {label}: expand S {S}, R {R}, key bits tb {ea[6]} (_tn_bits {_tn_bits(R)}), "
        f"any_hit {ea[7]}, live pairs {int(a[2].sum())}, exact: {same}")
    if not same:
        raise SmokeFailure(f"{label}: expand disagrees with its plain version")
    ms, _ = device_time_ms(lambda: expand(*ea), reps=50)
    h_ms = host_ms(lambda: expand(*ea), reps=50)
    plain_ms, _ = device_time_ms(lambda: expand_plain(*ea), reps=10)
    bound, by = _expand_bound(ea)
    log(f"[check] {label}: expand: kernel {ms:.4f} ms device, host {h_ms:.4f} ms per call, "
        f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return dict(max_abs_err=0.0, ms=ms, host_ms=h_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


def _check_waves(scene, integ, label="", fixed_chunk=0, exact=False, fixed_packed=True,
                 extra=None, features=16):
    """Both kernels at a scene's pool wave (the top-level numbers; its flush
    key must pack) and at its fixed batch's first camera wave of chunk
    `fixed_chunk` (under "at_fixed_wave"; its key packed iff
    `fixed_packed`), and the any-hit expand on that wave's slab.
    `extra(flush_args)` runs on the fixed wave's flush capture and returns
    numbers kept under "synthetic_f64", their max_abs_err folded into the
    flush's.
    Both waves' flush tables must have `features` rows (16, or 64 with the
    cubic-in-time motion features, whose rays carry their shutter times in
    rayF row 7). Returns (numbers, the camera wave's rays)."""
    import torch

    from tpu_pbrt_torch.accel.stream import _ray_bits, flush_geometry
    from tpu_pbrt_torch.kernels.expand import expand, expand_plain

    tp = scene.dev["tstream"]

    def packed(R):
        return tp.n_treelets < (1 << (31 - _ray_bits(R)))

    t0 = time.perf_counter()
    # wave 1 of the middle chunk; a one-chunk render's first pool-full is
    # the top rows of the frame (often sky, no shadow rays), so take the
    # first later wave whose shadow half is live
    for wave in range(1, 9):
        try:
            pcap, plan = _capture_pool_wave(scene, integ, wave)
        except SmokeFailure:
            # a wave whose traversal ends after its first flush has no
            # expand step to capture
            if wave == 8 or integ.prepare_chunks(scene).n_chunks > 1:
                raise
            continue
        R = pcap["flush"][3].shape[1]
        # the flush's rayF row 6 is the t_max row: > 0 for a live ray
        n_shadow = int((pcap["flush"][3][6, plan.pool:] > 0).sum())
        if n_shadow or plan.n_chunks > 1:
            break
    log(f"[check] {label}pool wave: captured wave {wave} of chunk {pcap['chunk']} of "
        f"{plan.n_chunks} (pool {plan.pool} slots, {R} rays: camera + shadow; {n_shadow} "
        f"shadow rays live; flush key packed: {packed(R)}) in {time.perf_counter() - t0:.2f} s; "
        f"flush geometry {flush_geometry(R, tp.n_treelets)}")
    if R != 2 * plan.pool or n_shadow == 0 or not packed(R):
        raise SmokeFailure(f"{label}pool wave: expected a packed 2x{plan.pool}-ray wave with "
                           f"live shadow rays, got {R} rays, {n_shadow} shadow rays live")
    _check_features(pcap["flush"], features, f"{label}pool wave")
    out = {"flush_chunk": _flush_numbers(pcap["flush"], tp.count, f"{label}pool wave", exact),
           "expand": _expand_numbers(pcap["expand"], f"{label}pool wave")}
    del pcap

    t0 = time.perf_counter()
    cap = _capture_wave_inputs(scene, integ, fixed_chunk)
    R = cap["flush"][3].shape[1]
    log(f"[check] {label}fixed wave: captured kernel inputs from chunk {fixed_chunk}'s {R}-ray "
        f"camera wave in {time.perf_counter() - t0:.2f} s; flush key packed: {packed(R)}; "
        f"flush geometry {flush_geometry(R, tp.n_treelets)}")
    if packed(R) != fixed_packed:
        raise SmokeFailure(f"{label}fixed wave: expected a {'packed' if fixed_packed else 'unpacked'}"
                           " flush key")
    _check_features(cap["flush"], features, f"{label}fixed wave")
    fixed = {"flush_chunk": _flush_numbers(cap["flush"], tp.count, f"{label}fixed wave", exact)}
    if extra is not None:
        out["flush_chunk"]["synthetic_f64"] = extra(cap["flush"])
        out["flush_chunk"]["max_abs_err"] = max(out["flush_chunk"]["max_abs_err"],
                                                out["flush_chunk"]["synthetic_f64"]["max_abs_err"])
    # expand closest-hit (timed) and any-hit (exactness only: the render
    # path traces closest-hit waves only)
    fixed["expand"] = _expand_numbers(cap["expand"], f"{label}fixed wave")
    ea = cap["expand_anyhit"]
    if not all(torch.equal(x, y) for x, y in zip(expand(*ea), expand_plain(*ea))):
        raise SmokeFailure(f"{label}any-hit expand disagrees with its plain version")
    log(f"[check] {label}fixed wave: any-hit expand exact: True")
    for k in out:
        out[k]["at_fixed_wave"] = fixed[k]
        out[k]["max_abs_err"] = max(out[k]["max_abs_err"], fixed[k]["max_abs_err"])
    rays = cap["rays"]
    del cap
    torch.cuda.empty_cache()
    return out, rays


def _check_features(fa, features, label):
    """A captured flush chunk's table has `features` rows; at F = 64 its
    live slots' rays carry shutter times (rayF row 7), not all zero."""
    import torch

    feat, meta, rows, rayF = fa[:4]
    live = rows[(rows >= 0) & (meta[:, 5] > 0)[:, None]].long()
    times = rayF[7, live]
    log(f"[check] {label}: feature rows F = {feat.shape[1]}, {live.numel()} filled slots, ray "
        f"times in [{float(times.min()):.4f}, {float(times.max()):.4f}]")
    if feat.shape[1] != features or (features == 64) != bool(torch.any(times != 0)):
        raise SmokeFailure(f"{label}: expected F = {features} with "
                           f"{'real' if features == 64 else 'zero'} ray times")


def phase_check(scene, integ):
    """Both kernels at the main path's shapes (_check_waves), plus the tie
    fixture and the F=64 (motion feature) flush on the fixed wave's chunk."""
    from tpu_pbrt_torch.kernels.flush import flush_chunk, flush_chunk_plain

    _check_tie_fixture(flush_chunk, flush_chunk_plain)

    def flush_f64(fa):
        t1 = time.perf_counter()
        fm = _motion_table(scene, fa)
        log(f"[check] synthetic F=64 table built in {time.perf_counter() - t1:.1f} s")
        return _flush_numbers(fm, scene.dev["tstream"].count, "synthetic F=64 table")

    return _check_waves(scene, integ, extra=flush_f64)[0]


# -- phase 3 -------------------------------------------------------------------

def _render_counted(integ, scene, regen: bool):
    """One render through the pool (regen) or the fixed batch, with the
    kernel launch counters zeroed just before and read just after."""
    from tpu_pbrt_torch.config import cfg
    from tpu_pbrt_torch.kernels import LAUNCHES, reset_launches

    saved = cfg.regen
    cfg.regen = regen
    try:
        reset_launches()
        res = integ.render(scene)
        launches = dict(LAUNCHES)
    finally:
        cfg.regen = saved
    if bool(res.stats.get("regen")) != regen:
        raise SmokeFailure(f"render: asked for regen={regen}, stats say {res.stats.get('regen')}")
    for name, n in launches.items():
        if n <= 0:
            raise SmokeFailure(f"render (regen={regen}): kernel {name} was never launched")
    return res, launches


def _log_render(label, res, launches):
    st = res.stats
    log(f"[render] {label}: {res.seconds:.3f} s, {res.rays_traced} rays, "
        f"{res.mray_per_sec:.4f} Mray/s, chunks {st['chunks']}, traversal waves {st['waves']}, "
        f"host reads per wave {st['host_reads_per_wave_mean']:.2f} (traversal) + "
        f"{st['loop_host_reads_per_wave']:.2f} (loop), launches {json.dumps(launches)}")
    log(f"[render] {label}: stats {json.dumps(st)}")


def phase_render(scene, integ):
    """The main path (the pool at 128x128x256, MSE bar against the
    reference image), the fixed batch on the same scene (same rays), and
    both at 64x64x16 (images within the reference's pool tolerance)."""
    import numpy as np

    from tpu_pbrt_torch.scenes import compile_api, make_killeroo_like

    base = _peak_reset()
    res, launches = _render_counted(integ, scene, regen=True)
    HBM["default"] = _working_set("[render] pool", res, *_peak_read(base))
    img = res.image
    ref = np.load(REF_IMAGE)["image"]
    if img.shape != ref.shape or not np.isfinite(img).all():
        raise SmokeFailure(f"render: image shape {img.shape} / finite {np.isfinite(img).all()}")
    mse = float(np.mean((img.astype(np.float64) - ref) ** 2))
    _log_render("pool 128x128 256 spp maxdepth 5", res, launches)
    log(f"[render] pool: image mean {img.mean():.6f} (ref {ref.mean():.6f}), MSE vs ref "
        f"{mse:.3e} (bar {MSE_BAR:g}), pool {res.stats['pool']}, waves {res.stats['n_waves']}, "
        f"occupancy {res.stats['mean_wave_occupancy']:.4f}")
    if mse > MSE_BAR:
        raise SmokeFailure(f"render: MSE {mse:.3e} > {MSE_BAR:g}")

    fres, flaunches = _render_counted(integ, scene, regen=False)
    fmse = float(np.mean((fres.image.astype(np.float64) - ref) ** 2))
    _log_render("fixed 128x128 256 spp maxdepth 5", fres, flaunches)
    log(f"[render] fixed: MSE vs ref {fmse:.3e}; pool/fixed Mray/s "
        f"{res.mray_per_sec / max(fres.mray_per_sec, 1e-9):.3f}")
    if fres.rays_traced != res.rays_traced or fmse > MSE_BAR:
        raise SmokeFailure(f"render: fixed batch traced {fres.rays_traced} rays (pool "
                           f"{res.rays_traced}), MSE {fmse:.3e}")

    t0 = time.perf_counter()
    small, sinteg = compile_api(make_killeroo_like(res=64, spp=16, maxdepth=5, device="cuda"))
    sp, _ = _render_counted(sinteg, small, regen=True)
    sf, _ = _render_counted(sinteg, small, regen=False)
    diff = float(np.max(np.abs(sp.image - sf.image)))
    log(f"[render] 64x64 16 spp: pool {sp.rays_traced} rays, fixed {sf.rays_traced} rays, "
        f"max |pool - fixed| {diff:.3e} ({time.perf_counter() - t0:.1f} s with the compile)")
    if sp.rays_traced != sf.rays_traced or not np.allclose(sp.image, sf.image, rtol=1e-4,
                                                           atol=1e-5):
        raise SmokeFailure("render: the pool and the fixed batch disagree at 64x64x16")
    return launches, flaunches, res


# -- phase 3, [analysis] -------------------------------------------------------

def _sync_warnings(fn):
    """Run fn() under torch.cuda.set_sync_debug_mode("warn"); returns (its
    result, [(the port's innermost frame, the warning) for each
    synchronizing call])."""
    import traceback
    import warnings

    import torch

    pkg = os.path.join(HERE, "tpu_pbrt_torch")
    syncs = []
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        # one warning per synchronizing call (not the mode's own notice)
        if "called a synchronizing" not in str(message):
            return shown(message, category, filename, lineno, file, line)
        ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(pkg)]
        where = (f"{os.path.relpath(ours[-1].filename, HERE)}:{ours[-1].lineno} {ours[-1].name}"
                 if ours else f"{filename}:{lineno}")
        syncs.append((where, str(message)))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = shown
    torch.cuda.synchronize()
    return out, syncs


def phase_analysis(scene, integ, res):
    """The measuring analysis layers on the [render] killeroo and its pool
    render (see the module doc): sync warnings against the tally and the
    recorder, the cuda rollup of one pool wave, the tiny pool chunk gated
    against the committed cuda budget beside the cpu one, the live ratio
    and the telemetry block."""
    from collections import Counter

    import torch

    from tpu_pbrt_torch.accel import stream
    from tpu_pbrt_torch.analysis import audit, cost
    from tpu_pbrt_torch.analysis.record import OpRecorder
    from tpu_pbrt_torch.bench import telemetry_block
    from tpu_pbrt_torch.obs.metrics import host_overlap_fraction
    from tpu_pbrt_torch.obs.rooflive import live_vs_static

    pool = int(res.stats["pool"])
    film = scene.film
    dev = torch.device(scene.device)
    # one refill of the pool from the frame's middle chunk (its first
    # chunk's items are the top rows: sky, every ray missing in one wave)
    plan = integ.prepare_chunks(scene)
    start_pix, start_s = plan.start(plan.n_chunks // 2)

    def chunk():
        fs = film.init_state(dev)
        return integ.pool_chunk(scene.dev, fs, start_pix, start_s, pool, pool, film=film,
                                cam=scene.camera)

    t0 = time.perf_counter()
    stream.WAVES.reset()
    out, warned = _sync_warnings(chunk)
    W = stream.WAVES
    waves, reads, loop_reads = int(out[3]), W.host_reads, W.loop_reads
    where = Counter(w for w, _ in warned)
    log(f"[analysis] one pool chunk of {pool} items through the {pool}-slot pool: {waves} waves, "
        f"{len(warned)} sync warnings (torch.cuda.set_sync_debug_mode), the tally's host reads "
        f"{reads} (traversal) + {loop_reads} (loop) = {reads + loop_reads}; per wave "
        f"{len(warned) / max(waves, 1):.3f} against {reads / max(waves, 1):.3f} + "
        f"{loop_reads / max(waves, 1):.3f}; [render] pool: host_reads_per_wave_mean "
        f"{res.stats['host_reads_per_wave_mean']:.3f}, loop_host_reads_per_wave "
        f"{res.stats['loop_host_reads_per_wave']:.3f}; warned at {dict(where.most_common(8))}; "
        f"messages {sorted({m[:120] for _, m in warned})}")
    if len(warned) != reads + loop_reads:
        raise SmokeFailure(f"analysis: {len(warned)} sync warnings over the pool chunk, the tally "
                           f"counts {reads + loop_reads} host reads")

    stream.WAVES.reset()
    with OpRecorder() as rec:
        chunk()
        torch.cuda.synchronize()
    syncs = rec.syncs()
    roll, findings = cost.rollup_records(rec.records, "pool_chunk[killeroo]", max(rec.waves(), 1),
                                         pool, dev.type)
    kinds = Counter(r.name for r in rec.records if r.kind == "kernel")
    log(f"[analysis] recorded: {len(rec.records)} records over {rec.waves()} waves, host syncs "
        f"{len(syncs)} ({dict(Counter(r.kind + ':' + r.name for r in syncs))}), kernel calls "
        f"{dict(kinds)}; cuda rollup per wave: {roll.flops} FLOPs, {roll.hbm_bytes} B, "
        f"{roll.ops} ops, intensity {roll.intensity:.3f}, fp {roll.fingerprint}; findings "
        f"{[str(f) for f in findings if f.waived is None]}")
    if len(syncs) != len(warned):
        raise SmokeFailure(f"analysis: the recorder saw {len(syncs)} host syncs, the sync debug "
                           f"mode {len(warned)}")
    del rec

    tiny = audit.record_pool_chunk(dev.type)
    troll, _ = cost.rollup_run(tiny)
    budgets = cost.load_budgets()
    cpu_b = budgets.get("entries", {}).get("cpu", {}).get("pool_chunk", {})
    cuda_b = budgets.get("entries", {}).get(dev.type, {}).get("pool_chunk")
    log(f"[analysis] tiny pool chunk (audit scene, {audit.POOL_WORK} items, "
        f"{audit.POOL_SLOTS} slots): cuda {troll.to_json()} beside the committed cpu "
        f"{cpu_b}; committed cuda {cuda_b}; tiny host syncs {len(tiny.rec.syncs())} against the "
        f"tally's {tiny.tally['host_reads'] + tiny.tally['loop_reads']}")
    gate = dict(budgets, entries={dev.type: {"pool_chunk": cuda_b}} if cuda_b else {})
    errors, warnings_ = cost.check_budgets({"pool_chunk": troll}, gate, dev.type)
    for w in warnings_:
        log(f"[analysis] cost [warning]: {w}")
    if cuda_b is not None and errors:
        raise SmokeFailure(f"analysis: the cuda budget gate: {errors}")
    if len(tiny.rec.syncs()) != tiny.tally["host_reads"] + tiny.tally["loop_reads"]:
        raise SmokeFailure("analysis: the tiny pool chunk's host syncs differ from the tally")
    del tiny

    static = cost.bench_fields(roll)
    kind = torch.cuda.get_device_name(0)
    live = live_vs_static(waves=res.stats["n_waves"], seconds=res.seconds,
                          static_bytes_per_wave=roll.hbm_bytes, static_flops_per_wave=roll.flops,
                          device_kind=kind)
    overlap = host_overlap_fraction(res.stats.get("phase_seconds"), res.seconds)
    log(f"[analysis] [render] pool 128x128x256: {res.stats['n_waves']} waves in "
        f"{res.seconds:.3f} s: live_vs_static_ratio {live['live_vs_static_ratio']} "
        f"(live {live['live_bytes_per_sec']:.4e} B/s of {live['hbm_peak_bytes_per_sec']:.4e}), "
        f"host_overlap_fraction {overlap}; {card_line()}")
    tele = telemetry_block(res, scene, static)
    log(f"[analysis] telemetry {json.dumps(tele)}")
    if live["live_vs_static_ratio"] is None or set(tele) != set(TELEMETRY_KEYS):
        raise SmokeFailure(f"analysis: no live ratio on {kind!r}, or telemetry keys {sorted(tele)}")
    hbm = _hbm_static()
    log(f"[analysis] done in {time.perf_counter() - t0:.1f} s")
    return dict(static, live_vs_static_ratio=live["live_vs_static_ratio"],
                host_overlap_fraction=overlap, sync_warnings=len(warned),
                tally_reads=reads + loop_reads, waves=waves, hbm=hbm)


def _hbm_static():
    """hbmcheck's static pass on the card, and the card's capacity beside
    the committed table (the model against the allocator's peaks is
    checked in [serve], _hbm_serve)."""
    from tpu_pbrt_torch.analysis import hbmcheck as hc

    errors, warnings_ = hc.run_hbmcheck()
    card, committed = hc.card_capacity(), hc.capacity_table()
    worst = hc.serve_model()
    log(f"[analysis] hbmcheck: static pass {len(errors)} error(s) {errors[:3]}, "
        f"{len(warnings_)} warning(s); card capacity {card} (committed {committed}); the "
        f"model's worst case {worst['total_bytes']} B (resident budget "
        f"{worst['resident_bytes']} + {worst['max_active']} jobs x {worst['job_bytes']} + "
        f"prefetch {worst['prefetch_bytes']} + staging {worst['staging_bytes']})")
    if errors or card.keys() - committed.keys():
        raise SmokeFailure(f"analysis: hbmcheck {errors}, card {card} not in the committed "
                           f"table {committed}")
    return {"worst_bytes": int(worst["total_bytes"]), "capacity": card}


#: the allocator peaks [render] measures for hbmcheck's card leg in [serve]
HBM = {}


def _peak_reset():
    """Collect what earlier work left for the collector (freed during a
    measurement it would hide allocations), release the allocator's
    cached blocks, then zero its peaks. Returns the bytes allocated now,
    which the peak is read above."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_read(base):
    """(the allocator's peak above base, its slack: its peak reserved
    bytes beyond its peak allocated ones)."""
    import torch

    torch.cuda.synchronize()
    alloc = torch.cuda.max_memory_allocated()
    return alloc - base, torch.cuda.max_memory_reserved() - alloc


def _working_set(label, res, peak, slack):
    """The working set of a solo render's slices: its allocator peak above
    what hbmcheck's model counts for it; logged per slice size."""
    from tpu_pbrt_torch.analysis import hbmcheck as hc

    ry, rx = res.image.shape[:2]
    model = hc.render_model_bytes(rx, ry)
    ws = hc.working_set_bytes(peak, model)
    chunk = int(res.stats["chunk"])
    log(f"[hbm] {label} ({rx}x{ry}, slices of {chunk}): allocator peak {peak} B above the "
        f"scene, the model's film carries, counters and staging {model} B, working set {ws} B "
        f"({ws / chunk:.1f} B a work item), allocator slack {slack} B; {card_line()}")
    return {"chunk": chunk, "peak_bytes": int(peak), "model_bytes": int(model),
            "working_set_bytes": int(ws), "bytes_per_item": ws / chunk, "slack": slack}


def _hbm_serve(res, spp, chunk, scene_bytes, compile_peak, solo, session_peak, slack, resident,
               n_jobs):
    """hbmcheck's model against the served session of [serve]: the
    working set of the solo render at the session's slices, with the
    scene compile's transient, predicts the session's allocator peak
    (at or above it, the ratio printed); and the default slice's working
    set ([render]) and the allocator's measured slack fit the share of
    the card the headroom leaves beside the worst case."""
    from tpu_pbrt_torch.analysis import hbmcheck as hc

    compile_extra = max(int(compile_peak) - int(scene_bytes), 0)
    model = hc.serve_model(rx=res, ry=res, max_active=n_jobs, resident_bytes=resident)
    pred = hc.predict_session(model, solo["working_set_bytes"], compile_extra)
    ratio, errs = hc.session_check(pred, session_peak)
    worst = hc.serve_model()
    worst_ratio, werrs = hc.session_check(worst["total_bytes"], session_peak)
    errs += werrs
    log(f"[serve] hbmcheck: session of {n_jobs} jobs of {res}x{res}x{spp} in slices of {chunk}: "
        f"allocator peak {session_peak} B; the model of the session {model['total_bytes']} B "
        f"(resident {resident} + {n_jobs} jobs x {model['job_bytes']} + prefetch "
        f"{model['prefetch_bytes']} + staging {model['staging_bytes']}), model alone / peak "
        f"{model['total_bytes'] / max(session_peak, 1):.4f}; with the solo render's working set "
        f"{solo['working_set_bytes']} B and the compile's transient {compile_extra} B "
        f"(its peak {compile_peak} B over the scene's {scene_bytes} B) it predicts {pred} B, "
        f"prediction / peak {ratio:.4f}; the worst case {worst['total_bytes']} B / peak "
        f"{worst_ratio:.4f}")
    default = HBM.get("default")
    out = {"session_peak_bytes": int(session_peak), "session_model_bytes": model["total_bytes"],
           "predicted_bytes": int(pred), "predicted_over_peak": round(ratio, 4),
           "worst_over_peak": round(worst_ratio, 4), "working_set": {"solo": solo}}
    if default is None:
        log("[serve] hbmcheck: the default slice's working set is measured by [render], "
            "which did not run: headroom not checked")
    else:
        capacity = hc.card_capacity()
        slack_max = max(slack, default["slack"], solo["slack"])
        share, herrs = hc.headroom_check(worst["total_bytes"], default["working_set_bytes"],
                                         slack_max, capacity)
        errs += herrs
        log(f"[serve] hbmcheck: the worst case {worst['total_bytes']} B plus the working set of "
            f"the default slice ({default['chunk']}) {default['working_set_bytes']} B and the "
            f"allocator's largest slack {slack_max} B (session {slack} B) take {share:.4f} of "
            f"the card, the two beside the worst case "
            f"{(default['working_set_bytes'] + slack_max) / min(capacity.values()):.4f} of it "
            f"(the headroom leaves {1 - hc.HBM_HEADROOM:.2f}); {card_line()}")
        out["working_set"]["default"] = default
        out["worst_share_of_card"] = round(share, 4)
    if errs:
        raise SmokeFailure(f"serve: hbmcheck {errs}")
    return out


#: the keys of the reference bench line's telemetry block (bench.py)
TELEMETRY_KEYS = ("counters", "wave_spread", "tracer_mode", "fused_blocks_per_flush",
                  "phase_seconds", "host_overlap_fraction", "live_bytes_per_sec",
                  "live_flops_per_sec", "hbm_peak_bytes_per_sec", "live_vs_static_ratio")


# -- phase 3, [walkers] --------------------------------------------------------

def walkers_start():
    """Start `[walkers]` (`python3 chip_smoke.py walkers`, its own process
    and CUDA context, two CPU threads) in a subprocess: in a full run it
    runs beside `[mesh]`, whose process only waits for its ranks. Returns
    (process, start time)."""
    return spawn([sys.executable, os.path.join(HERE, "chip_smoke.py"), "walkers"],
                 env=dict(os.environ, OMP_NUM_THREADS="2"))


def walkers_collect(started):
    """Wait for the `[walkers]` subprocess and relay its lines; fails unless
    it ended with code 0 after its last line."""
    out, err, rc, secs = collect(started, WALKERS_TIMEOUT_S)
    lines = [ln for ln in out.splitlines() if ln.startswith("[walkers]")]
    for ln in lines:
        log(ln)
    log(f"[walkers] subprocess exit {rc}, {secs:.1f} s since its start")
    if rc != 0 or not any("phase wall time" in ln for ln in lines):
        raise SmokeFailure(f"walkers: exit {rc}: {err[-3000:]}")


def phase_walkers():
    """The packet, wide and binary walkers on the full killeroo (see the
    module doc): each renders WALKER_RES x WALKER_RES x WALKER_SPP on the
    card against the stream render of the same image (the repo's bar,
    rays beside), and WALKER_PORT_RES x WALKER_PORT_RES x WALKER_PORT_SPP
    on the card against the CPU port (below PORT_BAR, rays equal); Mray/s
    and the host reads per wave of each beside the stream render's."""
    import numpy as np

    from tpu_pbrt_torch.config import cfg
    from tpu_pbrt_torch.kernels import LAUNCHES, reset_launches
    from tpu_pbrt_torch.scenes import compile_api, make_killeroo_like

    t_phase = time.perf_counter()
    prev = cfg.bvh

    def render(knob, res, spp, device):
        cfg.bvh = knob
        t = time.perf_counter()
        scene, integ = compile_api(make_killeroo_like(res=res, spp=spp, maxdepth=5,
                                                      device=device))
        compile_s = time.perf_counter() - t
        reset_launches()
        r = integ.render(scene)
        if scene.n_tris != 128884 or not np.isfinite(r.image).all():
            raise SmokeFailure(f"walkers: {knob} on {device}: {scene.n_tris} triangles, finite "
                               f"{np.isfinite(r.image).all()}")
        return r, compile_s, dict(LAUNCHES)

    out = {}
    try:
        st, st_c, st_l = render("stream", WALKER_RES, WALKER_SPP, "cuda")
        st_reads = st.stats["host_reads_per_wave_mean"] + st.stats["loop_host_reads_per_wave"]
        log(f"[walkers] stream {WALKER_RES}x{WALKER_RES}x{WALKER_SPP}: {st.rays_traced} rays, "
            f"{st.mray_per_sec:.4f} Mray/s, {st.stats['waves']} waves, host reads per wave "
            f"{st_reads:.3f}, launches {json.dumps(st_l)}; compiled in {st_c:.1f} s")
        for knob in ("packet", "wide", "binary"):
            r, comp, launches = render(knob, WALKER_RES, WALKER_SPP, "cuda")
            w = r.stats["walker"]
            mse = float(np.mean((r.image.astype(np.float64) - st.image) ** 2))
            small = render(knob, WALKER_PORT_RES, WALKER_PORT_SPP, "cuda")[0]
            cpu = render(knob, WALKER_PORT_RES, WALKER_PORT_SPP, "cpu")[0]
            port_mse = float(np.mean((small.image.astype(np.float64) - cpu.image) ** 2))
            reads = w["host_reads_per_wave"] + r.stats["loop_host_reads_per_wave"]
            log(f"[walkers] {knob} {WALKER_RES}x{WALKER_RES}x{WALKER_SPP} (chunk "
                f"{r.stats['chunk']}): {r.rays_traced} rays (stream {st.rays_traced}), MSE "
                f"against the stream render {mse:.4e} (bar {MSE_BAR}), {r.mray_per_sec:.4f} "
                f"Mray/s (stream {st.mray_per_sec:.4f}), {w['waves']} walks, {w['steps']} "
                f"masked steps, host reads per wave {reads:.3f} (stream {st_reads:.3f}), "
                f"launches {json.dumps(launches)}, compiled in {comp:.1f} s; "
                f"{WALKER_PORT_RES}x{WALKER_PORT_RES}x{WALKER_PORT_SPP} card against the CPU "
                f"port: MSE {port_mse:.4e} (bar {PORT_BAR}), rays {small.rays_traced} / "
                f"{cpu.rays_traced}; {card_line()}")
            if mse > MSE_BAR or port_mse >= PORT_BAR or small.rays_traced != cpu.rays_traced:
                raise SmokeFailure(f"walkers: {knob}: MSE {mse} against the stream render, "
                                   f"{port_mse} against the CPU port, rays {small.rays_traced} "
                                   f"/ {cpu.rays_traced}")
            out[knob] = {"mray_per_sec": r.mray_per_sec, "host_reads_per_wave": reads,
                         "mse_stream": mse, "rays": r.rays_traced, "port_mse": port_mse}
    finally:
        cfg.bvh = prev
    log(f"[walkers] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return dict(out, stream={"mray_per_sec": st.mray_per_sec, "host_reads_per_wave": st_reads,
                             "rays": st.rays_traced})


# -- phase 15 ------------------------------------------------------------------

#: the mesh phase's second killeroo: 128x128 at this spp in chunks of 2^18
#: (4 a render): the mesh solo render at that size, the mesh:lost recovery
#: and the jobs served over the mesh
MESH_SERVE_SPP = 64
MESH_SERVE_CHUNK = 1 << 18
MESH_SPPM_RES = 64


def _mesh_serve(mesh, scene, integ, spool):
    """The jobs served over the mesh on every rank (rank 0 decides, the
    others follow its records): two tenants' jobs of the compiled
    killeroo with a checkpoint every slice, three steps, a preempt of the
    second, a step, its resume and the drain, with `mesh:lost@chunk=1`
    armed on every rank (it fires on the first dispatch of a chunk 1).
    Returns rank 0's films and numbers, and each rank's launches."""
    from tpu_pbrt_torch.chaos import CHAOS
    from tpu_pbrt_torch.kernels import LAUNCHES, reset_launches
    from tpu_pbrt_torch.obs.metrics import METRICS
    from tpu_pbrt_torch.serve import RenderService

    METRICS.reset()
    os.makedirs(spool, exist_ok=True)
    svc = RenderService(mesh=mesh, chunk=MESH_SERVE_CHUNK, seed=0, spool_dir=spool)
    pair = (scene, integ)

    def lead(svc):
        a = svc.submit(compiled=pair, resident_key="killeroo", tenant="alice",
                       checkpoint_every=1)
        b = svc.submit(compiled=pair, resident_key="killeroo", tenant="bob",
                       checkpoint_every=1)
        for _ in range(3):
            svc.step()
        svc.preempt(b)
        parked_at = svc.poll(b)["chunks_done"]
        svc.step()
        svc.resume(b)
        svc.drain()
        snap = METRICS.snapshot()["metrics"]
        waits = snap["tpu_pbrt_serve_queue_wait_seconds"]["series"]
        jobs = {}
        for j in (a, b):
            r = svc.result(j)
            jobs[j] = {"film": [t.cpu() for t in r.film_state], "rays": r.rays_traced,
                       "mray": r.mray_per_sec, "recovery": r.stats.get("recovery"),
                       "preemptions": svc.poll(j)["preemptions"]}
        return {"jobs": jobs, "schedule": svc.schedule, "parked_at": parked_at,
                "p90": max(s["p90"] for s in waits),
                "n_wait": sum(s["count"] for s in waits), "mesh": svc.mesh_stats(),
                "fired": CHAOS.report()}

    CHAOS.install("mesh:lost@chunk=1")
    reset_launches()
    try:
        out = svc.lead_or_follow(lead, compiled={"killeroo": pair}) or {}
    finally:
        CHAOS.clear()
    out["launches"] = dict(LAUNCHES)
    return out


def _mesh_rank(mesh, ckpt_dir, serve_path):
    """One rank of `[mesh]` (a spawned process): the killeroo at 128x128x256
    over the mesh with this rank's launches counted, then the killeroo as
    the daemons take it (`serve_path`, scenes.killeroo_file: its blob's
    normals are a PLY's float32) at 128x128x64 in chunks of 2^18: the
    solo mesh render, the mesh:lost recovery and the jobs served over the
    mesh (the same compiled scene), and the small caustic SPPM."""
    import numpy as np

    from tpu_pbrt_torch.chaos import CHAOS
    from tpu_pbrt_torch.kernels import LAUNCHES, reset_launches
    from tpu_pbrt_torch.scene.api import Options, compile_file
    from tpu_pbrt_torch.scenes import compile_api, make_caustic_like, make_killeroo_like
    from tpu_pbrt_torch.utils.clock import VirtualClock

    out = {"rank": mesh.rank, "device": str(mesh.device)}
    t0 = time.perf_counter()
    scene, integ = compile_api(make_killeroo_like(res=128, spp=256, maxdepth=5,
                                                  device=mesh.device))
    out["compile_s"] = time.perf_counter() - t0
    mesh.barrier()
    reset_launches()
    res = integ.render(scene, mesh=mesh)
    out["launches"] = dict(LAUNCHES)
    out["main"] = (res.image, res.rays_traced, res.seconds, res.mray_per_sec, res.stats)
    del scene, integ

    scene, integ = compile_file(serve_path, Options(quiet=True), device=mesh.device)
    integ.clock = VirtualClock()
    clean = integ.render(scene, mesh=mesh, chunk=MESH_SERVE_CHUNK)
    CHAOS.install("mesh:lost@chunk=1")
    try:
        lost = integ.render(scene, mesh=mesh, chunk=MESH_SERVE_CHUNK, checkpoint_every=1,
                            checkpoint_path=os.path.join(ckpt_dir, "lost.npz"))
    finally:
        CHAOS.clear()
    out["recovery"] = {
        "chunks": clean.stats["chunks"],
        "equal": bool(np.array_equal(clean.image, lost.image)
                      and clean.rays_traced == lost.rays_traced),
        "recovery": lost.stats.get("recovery"), "rays": clean.rays_traced}
    out["serve_solo"] = ([t.cpu() for t in clean.film_state], clean.image, clean.rays_traced,
                         clean.mray_per_sec)
    out["serve"] = _mesh_serve(mesh, scene, integ, os.path.join(ckpt_dir, f"spool{mesh.rank}"))
    del scene, integ

    scene, integ = compile_api(make_caustic_like(res=MESH_SPPM_RES, spp=1, integrator="sppm",
                                                 params=SPPM_SMALL, device=mesh.device))
    sp = integ.render(scene, mesh=mesh)
    out["sppm"] = (sp.image, sp.rays_traced, sp.stats["mesh"])
    return out


def phase_mesh(solo=None):
    """Several ranks on the main path (see the module doc, phase 15).
    `solo` is phase 3's pool render (rendered here when phase 3 did not
    run). Returns ({kernel: the mesh render's launches per rank, with the
    layout and Mray/s}, the `serve --mesh` daemon's check): the caller
    runs the check, beside a later phase in a full run."""
    import tempfile

    import numpy as np
    import torch

    from tpu_pbrt_torch.parallel.mesh import default_backend, launch
    from tpu_pbrt_torch.scenes import (
        compile_api,
        killeroo_file,
        make_caustic_like,
        make_killeroo_like,
    )

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    n, share = (min(cards, 4), False) if cards >= 2 else (2, True)
    backend = default_backend("cuda", share)
    serve_path = killeroo_file(128, MESH_SERVE_SPP)  # written once, before the ranks read it
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as ckpt:
        results = launch(_mesh_rank, n, args=(ckpt, serve_path), device="cuda",
                         share_device=share, timeout=900)
    r0 = results[0]
    img, rays, secs, mray, stats = r0["main"]
    m = stats["mesh"]
    compile_s = ", ".join(f"{r['compile_s']:.2f}" for r in results)
    log(f"[mesh] {m['layout']}: backend {m['backend']} (asked {backend}), "
        f"{cards} card(s) visible; the ranks compiled the scene in {compile_s} s")
    for r in results[1:]:
        if r["main"][1] != rays or not np.array_equal(r["main"][0], img):
            raise SmokeFailure(f"mesh: rank {r['rank']}'s film or rays differ from rank 0's")
    if solo is None:
        scene, integ = compile_api(make_killeroo_like(res=128, spp=256, maxdepth=5,
                                                      device="cuda"))
        solo = integ.render(scene)
        del scene, integ
    ref = np.load(REF_IMAGE)["image"]
    mse = float(np.mean((img.astype(np.float64) - ref) ** 2))
    close = np.isclose(img, solo.image, rtol=1e-4, atol=1e-5)
    spread = stats["telemetry"]["wave_spread"]
    red, wait = m["allreduce_ms"], m["wait_ms"]
    log(f"[mesh] killeroo pool 128x128x256 over {n} ranks: {rays} rays (solo "
        f"{solo.rays_traced}), image mean {img.mean():.6f} (solo {solo.image.mean():.6f}), "
        f"pixel channels outside rtol 1e-4 / atol 1e-5 of the solo render: "
        f"{int((~close).sum())}, max |diff| {np.abs(img - solo.image).max():.3e}; MSE vs ref "
        f"{mse:.3e} (bar {MSE_BAR:g})")
    log(f"[mesh] waves per rank {spread['per_device_waves']} (n_waves {stats['n_waves']}, "
        f"rel_spread {spread['rel_spread']:.4f}); {stats['chunks']} chunks of {stats['chunk']} "
        f"({m['chunk_per_rank']} a rank); all-reduce ms per chunk {red} (mean "
        f"{sum(red) / max(len(red), 1):.3f}), rank 0's wait for the slowest rank before it, ms "
        f"{wait}")
    for r in results:
        _, _, rs, rm, _ = r["main"]
        log(f"[mesh] rank {r['rank']} on {r['device']}: {rs:.3f} s, {rm:.4f} Mray/s, launches "
            f"{json.dumps(r['launches'])}")
    note = " (two ranks share one card: this measures no scaling)" if share else ""
    log(f"[mesh] Mray/s {mray:.4f} over {n} ranks beside the solo render's "
        f"{solo.mray_per_sec:.4f}{note}; {card_line()}")
    if (rays != solo.rays_traced or not close.all() or mse > MSE_BAR
            or not np.isfinite(img).all()):
        raise SmokeFailure(f"mesh: rays {rays} vs {solo.rays_traced}, {int((~close).sum())} "
                           f"channels outside the tolerance, MSE {mse:.3e}")
    if len(spread["per_device_waves"]) != n or sum(spread["per_device_waves"]) != stats["n_waves"]:
        raise SmokeFailure(f"mesh: wave spread {spread} over {n} ranks")
    for r in results:
        for name, k in r["launches"].items():
            if k <= 0:
                raise SmokeFailure(f"mesh: rank {r['rank']} never launched {name}")

    rec = [r["recovery"] for r in results]
    log(f"[mesh] mesh:lost@chunk=1 at 128x128x{MESH_SERVE_SPP} ({rec[0]['chunks']} chunks of "
        f"{MESH_SERVE_CHUNK}): bit-identical to the undisturbed mesh render on every rank "
        f"{all(x['equal'] for x in rec)}, recovery {rec[0]['recovery']}, rays {rec[0]['rays']}")
    if not all(x["equal"] and (x["recovery"] or {}).get("rollbacks") == 1 for x in rec):
        raise SmokeFailure(f"mesh: the mesh:lost recovery is not bit-identical: {rec}")
    served, daemon = _mesh_served_report(results, n, share, serve_path)

    sp_img, sp_rays, sp_m = r0["sppm"]
    scene, integ = compile_api(make_caustic_like(res=MESH_SPPM_RES, spp=1, integrator="sppm",
                                                 params=SPPM_SMALL, device="cuda"))
    ssp = integ.render(scene)
    del scene, integ
    rel = np.abs(sp_img - ssp.image) / np.maximum(np.abs(ssp.image), 1e-3)
    log(f"[mesh] caustic sppm {MESH_SPPM_RES}x{MESH_SPPM_RES} (2 x 4,096 photons) over {n} "
        f"ranks: rays {sp_rays} (solo {ssp.rays_traced}), max rel {rel.max():.3e}, mean rel "
        f"{rel.mean():.3e} (bars 2e-2, 2e-3), collectives {sp_m['collective_ms']} ms")
    if (sp_rays != ssp.rays_traced or rel.max() >= 2e-2 or rel.mean() >= 2e-3
            or any(not np.array_equal(r["sppm"][0], sp_img) for r in results)):
        raise SmokeFailure("mesh: the SPPM over the mesh differs from the solo SPPM")
    log(f"[mesh] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return {name: {"ranks": n, "backend": m["backend"], "layout": m["layout"],
                   "launches_per_rank": [r["launches"][name] for r in results],
                   "mray_per_sec": mray, "solo_mray_per_sec": solo.mray_per_sec,
                   "allreduce_ms_mean": sum(red) / max(len(red), 1),
                   "servemesh": dict(served, launches_per_rank=[
                       r["serve"]["launches"][name] for r in results])}
            for name in r0["launches"]}, daemon


def _mesh_served_report(results, n, share, path):
    """`[mesh]`'s serving lines: the two served jobs against the mesh solo
    render at 128x128x64 (films and rays equal), the mesh:lost that fired
    during them, each job's Mray/s beside the solo's, the queue-wait p90,
    the decision broadcasts and each rank's launches. Returns the numbers
    for the kernels line and the check of the JSONL daemon `python -m
    tpu_pbrt_torch.serve --mesh 2` on a session whose result must equal
    the mesh solo render (the caller runs it)."""
    import tempfile

    import numpy as np
    import torch

    from tpu_pbrt_torch.utils.imageio import read_pfm

    r0 = results[0]
    film, image, rays, solo_mray = r0["serve_solo"]
    sv = r0["serve"]
    for j, job in sv["jobs"].items():
        same = job["rays"] == rays and all(torch.equal(a, b) for a, b in zip(job["film"], film))
        if not same:
            raise SmokeFailure(f"mesh: served job {j}: film or rays ({job['rays']}) differ from "
                               f"the mesh solo render ({rays})")
    fired = {f["fault"]: f["fired"] for f in sv["fired"]}
    recov = {j: job["recovery"] for j, job in sv["jobs"].items()}
    pre = {j: job["preemptions"] for j, job in sv["jobs"].items()}
    if sum(fired.values()) != 1 or not any(recov.values()) or sorted(pre.values()) != [0, 1]:
        raise SmokeFailure(f"mesh: served: fired {fired}, recovery {recov}, preemptions {pre}")
    mray = {j: round(job["mray"], 4) for j, job in sv["jobs"].items()}
    dec = sv["mesh"]["decision"]
    log(f"[mesh] served over {n} ranks, 128x128x{MESH_SERVE_SPP} in slices of "
        f"{MESH_SERVE_CHUNK}: schedule {sv['schedule']}, the second job parked at chunk "
        f"{sv['parked_at']} and resumed, mesh:lost fired {fired} with recovery {recov}; both "
        f"films bit-identical to the mesh solo render, rays {rays}; Mray/s {json.dumps(mray)} "
        f"beside the mesh solo's {solo_mray:.4f}; queue-wait p90 {sv['p90']:.4f} s over "
        f"{sv['n_wait']} waits; {dec['n']} decision records, {dec['mean_ms']} ms each; "
        f"per slice wait {sv['mesh']['wait']['mean_ms']} ms, all-reduce "
        f"{sv['mesh']['all_reduce']['mean_ms']} ms; launches per rank "
        f"{[r['serve']['launches'] for r in results]}")
    for r in results:
        if min(r["serve"]["launches"].values()) <= 0:
            raise SmokeFailure(f"mesh: served: rank {r['rank']} never launched a kernel")

    served = {"ranks": n, "spp": MESH_SERVE_SPP, "slice": MESH_SERVE_CHUNK,
              "mray_per_sec_jobs": mray, "mray_per_sec_mesh_solo": solo_mray,
              "queue_wait_p90_s": sv["p90"], "decision_ms_mean": dec["mean_ms"]}

    def daemon():
        """`python -m tpu_pbrt_torch.serve --mesh n` on a JSONL session,
        its result held to the mesh solo render; returns its job's
        seconds."""
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_servemesh_") as tmp:
            out = os.path.join(tmp, "mesh.pfm")
            argv = [sys.executable, "-m", "tpu_pbrt_torch.serve", "--mesh", str(n), "--quiet",
                    "--spool", os.path.join(tmp, "spool")]
            answers, events, rc = _jsonl_session(argv, path, out, "serve --mesh",
                                                 chunk=MESH_SERVE_CHUNK)
            got = read_pfm(out)
        if (rc != 0 or answers["result"]["rays"] != rays or not np.array_equal(got, image)
                or not answers["health"]["ok"]):
            raise SmokeFailure(f"mesh: `serve --mesh {n}`: rc {rc}, rays "
                               f"{answers['result']['rays']} (solo {rays}), image equal "
                               f"{np.array_equal(got, image)}")
        layout = "ranks sharing cuda:0" if share else "a card a rank"
        log(f"[mesh] daemon `serve --mesh {n}` ({layout}): result equal to the mesh solo "
            f"render ({answers['result']['rays']} rays, {answers['result']['seconds']} s), "
            f"{answers['metrics']['lines']} metric lines, health ok, exit {rc}; "
            f"{time.perf_counter() - t0:.1f} s with its spawn and compile")
        return answers["result"]["seconds"]

    return served, daemon

# -- phase 4 -------------------------------------------------------------------

def crown_scene():
    """The crown at 512x512 (CROWN_SPP) on the card, with its sizes."""
    import numpy as np
    import torch

    from tpu_pbrt_torch.scenes import compile_api, crown_sky, make_crown_like

    t0 = time.perf_counter()
    scene, integ = compile_api(make_crown_like(res=512, spp=CROWN_SPP, maxdepth=5, device="cuda"))
    secs = time.perf_counter() - t0
    tp = scene.dev["tstream"]
    log(f"[scene] crown: {scene.n_tris} triangles, {tp.n_treelets} treelets of {tp.leaf_tris}, "
        f"{tp.top.child_bmin.shape[0]} top-tree nodes, featT {tuple(tp.featT.shape)} "
        f"{tp.featT.numel() * 4 / 1e6:.1f} MB, {scene.n_lights} light(s), compiled in {secs:.2f} s")
    env = scene.dev.get("envmap")
    sky = torch.from_numpy(crown_sky()).to(env.device) if env is not None else None
    if env is None or tuple(env.shape) != (64, 128, 3) or not torch.equal(env, sky):
        raise SmokeFailure("crown: the environment map is not the 64x128 sky "
                           f"(got {None if env is None else tuple(env.shape)})")
    mats = np.unique(scene.dev["mat"]["type"].cpu().numpy()).tolist()
    log(f"[scene] crown: envmap 64x128 sky, max {float(env.max()):.2f} (the sun), "
        f"mean {float(env.mean()):.4f}; materials {mats}")
    return scene, integ


def phase_crown_check(scene, integ):
    """Both kernels, exact, at the crown's pool wave (2^19 rays, packed
    flush key) and its middle chunk's first fixed-batch camera wave (2^20
    rays, unpacked key: chunk 0 holds the frame's top rows, nearly all
    sky, whose one flush comes after the last expand step); returns
    (numbers, the camera wave's rays)."""
    n_chunks = integ.prepare_chunks(scene).n_chunks
    return _check_waves(scene, integ, "crown ", fixed_chunk=n_chunks // 2, exact=True,
                        fixed_packed=False)


def phase_branch(scene, rays):
    """The camera wave's rays as one 2^20-ray wave (the flush's unpacked
    stable sort) and as two 2^19-ray waves (the packed key): per-ray
    (t, prim) bit-identical, no pair dropped."""
    import torch

    from tpu_pbrt_torch.accel import stream

    tp = scene.dev["tstream"]
    o, d = rays
    R = o.shape[0]
    t_max = torch.full((R,), float("inf"), device=o.device)
    t0 = time.perf_counter()
    whole = stream._traverse(tp, o, d, t_max, False)
    t_w, p_w, drop_w = whole.rayF[6].clone(), whole.prim.clone(), int(whole.n_drop)
    del whole
    t1 = time.perf_counter()
    h = R // 2
    t_h, p_h, drop_h = [], [], 0
    for sl in (slice(0, h), slice(h, R)):
        part = stream._traverse(tp, o[sl].contiguous(), d[sl].contiguous(), t_max[sl], False)
        t_h.append(part.rayF[6].clone())
        p_h.append(part.prim.clone())
        drop_h += int(part.n_drop)
        del part
    t2 = time.perf_counter()
    t_h, p_h = torch.cat(t_h), torch.cat(p_h)
    same_t = torch.equal(t_w.view(torch.int32), t_h.view(torch.int32))
    same_p = torch.equal(p_w, p_h)
    log(f"[branch] {R} rays, {tp.n_treelets} treelets: one wave of {R} (unpacked key) "
        f"{t1 - t0:.2f} s vs two of {h} (packed) {t2 - t1:.2f} s; hits {int((p_w >= 0).sum())}; "
        f"t bit-identical {same_t}, prim identical {same_p} "
        f"({int((p_w != p_h).sum())} differ); dropped {drop_w} / {drop_h}")
    if not (same_t and same_p) or drop_w or drop_h:
        raise SmokeFailure("branch: the unpacked and packed flush keys disagree")


def phase_crown_render(scene, integ):
    """The crown against the JAX CPU reference at 64x64x64 (pool: MSE bar;
    fixed batch: the same rays, images within the pool tolerance), then
    the 512x512 crown through the pool. Returns the launches of the 512
    render and of the two 64x64 renders."""
    import numpy as np

    from tpu_pbrt_torch.scenes import compile_api, make_crown_like

    ref = np.load(CROWN_REF)
    t0 = time.perf_counter()
    small, sinteg = compile_api(make_crown_like(res=64, spp=int(ref["spp"]),
                                                maxdepth=int(ref["maxdepth"]), device="cuda"))
    log(f"[render] crown 64x64: compiled in {time.perf_counter() - t0:.2f} s")
    sp, sp_l = _render_counted(sinteg, small, regen=True)
    img, want = sp.image, ref["image"]
    if img.shape != want.shape or not np.isfinite(img).all():
        raise SmokeFailure(f"crown: image shape {img.shape} / finite {np.isfinite(img).all()}")
    mse = float(np.mean((img.astype(np.float64) - want) ** 2))
    _log_render(f"crown pool 64x64 {int(ref['spp'])} spp", sp, sp_l)
    ref_rays = int(ref["rays_traced"])
    log(f"[render] crown pool: image mean {img.mean():.6f} (JAX CPU {want.mean():.6f}), MSE "
        f"{mse:.3e} (bar {MSE_BAR:g}), max |diff| {np.abs(img - want).max():.3e}; rays "
        f"{sp.rays_traced} (JAX CPU {ref_rays}, {sp.rays_traced - ref_rays} more), waves "
        f"{sp.stats['n_waves']} (JAX CPU {int(ref['n_waves'])}), dropped {sp.stats['n_drop']}")
    if mse > MSE_BAR or sp.stats["n_drop"]:
        raise SmokeFailure(f"crown: MSE {mse:.3e} > {MSE_BAR:g} or {sp.stats['n_drop']} "
                           "pairs dropped")
    sf, sf_l = _render_counted(sinteg, small, regen=False)
    _log_render(f"crown fixed 64x64 {int(ref['spp'])} spp", sf, sf_l)
    diff = np.abs(sp.image - sf.image)
    close = np.isclose(sp.image, sf.image, rtol=1e-4, atol=1e-5)
    log(f"[render] crown pool vs fixed: rays {sp.rays_traced} / {sf.rays_traced}, max |diff| "
        f"{diff.max():.3e}, pixel channels outside rtol 1e-4 / atol 1e-5: {int((~close).sum())}, "
        f"dropped {sf.stats['n_drop']}")
    if sp.rays_traced != sf.rays_traced or not close.all() or sf.stats["n_drop"]:
        raise SmokeFailure("crown: the pool and the fixed batch disagree at 64x64")
    del small, sinteg

    res, launches = _render_counted(integ, scene, regen=True)
    _log_render(f"crown pool 512x512 {CROWN_SPP} spp", res, launches)
    img = res.image
    st = res.stats
    log(f"[render] crown 512x512: {res.mray_per_sec:.4f} Mray/s, waves {st['n_waves']}, "
        f"occupancy {st['mean_wave_occupancy']:.4f}, host reads per wave "
        f"{st['host_reads_per_wave_mean']:.2f} + {st['loop_host_reads_per_wave']:.2f}, "
        f"dropped {st['n_drop']}, image mean {img.mean():.6f}")
    if not np.isfinite(img).all() or not img.mean() > 1e-6 or res.stats["n_drop"]:
        raise SmokeFailure("crown 512x512: the image is not a finite lit render, or pairs dropped")
    return launches, sp_l, sf_l, res


# -- phase 5 -------------------------------------------------------------------

def _capture_first_wave(run, any_hit: bool, label: str, when=lambda: True):
    """Run `run()` up to the end of its first traversal wave of the given
    mode (any-hit or closest-hit) that starts while `when()` holds,
    recording that wave's first expand step after its first flush (in an
    any-hit wave, rays answered by that flush are culled) and the first
    flush chunk after that expand (its pairs passed the filters of the
    steps before). A wave whose only flush comes after its last expand
    step has neither: its first of each is taken then. Returns
    (captures, the wave's stats: rays, live, hits, finite t_max,
    expand steps, flush chunks)."""
    import torch

    from tpu_pbrt_torch.accel import stream

    cap = {}
    state = {"in_wave": False, "flushes": 0, "expands": 0}
    real_trav, real_expand, real_flush = stream._traverse, stream.expand, stream.flush_chunk

    def traverse(tp, o, d, t_max, mode, time=None):
        if mode != any_hit or state["in_wave"] or not when():
            return real_trav(tp, o, d, t_max, mode, time=time)
        live = t_max > 0
        state.update(in_wave=True, rays=o.shape[0], live=int(live.sum()),
                     finite=bool(torch.isfinite(t_max[live]).all()))
        s = real_trav(tp, o, d, t_max, mode, time=time)
        state["hits"] = int((s.prim >= 0).sum())
        raise _Captured

    def expand_hook(*args):
        if state["in_wave"]:
            state["expands"] += 1
            if bool(args[7]) != any_hit:
                raise SmokeFailure(f"{label}: the captured wave's expand has the wrong mode")
            if state["expands"] == 1:
                cap["first_expand"] = _clone(args)
            elif state["flushes"] and "expand" not in cap:
                cap["expand"] = _clone(args)
        return real_expand(*args)

    def flush_hook(*args):
        if state["in_wave"]:
            state["flushes"] += 1
            if state["flushes"] == 1:
                cap["first_flush"] = _clone(args)
            elif "expand" in cap and "flush" not in cap:
                cap["flush"] = _clone(args)
        return real_flush(*args)

    stream._traverse, stream.expand, stream.flush_chunk = traverse, expand_hook, flush_hook
    try:
        run()
    except _Captured:
        pass
    finally:
        stream._traverse, stream.expand, stream.flush_chunk = real_trav, real_expand, real_flush
    if {"first_flush", "first_expand"} - set(cap):
        raise SmokeFailure(f"{label}: could not capture the wave's kernel inputs ({state})")
    state["expand_after_flush"] = "expand" in cap
    state["flush_after_expand"] = "flush" in cap
    for k in ("expand", "flush"):
        first = cap.pop(f"first_{k}")
        cap.setdefault(k, first)
    return cap, state


def _capture_anyhit_wave(scene, integ):
    """The first any-hit (shadow) wave of the render's first chunk."""
    plan = integ.prepare_chunks(scene)
    return _capture_first_wave(lambda: plan.dispatch(scene.film.init_state(scene.device), 0),
                               True, "direct")


def _killeroo_direct(which, res, spp):
    """The full killeroo under `directlighting` or `ao` on the card, built
    by the scene function that wrote the JAX CPU references
    (tests/torch_golden/make_direct_reference.py)."""
    if GOLDEN not in sys.path:
        sys.path.insert(0, GOLDEN)
    from make_direct_reference import killeroo_api

    from tpu_pbrt_torch import scenes

    return scenes.compile_api(killeroo_api(scenes, which, res=res, spp=spp, device="cuda"))


def _cornell_cli():
    """scenes/cornell-box.pbrt through the CLI in a subprocess on the card:
    (image, rays, seconds)."""
    import shutil
    import tempfile

    from tpu_pbrt_torch.parallel.checkpoint import load_checkpoint
    from tpu_pbrt_torch.utils.imageio import read_pfm

    tmp = tempfile.mkdtemp(prefix="chip_smoke_direct_")
    try:
        cmd = [sys.executable, "-m", "tpu_pbrt_torch.main",
               os.path.join(HERE, "scenes", "cornell-box.pbrt"), "--quiet",
               "-o", os.path.join(tmp, "c.pfm"), "--checkpoint", os.path.join(tmp, "c.npz")]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        if r.returncode != 0:
            raise SmokeFailure(f"direct cli: exit {r.returncode}: {r.stderr[-2000:]}")
        rays = load_checkpoint(os.path.join(tmp, "c.npz"))[2]
        return read_pfm(os.path.join(tmp, "c.pfm")), rays, secs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _against(label, img, rays, ref, n_drop=0, tag="direct"):
    """MSE of a render against a JAX CPU reference, with the rays beside
    the reference's; fails past the bar, on a non-finite image or on a
    dropped pair."""
    import numpy as np

    want = ref["image"]
    if img.shape != want.shape or not np.isfinite(img).all():
        raise SmokeFailure(f"{label}: image shape {img.shape} / finite {np.isfinite(img).all()}")
    mse = float(np.mean((img.astype(np.float64) - want) ** 2))
    ref_rays = int(ref["rays_traced"])
    log(f"[{tag}] {label}: image mean {img.mean():.6f} (JAX CPU {want.mean():.6f}), MSE {mse:.3e} "
        f"(bar {MSE_BAR:g}), max |diff| {np.abs(img - want).max():.3e}; rays {rays} (JAX CPU "
        f"{ref_rays}, {rays - ref_rays:+d}), dropped {n_drop}")
    if mse > MSE_BAR or n_drop or not want.mean() > 0:
        raise SmokeFailure(f"{label}: MSE {mse:.3e} > {MSE_BAR:g} or {n_drop} pairs dropped")
    return mse


def phase_direct():
    """The direct-lighting family on the card (see the module doc, phase 5):
    the kernels on the any-hit wave and the timed render first, then the
    renders against the JAX CPU references. Returns {kernel: numbers at
    the any-hit wave, with the timed render's launches and Mray/s}."""
    import numpy as np

    scene, integ = _killeroo_direct("direct", DIRECT_RES, DIRECT_SPP)
    t0 = time.perf_counter()
    cap, wave = _capture_anyhit_wave(scene, integ)
    log(f"[direct] any-hit wave: the first shadow wave of chunk 0 ({wave['rays']} rays, "
        f"{wave['live']} live, {wave['hits']} occluded; {wave['expands']} expand steps, "
        f"{wave['flushes']} flush chunks; expand captured after a flush: "
        f"{wave['expand_after_flush']}, flush chunk after that expand: "
        f"{wave['flush_after_expand']}) in {time.perf_counter() - t0:.2f} s")
    count = scene.dev["tstream"].count
    out = {"flush_chunk": _flush_numbers(cap["flush"], count, "any-hit wave", exact=True),
           "expand": _expand_numbers(cap["expand"], "any-hit wave")}
    del cap
    res, launches = _render_counted(integ, scene, regen=False)
    _log_render(f"killeroo directlighting {DIRECT_RES}x{DIRECT_RES}x{DIRECT_SPP}", res, launches)
    anyhit = res.stats["wave_modes"]["any_hit"]
    log(f"[direct] killeroo directlighting {DIRECT_RES}x{DIRECT_RES}x{DIRECT_SPP}: "
        f"{res.mray_per_sec:.4f} Mray/s, {res.rays_traced} rays in {res.seconds:.3f} s; any-hit "
        f"waves {anyhit['waves']}: {anyhit['iters_per_wave_mean']:.2f} iterations, "
        f"{anyhit['host_reads_per_wave_mean']:.2f} host reads, "
        f"{anyhit['expand_calls_per_wave_mean']:.2f} expand and "
        f"{anyhit['flush_calls_per_wave_mean']:.2f} flush launches per wave; closest-hit "
        f"{json.dumps(res.stats['wave_modes']['closest_hit'])}")
    if not np.isfinite(res.image).all() or res.stats["n_drop"]:
        raise SmokeFailure("killeroo directlighting: non-finite image or pairs dropped")
    for name in out:
        out[name].update(launches=launches[name], mray_per_sec=res.mray_per_sec,
                         launches_anyhit=anyhit["expand_calls" if name == "expand"
                                                else "flush_calls"],
                         res=DIRECT_RES, spp=DIRECT_SPP)
    del scene, integ

    img, rays, secs = _cornell_cli()
    log(f"[direct] cornell-box.pbrt through the CLI: {img.shape[1]}x{img.shape[0]} "
        f"(16 spp), {secs:.1f} s in the subprocess")
    _against("cornell-box.pbrt directlighting 256x256x16", img, rays, np.load(CORNELL_REF))

    for which in ("direct", "ao"):
        scene, integ = _killeroo_direct(which, 64, 16)
        res, launches = _render_counted(integ, scene, regen=False)
        _log_render(f"killeroo {which} 64x64x16", res, launches)
        _against(f"killeroo {which} 64x64x16", res.image, res.rays_traced,
                 np.load(KILLEROO_DIRECT_REF.format(which)), res.stats["n_drop"])
        if not res.stats["wave_modes"].get("any_hit", {}).get("waves"):
            raise SmokeFailure(f"killeroo {which}: no any-hit wave was traced")
        del scene, integ
    return out


def phase_samplers():
    """Every sampler kind's draws on the card against the CPU port's, bit for
    bit, on a 2^20-item grid: int and per-lane salts, and the Sobol' film
    jitter."""
    from types import SimpleNamespace

    import torch

    from tpu_pbrt_torch.core import sampling
    from tpu_pbrt_torch.integrators.common import WavefrontIntegrator

    n, spp = 1 << 20, 12
    g = torch.Generator().manual_seed(5)
    px, py = torch.randint(0, 4096, (2, n), dtype=torch.int32, generator=g)
    s = torch.randint(0, spp, (n,), dtype=torch.int32, generator=g)
    salt = torch.randint(0, 400, (n,), dtype=torch.int32, generator=g)
    cpu = (px, py, s)
    gpu = tuple(x.cuda() for x in cpu)
    t0 = time.perf_counter()
    checked = 0
    for kind in ("random", "02", "stratified", "halton", "sobol"):
        for sl_c, sl_g in ((23, 23), (salt, salt.cuda())):
            for fn in (sampling.sample_1d, sampling.sample_2d):
                a = fn(kind, spp, *cpu, sl_c)
                b = fn(kind, spp, *gpu, sl_g)
                for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
                    checked += 1
                    if not torch.equal(x.view(torch.int32), y.cpu().view(torch.int32)):
                        raise SmokeFailure(f"samplers: {kind} {fn.__name__} differs on the card")
    self_ = SimpleNamespace(skind="sobol", _sobol_m=12)
    for x, y in zip(WavefrontIntegrator.film_jitter(self_, *cpu),
                    WavefrontIntegrator.film_jitter(self_, *gpu)):
        checked += 1
        if not torch.equal(x.view(torch.int32), y.cpu().view(torch.int32)):
            raise SmokeFailure("samplers: the Sobol' film jitter differs on the card")
    log(f"[samplers] {checked} draws of 2^20 items (random, 02, stratified, halton, sobol at "
        f"spp {spp}; int and per-lane salts; the Sobol' film jitter): the card's equal the CPU "
        f"port's bit for bit ({time.perf_counter() - t0:.1f} s)")
    # the fused multiply-add the port's arithmetic rounds with (xla_math.fma32:
    # torch.addcmul on the card, the f64 form on the CPU), with tensor and
    # Python-float operands
    from tpu_pbrt_torch.core.xla_math import fma32

    a, b, c = (torch.randn(n, generator=g) * torch.exp(2 * torch.randn(n, generator=g))
               for _ in range(3))
    cases = ((a, b, c), (a, b[:1], c), (a, 0.819955, c), (a, b, -0.35))
    for args in cases:
        want = fma32(*args)
        got = fma32(*(x.cuda() if torch.is_tensor(x) else x for x in args))
        if not torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)):
            raise SmokeFailure("samplers: fma32 on the card differs from the CPU's")
    from tpu_pbrt_torch.core.xla_math import sqrt as xla_sqrt

    x = torch.abs(a) + 1e-30  # normal f32 values: the CPU path flushes subnormals
    if not torch.equal(xla_sqrt(x.cuda()).cpu().view(torch.int32), xla_sqrt(x).view(torch.int32)):
        raise SmokeFailure("samplers: xla_math.sqrt on the card differs from the CPU's")
    log(f"[samplers] fma32 (torch.addcmul on the card): equal to the CPU's f64 form on "
        f"{len(cases)} x 2^20 triples, tensor and scalar operands; xla_math.sqrt (torch.sqrt "
        f"on the card) equal to the CPU's on 2^20 values")


# -- phase 6 -------------------------------------------------------------------

def _capture_walk_wave(scene, integ):
    """The first shadow-walk segment wave of the render's first chunk
    (volpath's unoccluded_tr: closest hit, t_max the light distance
    left)."""
    from tpu_pbrt_torch.integrators import volpath

    real_walk, in_walk = volpath.unoccluded_tr, [False]

    def walk(*args, **kw):
        in_walk[0] = True
        try:
            return real_walk(*args, **kw)
        finally:
            in_walk[0] = False

    plan = integ.prepare_chunks(scene)
    volpath.unoccluded_tr = walk
    try:
        cap, state = _capture_first_wave(
            lambda: plan.dispatch(scene.film.init_state(scene.device), 0), False, "cloud",
            when=lambda: in_walk[0])
    finally:
        volpath.unoccluded_tr = real_walk
    if not state["finite"]:
        raise SmokeFailure(f"cloud: the shadow-walk wave has no finite t_max ({state})")
    return cap, state


def _cloud(res, spp, device):
    from tpu_pbrt_torch.scenes import compile_api, make_cloud_like

    return compile_api(make_cloud_like(res=res, spp=spp, maxdepth=5, device=device))


def phase_cloud():
    """The cloud-class scene on the card (see the module doc, phase 6):
    the kernels on the first shadow-walk wave of the 256x256x16 chunk,
    then that render timed, the 64x64x16 render against the JAX CPU
    reference and the card against the CPU port at 32x32x16. Returns
    {kernel: numbers at the shadow-walk wave, with the timed render's
    launches and Mray/s}."""
    import numpy as np

    t0 = time.perf_counter()
    scene, integ = _cloud(CLOUD_RES, CLOUD_SPP, "cuda")
    tp = scene.dev["tstream"]
    log(f"[scene] cloud: {scene.n_tris} triangles, {tp.n_treelets} treelets of {tp.leaf_tris}, "
        f"{tp.top.child_bmin.shape[0]} top-tree nodes, {scene.n_lights} light rows, null "
        f"surfaces {scene.has_null_materials} (shadow walk of {integ.vis_segments} segments, "
        f"{integ.max_depth + 1 + integ.margin} iterations), compiled in "
        f"{time.perf_counter() - t0:.2f} s")
    if not (scene.has_null_materials and integ.vis_segments == 4 and integ.margin == 4):
        raise SmokeFailure("cloud: the container is not a null interface")
    t0 = time.perf_counter()
    cap, wave = _capture_walk_wave(scene, integ)
    log(f"[cloud] shadow-walk wave: segment 0 of chunk 0's first walk ({wave['rays']} rays, "
        f"{wave['live']} live, all with a finite t_max: {wave['finite']}; {wave['hits']} hit "
        f"before their light; {wave['expands']} expand steps, {wave['flushes']} flush chunks; "
        f"expand captured after a flush: {wave['expand_after_flush']}, flush chunk after that "
        f"expand: {wave['flush_after_expand']}) in {time.perf_counter() - t0:.2f} s")
    out = {"flush_chunk": _flush_numbers(cap["flush"], tp.count, "cloud shadow-walk wave",
                                         exact=True),
           "expand": _expand_numbers(cap["expand"], "cloud shadow-walk wave")}
    del cap
    res, launches = _render_counted(integ, scene, regen=False)
    _log_render(f"cloud volpath {CLOUD_RES}x{CLOUD_RES}x{CLOUD_SPP}", res, launches)
    closest = res.stats["wave_modes"]["closest_hit"]
    log(f"[cloud] {CLOUD_RES}x{CLOUD_RES}x{CLOUD_SPP}: {res.mray_per_sec:.4f} Mray/s, "
        f"{res.rays_traced} rays in {res.seconds:.3f} s; closest-hit waves {closest['waves']}: "
        f"{closest['iters_per_wave_mean']:.2f} iterations, "
        f"{closest['host_reads_per_wave_mean']:.2f} host reads, "
        f"{closest['expand_calls_per_wave_mean']:.2f} expand and "
        f"{closest['flush_calls_per_wave_mean']:.2f} flush launches per wave; loop host reads "
        f"{res.stats['loop_host_reads_per_wave'] * res.stats['waves']:.0f}")
    if not np.isfinite(res.image).all() or res.stats["n_drop"] or "any_hit" in res.stats[
            "wave_modes"]:
        raise SmokeFailure("cloud: non-finite image, pairs dropped or an any-hit wave traced")
    for name in out:
        out[name].update(launches=launches[name], mray_per_sec=res.mray_per_sec,
                         res=CLOUD_RES, spp=CLOUD_SPP)
    del scene, integ, res

    scene, integ = _cloud(64, 16, "cuda")
    res, launches = _render_counted(integ, scene, regen=False)
    _log_render("cloud volpath 64x64x16", res, launches)
    ref = np.load(CLOUD_REF)
    _against("cloud volpath 64x64x16", res.image, res.rays_traced, ref, res.stats["n_drop"],
             tag="cloud")
    del scene, integ

    # the card against the CPU port, as rendered and with Russian roulette
    # off (rrthreshold 0): the roulette's survivor scale leaves a one-ulp
    # edge that a second roll after a null crossing reads, so the two
    # devices' rounding of the transcendentals moves some paths there
    for res, spp, rr in ((32, 16, None), (16, 16, 0.0)):
        t0 = time.perf_counter()
        img = {}
        for device in ("cuda", "cpu"):
            scene, integ = _cloud(res, spp, device)
            if rr is not None:
                integ.rr_threshold = rr
            r = integ.render(scene)
            img[device] = (r.image, r.rays_traced)
        (a, ra), (b, rb) = img["cuda"], img["cpu"]
        diff = np.abs(a.astype(np.float64) - b).max(axis=-1)
        mse = float(np.mean((a.astype(np.float64) - b) ** 2))
        label = f"{res}x{res}x{spp}" + ("" if rr is None else ", Russian roulette off")
        log(f"[cloud] card vs CPU port at {label}: rays {ra} / {rb} ({ra - rb:+d}), MSE "
            f"{mse:.3e}, max |diff| {diff.max():.3e}, pixels off by > 1e-5: "
            f"{int((diff > 1e-5).sum())} of {diff.size} ({time.perf_counter() - t0:.1f} s with "
            f"the CPU render)")
        if mse > MSE_BAR or not np.isfinite(a).all():
            raise SmokeFailure(f"cloud: the card and the CPU port differ by MSE {mse:.3e}")
    return out


# -- phase 7 -------------------------------------------------------------------

def _caustic(res, spp, integrator, params, device):
    from tpu_pbrt_torch.scenes import compile_api, make_caustic_like

    return compile_api(make_caustic_like(res=res, spp=spp, maxdepth=5, integrator=integrator,
                                         params=params, device=device))


def _caustic_cases():
    """make_caustic_reference.py's cases: {integrator: (res, spp, params, file)}."""
    if GOLDEN not in sys.path:
        sys.path.insert(0, GOLDEN)
    import make_caustic_reference as mcr

    return {k: (*v[:3], mcr.out_path(k)) for k, v in mcr.CASES.items()}


def _wave_line(tag, label, wave):
    log(f"[{tag}] {label}: {wave['rays']} rays, {wave['live']} live, finite t_max on every live "
        f"ray: {wave['finite']}; {wave['hits']} hit; {wave['expands']} expand steps, "
        f"{wave['flushes']} flush chunks; expand captured after a flush: "
        f"{wave['expand_after_flush']}, flush chunk after that expand: "
        f"{wave['flush_after_expand']}")


def _modes_line(tag, label, res):
    st = res.stats
    parts = []
    for mode, m in st["wave_modes"].items():
        parts.append(f"{mode} {m['waves']} waves, {m['iters_per_wave_mean']:.2f} iterations, "
                     f"{m['expand_calls_per_wave_mean']:.2f} expand and "
                     f"{m['flush_calls_per_wave_mean']:.2f} flush launches per wave")
    log(f"[{tag}] {label}: {res.mray_per_sec:.4f} Mray/s, {res.rays_traced} rays in "
        f"{res.seconds:.3f} s; waves {st['waves']}: {'; '.join(parts)}")


def _log_loop_render(label, res, launches):
    """An sppm or mlt render (its own iteration loop): time, rays, Mray/s,
    waves and launches, and its stats."""
    log(f"[render] {label}: {res.seconds:.3f} s, {res.rays_traced} rays, "
        f"{res.mray_per_sec:.4f} Mray/s, traversal waves {res.stats['waves']}, launches "
        f"{json.dumps(launches)}")
    log(f"[render] {label}: stats {json.dumps(res.stats)}")


def phase_caustic():
    """The light-transport integrators on the caustic-glass-class scene (see
    the module doc, phase 7). Returns {kernel: {"connection": numbers at
    BDPT's connection wave, "photon": at SPPM's first photon wave}, with
    the timed renders' launches and Mray/s}."""
    import numpy as np
    import torch

    cases = _caustic_cases()
    t0 = time.perf_counter()
    scene, integ = _caustic(CAUSTIC_RES, CAUSTIC_SPP, "bdpt", "", "cuda")
    tp = scene.dev["tstream"]
    n_k = integ.max_depth * 4
    log(f"[scene] caustic: {scene.n_tris} triangles, {tp.n_treelets} treelets of "
        f"{tp.leaf_tris}, {tp.top.child_bmin.shape[0]} top-tree nodes, {scene.n_lights} light "
        f"rows, materials {np.unique(scene.dev['mat']['type'].cpu().numpy()).tolist()}, "
        f"compiled in {time.perf_counter() - t0:.2f} s; bdpt maxdepth {integ.max_depth}: "
        f"{n_k} connection strategies")
    count = tp.count

    # [check] BDPT's fused connection wave (any hit, finite t_max)
    plan = integ.prepare_chunks(scene)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cap, wave = _capture_first_wave(
        lambda: plan.dispatch(scene.film.init_state(scene.device), 0), True, "caustic bdpt")
    _wave_line("caustic", f"bdpt connection wave of chunk 0 ({plan.chunk} camera rays x {n_k} "
               f"strategies; captured in {time.perf_counter() - t0:.2f} s, peak device memory "
               f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)", wave)
    if wave["rays"] != n_k * plan.chunk or not wave["finite"]:
        raise SmokeFailure(f"caustic: the connection wave is not {n_k} x {plan.chunk} rays "
                           "with a finite t_max")
    out = {"flush_chunk": {"connection": _flush_numbers(cap["flush"], count,
                                                        "caustic connection wave", exact=True)},
           "expand": {"connection": _expand_numbers(cap["expand"], "caustic connection wave")}}
    del cap
    torch.cuda.empty_cache()

    # [render] BDPT timed at full size
    res, launches = _render_counted(integ, scene, regen=False)
    _log_render(f"caustic bdpt {CAUSTIC_RES}x{CAUSTIC_RES}x{CAUSTIC_SPP}", res, launches)
    _modes_line("caustic", f"bdpt {CAUSTIC_RES}x{CAUSTIC_RES}x{CAUSTIC_SPP}", res)
    if not np.isfinite(res.image).all() or res.stats["n_drop"] or not res.image.mean() > 0:
        raise SmokeFailure("caustic bdpt: non-finite or black image, or pairs dropped")
    for name in out:
        out[name]["connection"].update(launches=launches[name], mray_per_sec=res.mray_per_sec,
                                       res=CAUSTIC_RES, spp=CAUSTIC_SPP)
    del scene, integ, res, plan
    torch.cuda.empty_cache()

    # [check] SPPM's first photon wave (closest hit, rays leaving the lights)
    scene, integ = _caustic(SPPM_TIMED[0], 1, "sppm", SPPM_TIMED[1], "cuda")
    n_ph = integ.photons_per_iter
    count = scene.dev["tstream"].count
    t0 = time.perf_counter()
    cap, wave = _capture_first_wave(lambda: integ._photon_pass(scene.dev, n_ph, 0), False,
                                    "caustic sppm")
    _wave_line("caustic", f"sppm photon wave 0 ({n_ph} photons; captured in "
               f"{time.perf_counter() - t0:.2f} s)", wave)
    if wave["rays"] != n_ph:
        raise SmokeFailure("caustic: the photon wave does not hold one ray per photon")
    out["flush_chunk"]["photon"] = _flush_numbers(cap["flush"], count, "caustic photon wave",
                                                  exact=True)
    out["expand"]["photon"] = _expand_numbers(cap["expand"], "caustic photon wave")
    del cap
    res, launches = _render_counted(integ, scene, regen=False)
    _log_loop_render(f"caustic sppm {SPPM_TIMED[0]}x{SPPM_TIMED[0]} ({SPPM_TIMED[1]})", res,
                     launches)
    _modes_line("caustic", f"sppm {SPPM_TIMED[0]}x{SPPM_TIMED[0]}", res)
    if not np.isfinite(res.image).all() or res.stats["n_drop"] or res.stats["photons_dropped"]:
        raise SmokeFailure("caustic sppm: non-finite image or photons dropped")
    for name in out:
        out[name]["photon"].update(launches=launches[name], mray_per_sec=res.mray_per_sec,
                                   res=SPPM_TIMED[0])
    del scene, integ, res
    torch.cuda.empty_cache()

    # [render] MLT timed, with a chain count that fills the card
    scene, integ = _caustic(MLT_TIMED[0], 1, "mlt", MLT_TIMED[1], "cuda")
    res, launches = _render_counted(integ, scene, regen=False)
    _log_loop_render(f"caustic mlt {MLT_TIMED[0]}x{MLT_TIMED[0]} ({MLT_TIMED[1]})", res, launches)
    _modes_line("caustic", f"mlt {MLT_TIMED[0]}x{MLT_TIMED[0]} ({res.stats['chains']} chains, "
                f"{res.stats['steps']} steps, acceptance {res.stats['acceptance']:.4f})", res)
    if not np.isfinite(res.image).all() or res.stats["n_drop"] or not res.image.mean() > 0:
        raise SmokeFailure("caustic mlt: non-finite or black image, or pairs dropped")
    for name in out:
        out[name]["mlt_launches"] = launches[name]
        out[name]["mlt_mray_per_sec"] = res.mray_per_sec
    del scene, integ, res
    torch.cuda.empty_cache()

    # [render] against the JAX CPU references
    for integrator, (r_res, r_spp, r_params, path) in cases.items():
        ref = np.load(path)
        scene, integ = _caustic(r_res, r_spp, integrator, r_params, "cuda")
        res, launches = _render_counted(integ, scene, regen=False)
        label = f"caustic {integrator} {r_res}x{r_res} (JAX CPU reference)"
        (_log_render if integrator == "bdpt" else _log_loop_render)(label, res, launches)
        if integrator != "mlt":
            _against(label, res.image, res.rays_traced, ref, res.stats["n_drop"], tag="caustic")
        else:
            # one accept that flips reroutes a chain for good: the chains on
            # the card and in the reference part ways, and the image is held
            # by its mean
            img, want = res.image, ref["image"]
            mse = float(np.mean((img.astype(np.float64) - want) ** 2))
            rel = abs(float(img.mean()) - float(want.mean())) / float(want.mean())
            log(f"[caustic] {label}: image mean {img.mean():.6f} (JAX CPU {want.mean():.6f}, "
                f"{rel:.4%} apart, bar {MLT_MEAN_BAR:.0%}), per-pixel MSE {mse:.3e}, max |diff| "
                f"{np.abs(img - want).max():.3e}; rays {res.rays_traced} (JAX CPU "
                f"{int(ref['rays_traced'])}); acceptance {res.stats['acceptance']:.4f}, b "
                f"{res.stats['b']:.6f} (JAX CPU {json.loads(str(ref['stats']))})")
            if rel > MLT_MEAN_BAR or not np.isfinite(img).all() or res.stats["n_drop"]:
                raise SmokeFailure(f"caustic mlt: image mean {rel:.4%} from the reference")
        del scene, integ, res

    # [render] the card against the CPU port
    for integrator, res_, spp, params in (("bdpt", 16, 4, ""), ("sppm", 16, 1, SPPM_SMALL)):
        t0 = time.perf_counter()
        img = {}
        for device in ("cuda", "cpu"):
            scene, integ = _caustic(res_, spp, integrator, params, device)
            r = integ.render(scene)
            img[device] = (r.image, r.rays_traced)
        (a, ra), (b, rb) = img["cuda"], img["cpu"]
        diff = np.abs(a.astype(np.float64) - b).max(axis=-1)
        mse = float(np.mean((a.astype(np.float64) - b) ** 2))
        log(f"[caustic] card vs CPU port, {integrator} {res_}x{res_}: rays {ra} / {rb} "
            f"({ra - rb:+d}), MSE {mse:.3e}, max |diff| {diff.max():.3e}, pixels off by > 1e-5: "
            f"{int((diff > 1e-5).sum())} of {diff.size} ({time.perf_counter() - t0:.1f} s with "
            f"the CPU render)")
        if mse > MSE_BAR or not np.isfinite(a).all():
            raise SmokeFailure(f"caustic {integrator}: the card and the CPU port differ by MSE "
                               f"{mse:.3e}")
    return out


# -- phase 8 -------------------------------------------------------------------

def _breadth(res, spp, camera, filt, device, **kw):
    from tpu_pbrt_torch.scenes import compile_api, make_breadth_like

    return compile_api(make_breadth_like(res, spp, camera=camera, filter=filt, device=device,
                                         **kw))


def _vignetting(scene, integ, cpu_scene, cpu_integ):
    """The realistic camera's rays for every work item of the render on
    the card and on the CPU port: the vignetting masks (weight > 0) must
    be equal. Returns (lanes, vignetted on the card, on the CPU, masks
    differing, max |o| / |d| difference over the passing lanes)."""
    import torch

    out = []
    for sc, ig in ((scene, integ), (cpu_scene, cpu_integ)):
        x0, x1, y0, y1 = sc.film.sample_bounds()
        npix = (x1 - x0) * (y1 - y0)
        k = torch.arange(npix * sc.sampler.spp, dtype=torch.int32, device=sc.device)
        valid, *_, o, d, wt = ig.work_to_rays(sc.camera, sc.sampler.spp, x0, y0, x1 - x0, npix,
                                              0, 0, k)
        out.append((wt.cpu() > 0, o.cpu(), d.cpu()))
    (ma, oa, da), (mb, ob, db) = out
    both = ma & mb
    return (ma.numel(), int((~ma).sum()), int((~mb).sum()), int((ma != mb).sum()),
            float((oa - ob)[both].abs().max()), float((da - db)[both].abs().max()))


def phase_breadth():
    """Scene breadth on the card (see the module doc, phase 8): the kernels
    on the 512x512x8 render's pool and fixed waves, that render timed
    through both, the 64x64x16 perspective and realistic renders against
    the JAX CPU references, the realistic camera's vignetting against the
    CPU port, and the orthographic and environment cameras against the
    CPU port. Returns {kernel: numbers at the pool wave (the fixed wave's
    under "at_fixed_wave"), with the timed renders' launches and Mray/s}."""
    import numpy as np
    import torch

    from tpu_pbrt_torch.scenes import BREADTH_SMALL

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    scene, integ = _breadth(BREADTH_RES, BREADTH_SPP, "perspective", "gaussian", "cuda")
    tp = scene.dev["tstream"]
    types = scene.dev["light"]["type"].tolist()
    log(f"[scene] breadth: {scene.n_tris} triangles, {tp.n_treelets} treelets of "
        f"{tp.leaf_tris}, {tp.top.child_bmin.shape[0]} top-tree nodes, featT "
        f"{tuple(tp.featT.shape)}, light rows {types} (spot, goniometric, projection, "
        f"infinite), light atlas {tuple(scene.dev['light_atlas'].shape)}, materials "
        f"{np.unique(scene.dev['mat']['type'].cpu().numpy()).tolist()}, filter "
        f"{tuple(scene.film.filter)}, compiled in {time.perf_counter() - t0:.2f} s")
    if scene.n_tris != 1_178_624 or types != [1, 5, 6, 4]:
        raise SmokeFailure(f"breadth: expected 1,178,624 triangles and the four light types, "
                           f"got {scene.n_tris} and {types}")

    # [check] both kernels, exact, at the pool wave and the middle chunk's
    # first fixed-batch camera wave (2^20 rays: the unpacked flush key)
    n_chunks = integ.prepare_chunks(scene).n_chunks
    out, _ = _check_waves(scene, integ, "breadth ", fixed_chunk=n_chunks // 2, exact=True,
                          fixed_packed=False)

    # [render] the timed render through the pool and the fixed batch
    pool, p_l = _render_counted(integ, scene, regen=True)
    _log_render(f"breadth pool {BREADTH_RES}x{BREADTH_RES}x{BREADTH_SPP}", pool, p_l)
    fixed, f_l = _render_counted(integ, scene, regen=False)
    _log_render(f"breadth fixed {BREADTH_RES}x{BREADTH_RES}x{BREADTH_SPP}", fixed, f_l)
    close = np.isclose(pool.image, fixed.image, rtol=1e-4, atol=1e-5)
    log(f"[breadth] {BREADTH_RES}x{BREADTH_RES}x{BREADTH_SPP}: pool {pool.mray_per_sec:.4f} "
        f"Mray/s, fixed {fixed.mray_per_sec:.4f} Mray/s (pool/fixed "
        f"{pool.mray_per_sec / max(fixed.mray_per_sec, 1e-9):.3f}); rays {pool.rays_traced} / "
        f"{fixed.rays_traced}; pool waves {pool.stats['n_waves']}, occupancy "
        f"{pool.stats['mean_wave_occupancy']:.4f}; image mean {pool.image.mean():.6f}, pixel "
        f"channels outside rtol 1e-4 / atol 1e-5 of the fixed batch: {int((~close).sum())}; "
        f"dropped {pool.stats['n_drop']} / {fixed.stats['n_drop']}")
    if (not np.isfinite(pool.image).all() or not pool.image.mean() > 1e-6
            or pool.rays_traced != fixed.rays_traced or not close.all()
            or pool.stats["n_drop"] or fixed.stats["n_drop"]):
        raise SmokeFailure("breadth 512x512: the pool and the fixed batch disagree, or the "
                           "image is not a finite lit render, or pairs dropped")
    for name in out:
        out[name].update(launches=p_l[name], launches_fixed=f_l[name],
                         mray_per_sec=pool.mray_per_sec, fixed_mray_per_sec=fixed.mray_per_sec,
                         res=BREADTH_RES, spp=BREADTH_SPP)
    del scene, integ, pool, fixed
    torch.cuda.empty_cache()

    # [render] 64x64x16 against the JAX CPU references
    for camera, filt in BREADTH_REFS.items():
        ref = np.load(BREADTH_REF.format(camera))
        t0 = time.perf_counter()
        scene, integ = _breadth(64, 16, camera, filt, "cuda")
        secs = time.perf_counter() - t0
        res, launches = _render_counted(integ, scene, regen=True)
        label = f"breadth {camera}/{filt} pool 64x64x16"
        _log_render(f"{label} (compiled in {secs:.2f} s)", res, launches)
        _against(label, res.image, res.rays_traced, ref, res.stats["n_drop"], tag="breadth")
        if camera == "realistic":
            t0 = time.perf_counter()
            cpu_scene, cpu_integ = _breadth(64, 16, camera, filt, "cpu", **BREADTH_SMALL)
            n, vc, vp, differ, do, dd = _vignetting(scene, integ, cpu_scene, cpu_integ)
            log(f"[breadth] realistic camera rays, card vs CPU port: {n} lanes, vignetted "
                f"{vc} / {vp}, masks differing {differ}; max |o| diff {do:.3e}, max |d| diff "
                f"{dd:.3e} ({time.perf_counter() - t0:.1f} s)")
            if differ or not 0 < vc < n:
                raise SmokeFailure("breadth: the realistic camera vignettes other lanes on the "
                                   "card than on the CPU port")
        del scene, integ, res

    # the card against the CPU port on the small tessellation
    for camera, filt in BREADTH_PORT.items():
        t0 = time.perf_counter()
        img = {}
        for device in ("cuda", "cpu"):
            scene, integ = _breadth(32, 4, camera, filt, device, **BREADTH_SMALL)
            r = integ.render(scene)
            img[device] = (r.image, r.rays_traced)
        (a, ra), (b, rb) = img["cuda"], img["cpu"]
        mse = float(np.mean((a.astype(np.float64) - b) ** 2))
        log(f"[breadth] card vs CPU port, {camera}/{filt} 32x32x4 (small tessellation): rays "
            f"{ra} / {rb}, MSE {mse:.3e} (bar {PORT_BAR:g}), max |diff| "
            f"{np.abs(a - b).max():.3e}, image mean {a.mean():.6f} "
            f"({time.perf_counter() - t0:.1f} s with the CPU render)")
        if ra != rb or not mse < PORT_BAR or not np.isfinite(a).all() or not a.mean() > 0:
            raise SmokeFailure(f"breadth {camera}: the card and the CPU port differ (rays {ra} / "
                               f"{rb}, MSE {mse:.3e})")
    log(f"[breadth] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 9 -------------------------------------------------------------------

def _textured(res, spp, device, **kw):
    from tpu_pbrt_torch.scenes import compile_api, make_textured_like

    return compile_api(make_textured_like(res, spp, device=device, **kw))


def phase_textured():
    """Textures and the layered materials on the card (see the module doc,
    phase 9): the kernels on the 512x512x4 render's pool and fixed waves,
    that render timed through both, 64x64x16
    against the JAX CPU reference, the card against the CPU port, and
    `bdpt` against its JAX CPU reference. Returns {kernel: numbers at the
    pool wave (the fixed wave's under "at_fixed_wave"), with the timed
    renders' launches and Mray/s}."""
    import numpy as np
    import torch

    from tpu_pbrt_torch.scenes import TEXTURED_SMALL

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    scene, integ = _textured(TEXTURED_RES, TEXTURED_SPP, "cuda")
    tp = scene.dev["tstream"]
    atlas = scene.dev["tex_atlas"]
    log(f"[scene] textured: {scene.n_tris} triangles, {tp.n_treelets} treelets of "
        f"{tp.leaf_tris}, {tp.top.child_bmin.shape[0]} top-tree nodes, {len(scene.tex_eval)} "
        f"textures, atlas {atlas.shape[0]} texels ({atlas.numel() * 4 / 1e6:.1f} MB f32), "
        f"tex_used {sorted(scene.tex_used)}, material types "
        f"{np.unique(scene.dev['mat']['type'].cpu().numpy()).tolist()}, mix rows "
        f"{int((scene.dev['mat']['mix_a'] >= 0).sum())}, compiled in "
        f"{time.perf_counter() - t0:.2f} s")
    if scene.n_tris != 1_166_214 or atlas.shape[0] != 8_738_132 or len(scene.tex_eval) < 14:
        raise SmokeFailure(f"textured: expected 1,166,214 triangles, 8,738,132 texels and 14 "
                           f"textures, got {scene.n_tris}, {atlas.shape[0]}, "
                           f"{len(scene.tex_eval)}")

    # [check] both kernels, exact, at the pool wave and the middle chunk's
    # first fixed-batch camera wave (2^20 rays: the unpacked flush key)
    n_chunks = integ.prepare_chunks(scene).n_chunks
    out, _ = _check_waves(scene, integ, "textured ", fixed_chunk=n_chunks // 2, exact=True,
                          fixed_packed=False)

    # [render] the 512x512x4 render through the pool and the fixed batch
    pool, p_l = _render_counted(integ, scene, regen=True)
    _log_render(f"textured pool {TEXTURED_RES}x{TEXTURED_RES}x{TEXTURED_SPP}", pool, p_l)
    fixed, f_l = _render_counted(integ, scene, regen=False)
    _log_render(f"textured fixed {TEXTURED_RES}x{TEXTURED_RES}x{TEXTURED_SPP}", fixed, f_l)
    close = np.isclose(pool.image, fixed.image, rtol=1e-4, atol=1e-5)
    log(f"[textured] {TEXTURED_RES}x{TEXTURED_RES}x{TEXTURED_SPP}: pool "
        f"{pool.mray_per_sec:.4f} Mray/s, fixed {fixed.mray_per_sec:.4f} Mray/s (pool/fixed "
        f"{pool.mray_per_sec / max(fixed.mray_per_sec, 1e-9):.3f}); rays {pool.rays_traced} / "
        f"{fixed.rays_traced}; pool waves {pool.stats['n_waves']}, occupancy "
        f"{pool.stats['mean_wave_occupancy']:.4f}; image mean {pool.image.mean():.6f}, pixel "
        f"channels outside rtol 1e-4 / atol 1e-5 of the fixed batch: {int((~close).sum())}; "
        f"dropped {pool.stats['n_drop']} / {fixed.stats['n_drop']}")
    if (not np.isfinite(pool.image).all() or not pool.image.mean() > 1e-6
            or pool.rays_traced != fixed.rays_traced or not close.all()
            or pool.stats["n_drop"] or fixed.stats["n_drop"]):
        raise SmokeFailure("textured 512x512: the pool and the fixed batch disagree, or the "
                           "image is not a finite lit render, or pairs dropped")
    for name in out:
        out[name].update(launches=p_l[name], launches_fixed=f_l[name],
                         mray_per_sec=pool.mray_per_sec, fixed_mray_per_sec=fixed.mray_per_sec,
                         res=TEXTURED_RES, spp=TEXTURED_SPP)
    del scene, integ, pool, fixed
    torch.cuda.empty_cache()

    # [render] 64x64x16 against the JAX CPU reference, pool and fixed batch
    ref = np.load(TEXTURED_REF)
    t0 = time.perf_counter()
    scene, integ = _textured(64, 16, "cuda")
    secs = time.perf_counter() - t0
    for regen in (True, False):
        res, launches = _render_counted(integ, scene, regen=regen)
        label = f"textured {'pool' if regen else 'fixed'} 64x64x16"
        _log_render(f"{label} (compiled in {secs:.2f} s)", res, launches)
        _against(label, res.image, res.rays_traced, ref, res.stats["n_drop"], tag="textured")
    del scene, integ

    # the card against the CPU port on the small variant
    t0 = time.perf_counter()
    got = {}
    for device in ("cuda", "cpu"):
        scene, integ = _textured(32, 4, device, **TEXTURED_SMALL)
        r = integ.render(scene)
        got[device] = (r.image, r.rays_traced)
    (a, ra), (b, rb) = got["cuda"], got["cpu"]
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    log(f"[textured] card vs CPU port, 32x32x4 (small variant): rays {ra} / {rb}, MSE "
        f"{mse:.3e} (bar {MSE_BAR:g}), max |diff| {np.abs(a - b).max():.3e}, image mean "
        f"{a.mean():.6f} ({time.perf_counter() - t0:.1f} s with the CPU render)")
    if not mse < MSE_BAR or not np.isfinite(a).all() or not a.mean() > 0:
        raise SmokeFailure(f"textured: the card and the CPU port differ (MSE {mse:.3e})")

    # [render] bdpt with mix lanes against its JAX CPU reference
    ref = np.load(TEXTURED_BDPT_REF)
    t0 = time.perf_counter()
    from tpu_pbrt_torch.scenes import compile_api, make_textured_like

    scene, integ = compile_api(make_textured_like(32, 16, integrator="bdpt", device="cuda"))
    res = integ.render(scene)
    log(f"[textured] bdpt 32x32x16: {res.seconds:.3f} s, {res.mray_per_sec:.4f} Mray/s "
        f"({time.perf_counter() - t0:.1f} s with the compile)")
    _against("textured bdpt 32x32x16", res.image, res.rays_traced, ref, res.stats["n_drop"],
             tag="textured")
    del scene, integ, res
    log(f"[textured] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 10 ------------------------------------------------------------------

def _motion(res, spp, device, **kw):
    from tpu_pbrt_torch.scenes import compile_api, make_motion_like

    return compile_api(make_motion_like(res, spp, device=device, **kw))


def phase_motion():
    """Motion blur, disney and hair on the card (see the module doc, phase
    10): the kernels on the 512x512x4 render's pool and fixed waves (F =
    64, real ray times), that render timed through both, `path` 64x64x64
    and `bdpt` 32x32x16 against the JAX CPU references, and the card
    against the CPU port. Returns {kernel: numbers at the pool wave (the
    fixed wave's under "at_fixed_wave"), with the timed renders' launches
    and Mray/s}."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    scene, integ = _motion(MOTION_RES, MOTION_SPP, "cuda")
    secs = time.perf_counter() - t0
    tp = scene.dev["tstream"]
    types = np.unique(scene.dev["mat"]["type"].cpu().numpy()).tolist()
    log(f"[scene] motion: {scene.n_tris} triangles, {tp.n_treelets} treelets of {tp.leaf_tris}, "
        f"{tp.top.child_bmin.shape[0]} top-tree nodes, featT F = {tp.n_features} "
        f"({tp.featT.numel() * 4 / 1e9:.3f} GB f32), tri_verts1 "
        f"{'tri_verts1' in scene.dev}, tri_tanT {'tri_tanT' in scene.dev}, material types "
        f"{types}, compiled in {secs:.2f} s")
    if (scene.n_tris != 1_042_004 or tp.n_features != 64 or "tri_verts1" not in scene.dev
            or "tri_tanT" not in scene.dev or not {9, 10} <= set(types)):
        raise SmokeFailure("motion: expected 1,042,004 triangles with the F = 64 pack, the "
                           "shutter-end keyframe, the hair tangents and disney + hair rows")

    # [check] both kernels, exact, at the pool wave (real ray times per
    # regenerated lane) and the middle chunk's first fixed-batch camera
    # wave (2^20 rays: the unpacked flush key)
    n_chunks = integ.prepare_chunks(scene).n_chunks
    out, _ = _check_waves(scene, integ, "motion ", fixed_chunk=n_chunks // 2, exact=True,
                          fixed_packed=False, features=64)

    # [render] the 512x512x4 render through the pool and the fixed batch
    pool, p_l = _render_counted(integ, scene, regen=True)
    _log_render(f"motion pool {MOTION_RES}x{MOTION_RES}x{MOTION_SPP}", pool, p_l)
    fixed, f_l = _render_counted(integ, scene, regen=False)
    _log_render(f"motion fixed {MOTION_RES}x{MOTION_RES}x{MOTION_SPP}", fixed, f_l)
    close = np.isclose(pool.image, fixed.image, rtol=1e-4, atol=1e-5)
    log(f"[motion] {MOTION_RES}x{MOTION_RES}x{MOTION_SPP}: pool {pool.mray_per_sec:.4f} Mray/s, "
        f"fixed {fixed.mray_per_sec:.4f} Mray/s (pool/fixed "
        f"{pool.mray_per_sec / max(fixed.mray_per_sec, 1e-9):.3f}); rays {pool.rays_traced} / "
        f"{fixed.rays_traced}; pool waves {pool.stats['n_waves']}, occupancy "
        f"{pool.stats['mean_wave_occupancy']:.4f}; image mean {pool.image.mean():.6f}, pixel "
        f"channels outside rtol 1e-4 / atol 1e-5 of the fixed batch: {int((~close).sum())}; "
        f"dropped {pool.stats['n_drop']} / {fixed.stats['n_drop']}; {card_line()}")
    if (not np.isfinite(pool.image).all() or not pool.image.mean() > 1e-6
            or pool.rays_traced != fixed.rays_traced or not close.all()
            or pool.stats["n_drop"] or fixed.stats["n_drop"]
            or not p_l["flush_chunk"] > 0 or not f_l["flush_chunk"] > 0):
        raise SmokeFailure("motion 512x512: the pool and the fixed batch disagree, the image is "
                           "not a finite lit render, pairs dropped, or the F = 64 flush never ran")
    for name in out:
        out[name].update(launches=p_l[name], launches_fixed=f_l[name],
                         mray_per_sec=pool.mray_per_sec, fixed_mray_per_sec=fixed.mray_per_sec,
                         res=MOTION_RES, spp=MOTION_SPP)
    del scene, integ, pool, fixed
    torch.cuda.empty_cache()

    # [render] path 64x64x16 against its JAX CPU reference at the bar (the
    # fault of ROADMAP Queue 3 item 12, closed); then 64x64x64 through the
    # pool and the fixed batch, held to the bar
    ref = np.load(MOTION_REF16)
    scene, integ = _motion(64, 16, "cuda")
    res, launches = _render_counted(integ, scene, regen=True)
    _log_render("motion pool 64x64x16", res, launches)
    want = ref["image"]
    mse16 = float(np.mean((res.image.astype(np.float64) - want) ** 2))
    log(f"[motion] motion pool 64x64x16: image mean {res.image.mean():.6f} (JAX CPU "
        f"{want.mean():.6f}), MSE {mse16:.3e} (bar {MSE_BAR:g}: "
        f"{'within' if mse16 <= MSE_BAR else 'OVER'}), rays {res.rays_traced} (JAX CPU "
        f"{int(ref['rays_traced'])}, {res.rays_traced - int(ref['rays_traced']):+d}), dropped "
        f"{res.stats['n_drop']}")
    if not np.isfinite(res.image).all() or res.stats["n_drop"] or mse16 > MSE_BAR:
        raise SmokeFailure("motion 64x64x16: over the bar, non-finite or pairs dropped")
    del scene, integ, res
    ref = np.load(MOTION_REF)
    t0 = time.perf_counter()
    scene, integ = _motion(64, 64, "cuda")
    secs = time.perf_counter() - t0
    for regen in (True, False):
        res, launches = _render_counted(integ, scene, regen=regen)
        label = f"motion {'pool' if regen else 'fixed'} 64x64x64"
        _log_render(f"{label} (compiled in {secs:.2f} s)", res, launches)
        _against(label, res.image, res.rays_traced, ref, res.stats["n_drop"], tag="motion")
    del scene, integ

    # [render] bdpt (the shutter-start frame; disney and hair through BDPT)
    ref = np.load(MOTION_BDPT_REF)
    t0 = time.perf_counter()
    scene, integ = _motion(32, 16, "cuda", integrator="bdpt")
    res = integ.render(scene)
    log(f"[motion] bdpt 32x32x16: {res.seconds:.3f} s, {res.mray_per_sec:.4f} Mray/s "
        f"({time.perf_counter() - t0:.1f} s with the compile)")
    _against("motion bdpt 32x32x16", res.image, res.rays_traced, ref, res.stats["n_drop"],
             tag="motion")
    del scene, integ, res

    # the card against the CPU port on the small variant
    t0 = time.perf_counter()
    got = {}
    for device in ("cuda", "cpu"):
        scene, integ = _motion(32, 4, device, small=True)
        r = integ.render(scene)
        got[device] = (r.image, r.rays_traced)
    (a, ra), (b, rb) = got["cuda"], got["cpu"]
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    log(f"[motion] card vs CPU port, 32x32x4 (small variant): rays {ra} / {rb}, MSE "
        f"{mse:.3e} (bar {PORT_BAR:g}), max |diff| {np.abs(a - b).max():.3e}, image mean "
        f"{a.mean():.6f} ({time.perf_counter() - t0:.1f} s with the CPU render)")
    if not mse < PORT_BAR or not np.isfinite(a).all() or not a.mean() > 0:
        raise SmokeFailure(f"motion: the card and the CPU port differ (MSE {mse:.3e})")
    log(f"[motion] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 11 ------------------------------------------------------------------

def _subsurface(res, spp, device, **kw):
    from tpu_pbrt_torch.scenes import compile_api, make_subsurface_like

    return compile_api(make_subsurface_like(res, spp, device=device, **kw))


def _capture_probe_wave(scene, integ):
    """The first probe-chord wave of the render's middle chunk through the
    pool: the BSSRDF probe traces its chords with `scene_intersect`, which
    the fused layout calls for nothing else (closest hit, each chord's own
    short t_max, the dead lanes' < 0)."""
    from tpu_pbrt_torch.integrators import path as tpath

    real, in_probe = tpath.scene_intersect, [False]

    def chord(*args, **kw):
        in_probe[0] = True
        try:
            return real(*args, **kw)
        finally:
            in_probe[0] = False

    plan = integ.prepare_chunks(scene)
    if not plan.use_regen:
        raise SmokeFailure("subsurface: the render plan does not take the persistent pool")
    chunk = plan.n_chunks // 2
    tpath.scene_intersect = chord
    try:
        cap, state = _capture_first_wave(
            lambda: integ.pool_chunk(scene.dev, scene.film.init_state(scene.device),
                                     *plan.start(chunk), plan.chunk, plan.pool),
            False, "subsurface", when=lambda: in_probe[0])
    finally:
        tpath.scene_intersect = real
    if not state["finite"] or not state["live"]:
        raise SmokeFailure(f"subsurface: the probe-chord wave has no live finite chords ({state})")
    state["chunk"] = chunk
    return cap, state


def phase_subsurface():
    """The subsurface scene on the card (see the module doc, phase 11):
    both kernels on the first probe-chord wave, the 512x512x8 render
    timed through the pool and the fixed batch, `path` 64x64x16 against
    the JAX CPU reference and the card against the CPU port. Returns
    {kernel: numbers at the probe-chord wave, with the timed renders'
    launches and Mray/s}."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    scene, integ = _subsurface(SUBSURFACE_RES, SUBSURFACE_SPP, "cuda")
    secs = time.perf_counter() - t0
    tp = scene.dev["tstream"]
    mat = scene.dev["mat"]
    types = np.unique(mat["type"].cpu().numpy()).tolist()
    bs = scene.dev.get("bssrdf")
    log(f"[scene] subsurface: {scene.n_tris} triangles, {tp.n_treelets} treelets of "
        f"{tp.leaf_tris}, {tp.top.child_bmin.shape[0]} top-tree nodes, material types {types}, "
        f"sub_id {mat['sub_id'].tolist() if 'sub_id' in mat else None}, Fourier table "
        f"{tuple(mat['_fourier'].mu.shape) if '_fourier' in mat else None} x "
        f"{mat['_fourier'].n_channels if '_fourier' in mat else 0} channels, r_max "
        f"{bs.r_max.cpu().numpy().round(4).tolist() if bs is not None else None}, compiled in "
        f"{secs:.2f} s")
    if (scene.n_tris != 1_126_884 or bs is None or "_fourier" not in mat
            or not {11, 12} <= set(types)):
        raise SmokeFailure("subsurface: expected 1,126,884 triangles with the BSSRDF rows and "
                           "the Fourier table")

    # [check] both kernels, exact, on the first probe-chord wave
    t0 = time.perf_counter()
    cap, wave = _capture_probe_wave(scene, integ)
    log(f"[subsurface] probe-chord wave: the first chord of chunk {wave['chunk']}'s first probe "
        f"({wave['rays']} rays, {wave['live']} live chords, all with a finite t_max: "
        f"{wave['finite']}; {wave['hits']} hit, {wave['live'] - wave['hits']} missed; "
        f"{wave['expands']} expand steps, {wave['flushes']} flush chunks; expand captured after "
        f"a flush: {wave['expand_after_flush']}, flush chunk after that expand: "
        f"{wave['flush_after_expand']}) in {time.perf_counter() - t0:.2f} s")
    out = {"flush_chunk": _flush_numbers(cap["flush"], tp.count, "subsurface probe-chord wave",
                                         exact=True),
           "expand": _expand_numbers(cap["expand"], "subsurface probe-chord wave")}
    del cap

    # [render] the timed render through the pool and the fixed batch
    pool, p_l = _render_counted(integ, scene, regen=True)
    _log_render(f"subsurface pool {SUBSURFACE_RES}x{SUBSURFACE_RES}x{SUBSURFACE_SPP}", pool, p_l)
    fixed, f_l = _render_counted(integ, scene, regen=False)
    _log_render(f"subsurface fixed {SUBSURFACE_RES}x{SUBSURFACE_RES}x{SUBSURFACE_SPP}", fixed,
                f_l)
    close = np.isclose(pool.image, fixed.image, rtol=1e-4, atol=1e-5)
    log(f"[subsurface] {SUBSURFACE_RES}x{SUBSURFACE_RES}x{SUBSURFACE_SPP}: pool "
        f"{pool.mray_per_sec:.4f} Mray/s, fixed {fixed.mray_per_sec:.4f} Mray/s (pool/fixed "
        f"{pool.mray_per_sec / max(fixed.mray_per_sec, 1e-9):.3f}); rays {pool.rays_traced} / "
        f"{fixed.rays_traced}; pool waves {pool.stats['n_waves']}, occupancy "
        f"{pool.stats['mean_wave_occupancy']:.4f}; launches flush {p_l['flush_chunk']} / "
        f"{f_l['flush_chunk']}, expand {p_l['expand']} / {f_l['expand']}; image mean "
        f"{pool.image.mean():.6f}, pixel channels outside rtol 1e-4 / atol 1e-5 of the fixed "
        f"batch: {int((~close).sum())}; dropped {pool.stats['n_drop']} / "
        f"{fixed.stats['n_drop']}; {card_line()}")
    if (not np.isfinite(pool.image).all() or not pool.image.mean() > 1e-6
            or pool.rays_traced != fixed.rays_traced or not close.all()
            or pool.stats["n_drop"] or fixed.stats["n_drop"]):
        raise SmokeFailure("subsurface 512x512: the pool and the fixed batch disagree, the image "
                           "is not a finite lit render, or pairs dropped")
    for name in out:
        out[name].update(launches=p_l[name], launches_fixed=f_l[name],
                         mray_per_sec=pool.mray_per_sec, fixed_mray_per_sec=fixed.mray_per_sec,
                         res=SUBSURFACE_RES, spp=SUBSURFACE_SPP)
    del scene, integ, pool, fixed
    torch.cuda.empty_cache()

    # [render] path 64x64x16 against the JAX CPU reference, pool and fixed batch
    ref = np.load(SUBSURFACE_REF)
    t0 = time.perf_counter()
    scene, integ = _subsurface(64, 16, "cuda")
    secs = time.perf_counter() - t0
    for regen in (True, False):
        res, launches = _render_counted(integ, scene, regen=regen)
        label = f"subsurface {'pool' if regen else 'fixed'} 64x64x16"
        _log_render(f"{label} (compiled in {secs:.2f} s)", res, launches)
        _against(label, res.image, res.rays_traced, ref, res.stats["n_drop"], tag="subsurface")
    del scene, integ

    # the card against the CPU port on the small variant
    t0 = time.perf_counter()
    got = {}
    for device in ("cuda", "cpu"):
        scene, integ = _subsurface(32, 4, device, small=True)
        r = integ.render(scene)
        got[device] = (r.image, r.rays_traced)
    (a, ra), (b, rb) = got["cuda"], got["cpu"]
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    log(f"[subsurface] card vs CPU port, 32x32x4 (small variant): rays {ra} / {rb}, MSE "
        f"{mse:.3e} (bar {PORT_BAR:g}), max |diff| {np.abs(a - b).max():.3e}, image mean "
        f"{a.mean():.6f} ({time.perf_counter() - t0:.1f} s with the CPU render)")
    if not mse < PORT_BAR or not np.isfinite(a).all() or not a.mean() > 0:
        raise SmokeFailure(f"subsurface: the card and the CPU port differ (MSE {mse:.3e})")
    log(f"[subsurface] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 12 ------------------------------------------------------------------

class _Crash(Exception):
    """A process death at a chunk dispatch (raised by a chaos hook)."""


def phase_infra():
    """The render infrastructure on the main path (see the module doc,
    phase 12): the killeroo at 128x128x256 through the dispatch window at
    depth 1 and 2, the chaos recoveries and the strict firewall at
    128x128x32 in chunks of 2^17, and the capacity audit. Returns
    {kernel: launches at each depth, with Mray/s and overlap}."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tpu_pbrt_torch.chaos import CHAOS
    from tpu_pbrt_torch.config import cfg
    from tpu_pbrt_torch.integrators.common import NonFiniteRadianceError
    from tpu_pbrt_torch.kernels import LAUNCHES, reset_launches
    from tpu_pbrt_torch.obs.metrics import host_overlap_fraction
    from tpu_pbrt_torch.parallel.checkpoint import load_checkpoint
    from tpu_pbrt_torch.scenes import compile_api, make_killeroo_like
    from tpu_pbrt_torch.utils.clock import VirtualClock

    t_phase = time.perf_counter()
    scene, integ = compile_api(make_killeroo_like(res=128, spp=256, maxdepth=5, device="cuda"))
    ref = np.load(REF_IMAGE)["image"]
    saved = {k: getattr(cfg, k) for k in ("pipeline", "chunk", "nonfinite", "retry_backoff")}
    runs, out = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_infra_")
    try:
        for depth in (1, 2):
            cfg.pipeline = depth
            reset_launches()
            res = integ.render(scene)
            launches = dict(LAUNCHES)
            ph = res.stats["phase_seconds"]
            ovl = host_overlap_fraction(ph, res.seconds)
            mse = float(np.mean((res.image.astype(np.float64) - ref) ** 2))
            runs[depth] = res
            log(f"[infra] killeroo 128x128x256 at depth {res.stats['pipeline_depth']}: "
                f"{res.seconds:.3f} s, {res.rays_traced} rays, {res.mray_per_sec:.4f} Mray/s, "
                f"host_overlap_fraction {ovl}, device_wait {ph.get('device_wait', 0.0):.6f} s, "
                f"phases {json.dumps(ph)}, MSE vs ref {mse:.3e} (bar {MSE_BAR:g}), launches "
                f"{json.dumps(launches)}; {card_line()}")
            if (res.stats["pipeline_depth"] != depth or not np.isfinite(res.image).all()
                    or mse > MSE_BAR or min(launches.values()) <= 0):
                raise SmokeFailure(f"infra: depth {depth}: MSE {mse:.3e}, launches {launches}")
            for name, n in launches.items():
                out.setdefault(name, {})[f"launches_depth{depth}"] = n
                out[name][f"mray_per_sec_depth{depth}"] = res.mray_per_sec
                out[name][f"host_overlap_fraction_depth{depth}"] = ovl
        same = all(torch.equal(a, b) for a, b in zip(runs[1].film_state, runs[2].film_state))
        drops = integ._audit_memo[(id(scene), runs[1].stats["chunk"])][1]
        log(f"[infra] depth 1 vs 2: film bit-identical {same}, rays {runs[1].rays_traced} / "
            f"{runs[2].rays_traced}; capacity audit of the {runs[1].stats['chunk']}-ray camera "
            f"wave: {drops} pairs dropped")
        if not same or runs[1].rays_traced != runs[2].rays_traced or drops != 0:
            raise SmokeFailure("infra: depths 1 and 2 differ, or the capacity audit saw drops")
        del runs

        # the ladder at 128x128x32 in 4 chunks of 2^17, a checkpoint after
        # each, the backoff on a virtual clock
        cfg.chunk, cfg.pipeline, cfg.retry_backoff = 1 << 17, 2, 0.25
        small, sinteg = compile_api(make_killeroo_like(res=128, spp=32, maxdepth=5,
                                                       device="cuda"))
        sinteg.clock = VirtualClock()

        def render(name, plan="", **kw):
            CHAOS.install(plan)
            try:
                r = sinteg.render(small, checkpoint_path=os.path.join(tmp, name + ".npz"),
                                  checkpoint_every=1, **kw)
            finally:
                CHAOS.clear()
            return r

        clean = render("clean")
        if clean.stats["chunks"] != 4:
            raise SmokeFailure(f"infra: expected 4 chunks, got {clean.stats['chunks']}")
        cases = [("dispatch:poison@chunk=2 (rollback)", "poison", "dispatch:poison@chunk=2",
                  "scrub"),
                 ("nan:wave@1&chunk=1 under nonfinite=retry", "nan", "nan:wave@1&chunk=1",
                  "retry")]
        for label, name, plan, mode in cases:
            cfg.nonfinite = mode
            r = render(name, plan)
            cfg.nonfinite = "scrub"
            same = all(torch.equal(a, b) for a, b in zip(r.film_state, clean.film_state))
            log(f"[infra] {label}: recovery {json.dumps(r.stats.get('recovery'))}, film "
                f"bit-identical to the clean render {same}, rays {r.rays_traced} / "
                f"{clean.rays_traced}")
            if not same or r.rays_traced != clean.rays_traced or not r.stats.get("recovery"):
                raise SmokeFailure(f"infra: {label} did not recover to the clean render")
        # a torn second write, the process dies in chunk 2's dispatch; the
        # resume reads the .prev file (cursor 1)
        CHAOS.install("ckpt:torn@write=2")

        def crash(c, attempt):
            if c == 2:
                raise _Crash

        CHAOS.register_hook(crash)
        path = os.path.join(tmp, "torn.npz")
        try:
            sinteg.render(small, checkpoint_path=path, checkpoint_every=1)
            raise SmokeFailure("infra: the crash hook did not fire")
        except _Crash:
            pass
        finally:
            fired = CHAOS.report()
            CHAOS.clear()
        cursor = load_checkpoint(path)[1]
        r = sinteg.render(small, checkpoint_path=path, checkpoint_every=1)
        same = all(torch.equal(a, b) for a, b in zip(r.film_state, clean.film_state))
        log(f"[infra] ckpt:torn@write=2, crashed at chunk 2, resumed: faults {json.dumps(fired)},"
            f" resumed at cursor {cursor} (the .prev file), recovery "
            f"{json.dumps(r.stats.get('recovery'))}, film bit-identical {same}, rays "
            f"{r.rays_traced} / {clean.rays_traced}")
        if cursor != 1 or not same or r.rays_traced != clean.rays_traced or \
                fired[0]["fired"] != 1:
            raise SmokeFailure("infra: the resume after a torn checkpoint differs")
        cfg.nonfinite = "raise"
        CHAOS.install("nan:wave@1&chunk=1")
        try:
            sinteg.render(small)
            raise SmokeFailure("infra: nonfinite=raise did not raise")
        except NonFiniteRadianceError as e:
            log(f"[infra] nonfinite=raise: NonFiniteRadianceError: {e}")
        finally:
            CHAOS.clear()
            cfg.nonfinite = "scrub"
    finally:
        for k, v in saved.items():
            setattr(cfg, k, v)
        CHAOS.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[infra] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 13 ------------------------------------------------------------------

def _jsonl_session(argv, scene_path, image_out, tag, chunk=SERVE_CHUNK):
    """Drive one JSONL daemon (argv) on the card: submit the scene, wait
    for its done event, then preview, result (writing `image_out`),
    metrics, health and shutdown. Returns the answers by op and the
    exit code; fails on any {"ok": false} answer."""
    proc = subprocess.Popen(argv, cwd=HERE, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, bufsize=1)
    answers, events = {}, []

    def rpc(req):
        proc.stdin.write(json.dumps(req) + "\n")
        proc.stdin.flush()
        while True:
            line = proc.stdout.readline()
            if not line:
                raise SmokeFailure(f"serve: {tag} closed its pipe at {req['op']}: "
                                   f"{proc.stderr.read()[-2000:]}")
            msg = json.loads(line)
            if "event" in msg:
                events.append(msg)
                continue
            if not msg.get("ok"):
                raise SmokeFailure(f"serve: {tag} answered {req['op']} with {msg}")
            answers[req["op"]] = msg
            return msg

    try:
        rpc({"op": "submit", "scene": scene_path, "job": "dj", "tenant": "daemon",
             "chunk": chunk})
        deadline = time.monotonic() + 300
        while not any(e.get("job") == "dj" for e in events):
            if time.monotonic() > deadline:
                raise SmokeFailure(f"serve: {tag}: no done event in 300 s")
            rpc({"op": "poll", "job": "dj"})
            time.sleep(0.2)
        if events[-1]["event"] != "done":
            raise SmokeFailure(f"serve: {tag}: {events[-1]}")
        rpc({"op": "preview", "job": "dj"})
        rpc({"op": "result", "job": "dj", "out": image_out})
        rpc({"op": "metrics"})
        rpc({"op": "health"})
        proc.stdin.write(json.dumps({"op": "shutdown", "drain": True}) + "\n")
        proc.stdin.close()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return answers, events, rc


def phase_serve(device="cuda", res=SERVE_RES, spp=SERVE_SPP, chunk=SERVE_CHUNK, blob=(180, 360)):
    """The serving stack over the main path (see the module doc, phase
    13). Returns {kernel: {"launches": n, ...}} for the phase. The
    arguments shrink it for a dry run on the CPU (device="cpu" and a
    small blob tessellation)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tpu_pbrt_torch.fleet import FleetRouter, LocalReplica
    from tpu_pbrt_torch.kernels import LAUNCHES, reset_launches
    from tpu_pbrt_torch.kernels.build import BUILDS
    from tpu_pbrt_torch.obs.flight import FLIGHT, validate_flight
    from tpu_pbrt_torch.obs.health import evaluate
    from tpu_pbrt_torch.obs.metrics import METRICS, validate_exposition
    from tpu_pbrt_torch.parallel.checkpoint import checkpoint_exists
    from tpu_pbrt_torch.scene.api import Options, compile_file
    from tpu_pbrt_torch.scenes import killeroo_file
    from tpu_pbrt_torch.serve import RenderService
    from tpu_pbrt_torch.utils.imageio import read_pfm

    t_phase = time.perf_counter()
    path = killeroo_file(res, spp, n_theta=blob[0], n_phi=blob[1])
    cuda = device == "cuda"
    dev_args = [] if cuda else ["--device", device]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    FLIGHT.configure(os.path.join(tmp, "flight.jsonl"))
    METRICS.reset()
    reset_launches()
    # the two daemons run beside the in-process work (the pool is bound by
    # its host; the daemons use other cores) and are read at the end
    from concurrent.futures import ThreadPoolExecutor

    outs = {k: os.path.join(tmp, f"{k}.pfm") for k in ("serve", "main")}
    argvs = {"serve": [sys.executable, "-m", "tpu_pbrt_torch.serve", "--quiet",
                       "--spool", os.path.join(tmp, "dspool"), *dev_args],
             "main": [sys.executable, "-m", "tpu_pbrt_torch.main", "--serve", "--quiet",
                      *dev_args]}
    pool = ThreadPoolExecutor(2)
    futs = {k: pool.submit(_jsonl_session, argvs[k], path, outs[k], k, chunk) for k in argvs}
    try:
        if cuda:
            from tpu_pbrt_torch.serve.residency import scene_hbm_bytes

            base = _peak_reset()
        scene, integ = compile_file(path, Options(quiet=True), device=device)
        if cuda:
            compile_peak, scene_bytes = _peak_read(base)[0], scene_hbm_bytes(scene)
            base = _peak_reset()
        solo = integ.render(scene, chunk=chunk)
        solo_ws = _working_set("[serve] solo", solo, *_peak_read(base)) if cuda else None
        solo_launches = dict(LAUNCHES)
        log(f"[serve] solo {res}x{res}x{spp} ({scene.n_tris} triangles, "
            f"chunk {chunk}, {solo.stats['chunks']} chunks): {solo.rays_traced} rays, "
            f"{solo.mray_per_sec:.4f} Mray/s, launches {json.dumps(solo_launches)}; "
            f"{card_line()}")
        if solo.stats["chunks"] != 4 or not np.isfinite(solo.image).all():
            raise SmokeFailure(f"serve: solo render {solo.stats['chunks']} chunks")
        del scene, integ

        def same(label, res):
            ok = (res.rays_traced == solo.rays_traced
                  and all(torch.equal(a, b) for a, b in zip(res.film_state, solo.film_state)))
            if not ok:
                raise SmokeFailure(f"serve: {label}: film or rays ({res.rays_traced}) differ "
                                   f"from the solo render ({solo.rays_traced})")
            return res.mray_per_sec

        svc = RenderService(chunk=chunk, seed=0, spool_dir=os.path.join(tmp, "spool"),
                            device=device)
        os.makedirs(svc.spool_dir, exist_ok=True)
        if cuda:
            torch.cuda.synchronize()
        reset_launches()
        mem0 = _peak_reset() if cuda else 0
        t0 = time.perf_counter()
        a = svc.submit(path, tenant="alice")
        compile_s = time.perf_counter() - t0
        mem_delta = (torch.cuda.memory_allocated() - mem0) if cuda else None
        b = svc.submit(path, tenant="bob")
        rstats = svc.residency.stats()
        if rstats["scene_compiles"] != 1:
            raise SmokeFailure(f"serve: two same-scene submits took {rstats['scene_compiles']} "
                               "scene compiles")
        for _ in range(3):
            svc.step()
        svc.preempt(b)
        bj = svc.jobs[b]
        parked_at = bj.cursor
        if bj.state is not None or not checkpoint_exists(bj.checkpoint_path) or not bj.cursor:
            raise SmokeFailure(f"serve: the park of {b} kept its film or wrote no checkpoint")
        for _ in range(2):
            svc.step()
        svc.resume(b)
        svc.drain()
        if cuda:
            session_peak, slack = _peak_read(mem0)
        mray = {j: same(f"two tenants, {j}", svc.result(j)) for j in (a, b)}
        if cuda:
            _hbm_serve(res, spp, chunk, scene_bytes, compile_peak, solo_ws, session_peak, slack,
                       rstats["resident_bytes"], 2)
        log(f"[serve] two tenants: schedule {svc.schedule}; {b} parked at chunk {parked_at} "
            f"and resumed; films bit-identical")

        svc.max_active = 1
        lo = svc.submit(path, tenant="batch", priority=0)
        svc.step()
        svc.step()
        hi = svc.submit(path, tenant="live", priority=5)
        mid = svc.submit(path, tenant="batch", priority=2)
        if svc.step() != hi or svc.jobs[lo].state is not None:
            raise SmokeFailure("serve: the priority-5 job did not displace the running job")
        svc.drain()
        svc.max_active = None
        mray |= {j: same(f"priority, {j}", svc.result(j)) for j in (lo, mid, hi)}
        order = [j for j, _ in svc.schedule if j in (lo, mid, hi)]
        log(f"[serve] priority (max_active 1): order {order}, {lo} preemptions "
            f"{svc.poll(lo)['preemptions']}; three films bit-identical")

        builds, hits = dict(BUILDS), svc.residency.stats()["hits"]
        w = svc.submit(path, tenant="alice")
        svc.drain()
        rstats = svc.residency.stats()
        if (rstats["scene_compiles"] != 1 or BUILDS != builds
                or rstats["hits"] != hits + 1):
            raise SmokeFailure(f"serve: warm resubmit: compiles {rstats['scene_compiles']}, "
                               f"builds {builds} -> {BUILDS}, hits {hits} -> {rstats['hits']}")
        mray[w] = same("warm resubmit", svc.result(w))

        c = svc.submit(path, tenant="carol", checkpoint_every=1)
        svc.step()
        spool = svc.jobs[c].checkpoint_path
        had = checkpoint_exists(spool)
        svc.cancel(c)
        pins = svc.residency.pin_counts()
        if not had or checkpoint_exists(spool) or any(pins.values()):
            raise SmokeFailure(f"serve: cancel: spool before {had}, after "
                               f"{checkpoint_exists(spool)}, pins {pins}")

        exp = svc.metrics_exposition()
        errs = validate_exposition(exp)
        health = evaluate(svc)
        ferrs = validate_flight(os.path.join(tmp, f"flight.{a}.jsonl"),
                                require_phases=["serve_submit", "serve_done"])
        ferrs += validate_flight(os.path.join(tmp, f"flight.{b}.jsonl"),
                                 require_phases=["serve_park", "serve_resume", "serve_done"])
        if errs or not health.ok or ferrs:
            raise SmokeFailure(f"serve: exposition {errs[:3]}, health {health.firing()}, "
                               f"flight {ferrs[:3]}")
        snap = METRICS.snapshot()["metrics"]
        waits = snap["tpu_pbrt_serve_queue_wait_seconds"]["series"]
        p90 = max(s["p90"] for s in waits)
        n_wait = sum(s["count"] for s in waits)
        parks = sum(s["value"] for s in snap["tpu_pbrt_serve_preemptions_total"]["series"])
        preempts = sum(svc.poll(j)["preemptions"] for j in svc.jobs)
        in_process = dict(LAUNCHES)
        log(f"[serve] in-process: {len(svc.schedule)} slices, {preempts} preemptions, {parks} "
            f"parks, queue-wait p90 {p90:.4f} s over {n_wait} waits, Mray/s "
            f"{json.dumps({j: round(v, 4) for j, v in mray.items()})} (solo "
            f"{solo.mray_per_sec:.4f}); scene_hbm_bytes {rstats['resident_bytes']} beside "
            f"memory_allocated delta of the compile {mem_delta} ({compile_s:.1f} s); "
            f"health ok, exposition {len(exp.splitlines())} lines valid, flight valid; "
            f"launches {json.dumps(in_process)}")
        del svc

        sessions = {k: f.result() for k, f in futs.items()}
        for k, (answers, events, rc) in sessions.items():
            img = read_pfm(outs[k])
            if (rc != 0 or answers["result"]["rays"] != solo.rays_traced
                    or not np.array_equal(img, solo.image) or not answers["health"]["ok"]
                    or not answers["metrics"]["lines"]):
                raise SmokeFailure(f"serve: daemon {k}: rc {rc}, rays "
                                   f"{answers['result']['rays']} (solo {solo.rays_traced}), "
                                   f"image equal {np.array_equal(img, solo.image)}")
            log(f"[serve] daemon `{' '.join(argvs[k][1:3])}`: result equal to the solo render "
                f"({answers['result']['rays']} rays, {answers['result']['seconds']} s), preview "
                f"mean {answers['preview']['mean']:.6f}, {answers['metrics']['lines']} metric "
                f"lines, health ok, exit {rc}")

        reset_launches()
        reps = [LocalReplica(f"r{k}", chunk=chunk, device=device,
                             spool_dir=os.path.join(tmp, f"r{k}")) for k in range(2)]
        router = FleetRouter(reps, spool_dir=os.path.join(tmp, "fleet"))
        f1 = router.submit(path, tenant="alice", checkpoint_every=1)
        f2 = router.submit(path, tenant="bob", checkpoint_every=1)
        owner = router.owner(f1)
        if router.owner(f2) != owner:
            raise SmokeFailure(f"serve: fleet routed one scene to {owner} and {router.owner(f2)}")
        for _ in range(3):
            router.step()
        at = {j: router.poll(j)["chunks_done"] for j in (f1, f2)}
        moved = router.drain_replica(owner)
        router.drain_fleet()
        for j in (f1, f2):
            p = router.poll(j)
            if p["failovers"] != 1 or p["replica"] == owner:
                raise SmokeFailure(f"serve: fleet failover of {j}: {p}")
            mray[j] = same(f"fleet failover, {j}", router.result(j))
        fleet = dict(LAUNCHES)
        log(f"[serve] fleet: both submits routed to {owner}; drained at chunks {at}, moved "
            f"{moved} to {router.owner(f1)}, resumed from the spool: films bit-identical; "
            f"compiles per replica "
            f"{[r.service.residency.stats()['scene_compiles'] for r in reps]}; launches "
            f"{json.dumps(fleet)}")
        launches = {k: in_process[k] + fleet[k] for k in in_process}
        if min(launches.values()) <= 0:
            raise SmokeFailure(f"serve: a kernel was never launched: {launches}")
        wall = time.perf_counter() - t_phase
        log(f"[serve] phase launches {json.dumps(launches)} (the in-process service and the "
            f"fleet, each counted from 0; the solo render's above; the daemons' in their own "
            f"processes), wall time {wall:.1f} s; {card_line()}")
        return {k: {"launches": n, "mray_per_sec_solo": solo.mray_per_sec,
                    "phase_seconds": wall} for k, n in launches.items()}
    finally:
        pool.shutdown(wait=True)
        FLIGHT.configure(None)
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 14 ------------------------------------------------------------------

def phase_cli(device: str = "cuda") -> None:
    """The CLI on the Cornell box in subprocesses: an uninterrupted
    render, and one killed after its first checkpoint then resumed with
    --trace, --metrics-path and a fault plan that poisons its first
    dispatch: it must end bit-identical to the first, and its files must
    validate."""
    import shutil
    import tempfile

    import numpy as np

    from tpu_pbrt_torch.parallel.checkpoint import load_checkpoint
    from tpu_pbrt_torch.utils.imageio import read_exr

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        def cmd(name):
            return [sys.executable, "-m", "tpu_pbrt_torch.main",
                    os.path.join(HERE, "scenes", "cornell-path.pbrt"), "--quick", "--quiet",
                    "--device", device, "--spp-chunk", "8192", "--checkpoint-every", "1",
                    "-o", os.path.join(tmp, f"{name}.exr"),
                    "--checkpoint", os.path.join(tmp, f"{name}.npz")]

        # the uninterrupted render and the one killed after its first
        # checkpoint run side by side (their files are apart)
        t0 = time.perf_counter()
        full_proc = subprocess.Popen(cmd("a"), cwd=HERE, stdout=subprocess.DEVNULL,
                                     stderr=subprocess.PIPE, text=True)
        ck = os.path.join(tmp, "b.npz")
        proc = subprocess.Popen(cmd("b"), cwd=HERE, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE)
        try:
            while not os.path.exists(ck) and proc.poll() is None:
                time.sleep(0.002)
            proc.kill()
        finally:
            proc.wait(timeout=60)
        t_kill = time.perf_counter() - t0
        err = full_proc.communicate(timeout=600)[1]
        if full_proc.returncode != 0:
            raise SmokeFailure(f"cli: exit {full_proc.returncode}: {err[-2000:]}")
        img = read_exr(os.path.join(tmp, "a.exr"))
        full, n_chunks, rays, _ = load_checkpoint(os.path.join(tmp, "a.npz"))
        log(f"[cli] uninterrupted: {time.perf_counter() - t0:.1f} s, image {img.shape} mean "
            f"{img.mean():.5f}, {n_chunks} chunks, {rays} rays")
        if img.shape != (64, 64, 3) or not np.isfinite(img).all() or not img.mean() > 0:
            raise SmokeFailure("cli: the written image is not a finite 64x64 render")
        cursor = load_checkpoint(ck)[1]
        log(f"[cli] killed after its first checkpoint: cursor {cursor} of {n_chunks} "
            f"({t_kill:.1f} s)")
        if not 1 <= cursor < n_chunks or os.path.exists(os.path.join(tmp, "b.exr")):
            raise SmokeFailure(f"cli: the second render was not stopped mid-way (cursor {cursor})")
        # the resume also exports the span trace and the metrics file, and
        # its first dispatch is poisoned: it rolls back to the checkpoint
        from tpu_pbrt_torch.obs.metrics import validate_exposition
        from tpu_pbrt_torch.obs.trace import validate_trace

        t0 = time.perf_counter()
        trace, prom = os.path.join(tmp, "b.json"), os.path.join(tmp, "b.prom")
        r = subprocess.run(cmd("b") + ["--trace", trace, "--metrics-path", prom,
                                       "--faults", f"dispatch:poison@chunk={cursor}"],
                           cwd=HERE, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise SmokeFailure(f"cli resume: exit {r.returncode}: {r.stderr[-2000:]}")
        resumed, n2, rays2, ctr2 = load_checkpoint(ck)
        same_film = all(np.array_equal(x.numpy(), y.numpy()) for x, y in zip(full, resumed))
        with open(os.path.join(tmp, "a.exr"), "rb") as fa, open(os.path.join(tmp, "b.exr"), "rb") as fb:
            same_img = fa.read() == fb.read()
        with open(trace) as f:
            doc = json.load(f)
        problems = validate_trace(doc)
        ev = doc["traceEvents"]
        begins = sum(1 for e in ev if e.get("name") == "render/slice" and e.get("ph") == "b")
        ends = sum(1 for e in ev if e.get("name") == "render/slice" and e.get("ph") == "e")
        backoffs = sum(1 for e in ev if e.get("name") == "render/backoff")
        with open(prom) as f:
            text = f.read()
        mproblems = validate_exposition(text)
        log(f"[cli] resumed with --trace --metrics-path --faults dispatch:poison@chunk={cursor}: "
            f"{time.perf_counter() - t0:.1f} s, cursor {n2}, {rays2} rays, chunks re-dispatched "
            f"{ctr2.get('chunks_redispatched', 0)}; film bit-identical {same_film}, image file "
            f"identical {same_img}; trace {len(ev)} events, problems {problems}, render/slice "
            f"spans {begins} opened / {ends} closed, backoff spans {backoffs}; metrics "
            f"{len(text)} bytes, problems {mproblems}")
        if not (same_film and same_img and n2 == n_chunks and rays2 == rays):
            raise SmokeFailure("cli: the resumed render differs from the uninterrupted one")
        if problems or mproblems or not begins or begins != ends or backoffs != 1 \
                or 'phase="device_wait"' not in text or ctr2.get("chunks_redispatched") != 1:
            raise SmokeFailure("cli: the trace, the metrics file or the injected fault is wrong")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 16 ------------------------------------------------------------------

#: seconds the recovery matrix may take on the card
CHAOS_TIMEOUT_S = 600


def chaos_start():
    """Start `python -m tpu_pbrt_torch.chaos` (the recovery matrix, on the
    card) in a subprocess: it runs beside `[infra]` and `[serve]`, whose
    host-bound work leaves the card and most cores idle. Returns
    (process, start time)."""
    return spawn([sys.executable, "-m", "tpu_pbrt_torch.chaos"])


def phase_chaos(started=None):
    """The recovery matrix on the card (see the module doc, phase 16):
    every row must PASS; prints each row and the `chaos_matrix` line."""
    out, err, rc, secs = collect(started or chaos_start(), CHAOS_TIMEOUT_S)
    rows = [ln for ln in out.splitlines() if ln.startswith("chaos ")]
    for ln in rows:
        log(f"[chaos] {ln}")
    try:
        matrix = json.loads(out.strip().splitlines()[-1])["chaos_matrix"]
    except (IndexError, KeyError, ValueError):
        raise SmokeFailure(f"chaos: no chaos_matrix line (exit {rc}): {err[-2000:]}") from None
    log(f"[chaos] {json.dumps({'chaos_matrix': matrix})} (exit {rc}, {secs:.1f} s since its "
        f"start)")
    if rc != 0 or matrix["failed"] or matrix["scenarios"] != 17 or len(rows) != 17:
        raise SmokeFailure(f"chaos: rows failed {matrix['failed']} (exit {rc}): {err[-2000:]}")
    return matrix


def beside_start():
    """Start the phases of BESIDE in a second process (`chip_smoke.py
    --beside ...`, its own CUDA context, four CPU threads), which runs
    beside the main process's `[crown]` to `[subsurface]`. Returns
    (process, start time)."""
    return spawn([sys.executable, os.path.join(HERE, "chip_smoke.py"), "--beside", *BESIDE],
                 env=dict(os.environ, OMP_NUM_THREADS="4"))


def beside_collect(started):
    """Wait for the second process and relay its lines. Returns {phase:
    its result}; fails unless it ended with code 0 after its result line."""
    out, err, rc, secs = collect(started, BESIDE_TIMEOUT_S)
    got = None
    for ln in out.splitlines():
        if ln.startswith(BESIDE_TAG):
            got = json.loads(ln[len(BESIDE_TAG):])
        else:
            log(ln)
    log(f"[beside] {', '.join(BESIDE)}: subprocess exit {rc}, {secs:.1f} s since its start")
    if rc != 0 or got is None or set(got) != set(BESIDE):
        raise SmokeFailure(f"beside: exit {rc}: {err[-3000:]}")
    return got


def run_beside(names) -> int:
    """The second process of a full run: the named phases, with the
    kernels the first process built; their results on the BESIDE_TAG
    line."""
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    fns = {"cloud": phase_cloud, "caustic": phase_caustic, "breadth": phase_breadth}
    try:
        got = {}
        for name in names:
            t = time.perf_counter()
            got[name] = fns[name]()
            log(f"[time] {name} (beside): {time.perf_counter() - t:.1f} s")
            torch.cuda.empty_cache()
        print(BESIDE_TAG + json.dumps(got), flush=True)
        return 0
    except Exception as e:  # noqa: BLE001 - every phase failure is fatal
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


PHASES = ("build", "check", "render", "analysis", "walkers", "crown", "direct", "samplers", "cloud",
          "caustic", "breadth", "textured", "motion", "subsurface", "infra", "serve", "cli",
          "mesh", "chaos")


def main(argv=()) -> int:
    if argv[:1] == ["--beside"]:
        return run_beside(argv[1:])
    only = set(argv)
    if only - set(PHASES):
        print(f"chip_smoke: unknown phases {sorted(only - set(PHASES))}; known: {PHASES}",
              file=sys.stderr)
        return 2

    def want(name):
        return not only or name in only or (name == "render" and "analysis" in only)

    if not (os.path.isdir(os.path.join(HERE, "tpu_pbrt_torch")) and os.path.exists(REF_IMAGE)
            and os.path.exists(CROWN_REF) and os.path.exists(CORNELL_REF)
            and os.path.exists(CLOUD_REF) and os.path.exists(BREADTH_REF.format("realistic"))
            and os.path.exists(TEXTURED_REF) and os.path.exists(TEXTURED_BDPT_REF)
            and os.path.exists(MOTION_REF) and os.path.exists(MOTION_BDPT_REF)
            and os.path.exists(MOTION_REF16) and os.path.exists(SUBSURFACE_REF)
            and os.path.exists(os.path.join(GOLDEN, "make_caustic_reference.py"))):
        print("chip_smoke: run from a checkout of the repo (tpu_pbrt_torch/, refimg/ and "
              "tests/torch_golden/ must sit beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    try:
        card = card_line()
        log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]}; {card}")
        t0 = time.perf_counter()
        phase_build()

        from tpu_pbrt_torch.scenes import compile_api, make_killeroo_like

        def timed(name, fn, *args):
            if not want(name.split()[0]):
                return None
            t = time.perf_counter()
            out = fn(*args)
            log(f"[time] {name}: {time.perf_counter() - t:.1f} s (total "
                f"{time.perf_counter() - t0:.1f} s)")
            torch.cuda.empty_cache()
            return out

        solo = None
        if want("check") or want("render"):
            t1 = time.perf_counter()
            api = make_killeroo_like(res=128, spp=256, maxdepth=5, device="cuda")
            scene, integ = compile_api(api)
            log(f"[scene] killeroo: {scene.n_tris} triangles, "
                f"{scene.dev['tstream'].n_treelets} treelets of "
                f"{scene.dev['tstream'].leaf_tris}, compiled in {time.perf_counter() - t1:.2f} s")
            kt = timed("check", phase_check, scene, integ)
            launches, flaunches, solo = (timed("render", phase_render, scene, integ)
                                         or (None, None, None))
            timed("analysis", phase_analysis, scene, integ, solo)
            del scene, integ
            torch.cuda.empty_cache()
        # [walkers] runs beside [mesh] in a full run (in a subprocess: the
        # walkers set the process's BVH knob, and the mesh's process only
        # waits for its ranks)
        walkers = walkers_start() if not only and want("mesh") else None
        if walkers is None:
            timed("walkers", phase_walkers)
        kt_mesh, mesh_daemon = timed("mesh", phase_mesh, solo if want("render") else None) \
            or (None, None)
        if walkers is not None:
            timed("walkers (beside [mesh])", walkers_collect, walkers)

        def daemon_seconds(secs):
            for v in kt_mesh.values():
                v["servemesh"]["daemon_seconds"] = secs

        if mesh_daemon is not None and not want("infra"):
            daemon_seconds(timed("mesh daemon", mesh_daemon))
            mesh_daemon = None

        # [cloud], [caustic] and [breadth] run in a second process beside
        # [crown] to [subsurface] in a full run
        second = beside_start() if not only else None
        if want("crown"):
            cscene, cinteg = timed("crown scene", crown_scene)
            ct, rays = timed("crown check", phase_crown_check, cscene, cinteg)
            timed("crown branch", phase_branch, cscene, rays)
            del rays
            claunches, c64_pool, c64_fixed, cres = timed("crown render", phase_crown_render,
                                                         cscene, cinteg)
            del cscene, cinteg
            torch.cuda.empty_cache()
        dt = timed("direct", phase_direct)
        timed("samplers", phase_samplers)
        if second is None:
            lt = timed("cloud", phase_cloud)
            kt_c = timed("caustic", phase_caustic)
            kt_b = timed("breadth", phase_breadth)
        kt_t = timed("textured", phase_textured)
        kt_m = timed("motion", phase_motion)
        kt_s = timed("subsurface", phase_subsurface)
        if second is not None:
            got = timed(f"{' '.join(BESIDE)} (beside [crown] to [subsurface])",
                        beside_collect, second)
            lt, kt_c, kt_b = (got[name] for name in BESIDE)
        # host-bound work runs beside [infra] and [serve], whose pools
        # leave the card and most cores idle: the recovery matrix's
        # subprocess and [mesh]'s `serve --mesh` daemon beside [infra],
        # [cli] (in a thread) beside [serve]; each is read after them
        from concurrent.futures import ThreadPoolExecutor

        chaos = chaos_start() if want("chaos") else None
        beside = ThreadPoolExecutor(2)
        try:
            t_side = time.perf_counter()
            mesh_job = beside.submit(mesh_daemon) if mesh_daemon is not None else None
            kt_i = timed("infra", phase_infra)
            cli_job = beside.submit(phase_cli) if want("cli") and want("serve") else None
            kt_v = timed("serve", phase_serve)
            for name, job in (("mesh daemon", mesh_job), ("cli", cli_job)):
                if job is not None:
                    out = job.result()
                    if job is mesh_job:
                        daemon_seconds(out)
                    log(f"[time] {name}: done {time.perf_counter() - t_side:.1f} s after "
                        f"[infra] began, beside it (total {time.perf_counter() - t0:.1f} s)")
            if cli_job is None:
                timed("cli", phase_cli)
        except BaseException:
            if chaos is not None:
                chaos[0].kill()
                chaos[0].wait()
            raise
        finally:
            beside.shutdown(wait=True)
        timed("chaos", phase_chaos, chaos)
        if only:
            log(f"[done] phases {sorted(only)}: total {time.perf_counter() - t0:.1f} s")
            return 0

        def kernel(name, source, replaces):
            crown = dict(ct[name], launches=claunches[name], launches_64_pool=c64_pool[name],
                         launches_64_fixed=c64_fixed[name], spp=CROWN_SPP,
                         mray_per_sec=cres.mray_per_sec)
            k = dict(name=name, route="cuda", source=source, replaces=replaces,
                     launches=launches[name], launches_fixed=flaunches[name], **kt[name],
                     crown=crown, direct=dt[name], cloud=lt[name], caustic=kt_c[name],
                     breadth=kt_b[name], textured=kt_t[name], motion=kt_m[name],
                     subsurface=kt_s[name], infra=kt_i[name], serve=kt_v[name],
                     mesh=kt_mesh[name], servemesh=kt_mesh[name].pop("servemesh"))
            k["max_abs_err"] = max(k["max_abs_err"], crown["max_abs_err"], dt[name]["max_abs_err"],
                                   lt[name]["max_abs_err"],
                                   kt_c[name]["connection"]["max_abs_err"],
                                   kt_c[name]["photon"]["max_abs_err"],
                                   kt_b[name]["max_abs_err"], kt_t[name]["max_abs_err"],
                                   kt_m[name]["max_abs_err"], kt_s[name]["max_abs_err"])
            if second is not None:
                k["timed_beside"] = SHARED_CARD
            return k

        kernels = [
            kernel("flush_chunk", "tpu_pbrt_torch/csrc/flush.cu",
                   "tpu_pbrt/accel/fusedwave.py:211"),
            kernel("expand", "tpu_pbrt_torch/csrc/expand.cu", "tpu_pbrt/accel/fusedwave.py:348"),
        ]
        log(f"[done] total {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"kernels": kernels}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except Exception as e:  # noqa: BLE001 - every phase failure is fatal
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for proc in CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
