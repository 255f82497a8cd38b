#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (liverrenderer_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, one JSON line each (then the kernels line, the card line and the
result line).  The sample counts below are the ones each phase was
written with; the constants CMP_SPP (the main path's comparison renders)
and GRAD_SPP (its gradients) and the other *_SPP constants set the
current ones, and each line reports the spp it ran:
  device           card name and power limit (nvidia-smi), torch and CUDA,
                   and the published peaks the bounds below are taken from
  build            nvcc build of csrc/intersect.cu: seconds, ptxas report
  kernel_vs_plain  the closest-hit kernels (sweep + merge) against their
                   plain PyTorch version, in three regimes:
                   (a) K1: the 5,120-triangle liver proxy, 65,536 rays
                   (b) K2: ~100k random small triangles, 16,384 rays
                   (c) ties: duplicate and coplanar triangles hit at equal
                       t inside a chunk, across chunks and across splits
                   hit-set and prim agreement, max |dt|, the split of the
                   chunk range, median ms of the query (sweep + merge) and
                   of the sweep alone, and the bounds: bound_dense_ms (38
                   FLOP for every ray x every real triangle), needed_tests
                   (the real triangles of the chunks whose box each ray
                   enters before its maxt), candidate_tests (the needed
                   pairs whose plane the ray crosses before its closest
                   hit), bound_needed_ms (11 FLOP of prefilter per needed
                   pair, the other 27 per candidate) and share =
                   bound_needed_ms / ms
  merge_vs_plain   the merge kernel alone against its plain version on the
                   K1 regime's per-split partials
  render_small     the port's render through the kernels against the same
                   render on the CPU (plain version), per pixel
  render           the liver proxy at 428x240, 64 spp, depth 12, through
                   liverrenderer_tpu_torch.render: seconds, paths/s, image
                   checks and the kernel launches of this run
  render_kernel    a separate 8 spp render with CUDA events around every
                   intersect_closest call: ms per launch on the main path's
                   own rays, the kernels' share of the wall time, the same
                   rays replayed back to back, their bound, and the kernels
                   against the plain version on them (short hits included)
  grad_small       render_grad of the small proxy's media.params on the
                   card against the same gradient on the CPU (plain version)
  render_grad      the liver proxy at 428x240, 16 spp, depth 12, through
                   liverrenderer_tpu_torch.render_grad (loss = mean image,
                   d/d media.params): median seconds of 3 after a warm-up,
                   fwd+bwd paths/s and its cost per path against a 16 spp
                   primal timed in the same call, the sweep and merge
                   launches of the stored forward and of the replay walk,
                   peak device memory
  render_grad_trace  torch.profiler over a 2 spp render_grad: device busy
                   and idle share, kernel launches per regen iteration,
                   the top device ops
  fog_small        the fog Cornell box (next-event estimation, the
                   Beer-Lambert shadow branch) at 32x32, 4 spp, depth 6 on
                   the card against the CPU render
  nee_walk_small   the fog-cube plane scene (the ratio-tracked shadow walk
                   and medium NEE) on the card against the CPU: the image
                   and the media.params gradient
  fog_render       the fog Cornell box at 540x540 (cut from 1080x1080),
                   2 spp, depth 16 (BASELINE's
                   cornell_box_1080x1080_fog_st_albedo):
                   seconds, paths/s, image checks, sweep and merge launches
                   split into bounce and shadow queries; torch.profiler
                   over a 256x256 1 spp render of it (one full wavefront):
                   host kernel launches per regen iteration, device busy
                   and idle share
  shadow_kernel    the shadow queries of a 1 spp fog render, captured and
                   held against the plain version (hit agreement, ms per
                   launch in the render and replayed, bound as in
                   kernel_vs_plain), and shadow rays to a point light on
                   the liver proxy, whose split chunk range runs the merge
  fog_render_grad  render_grad of the fog Cornell box's mean image at
                   540x540, 1 spp, d/d media.params (the tiled replay
                   schedule): seconds of one run after a warm-up, fwd+bwd
                   paths/s and its cost per path against a 1 spp primal in
                   the same call, launches, peak device memory
  bump_env_small   the bumped, sky-lit liver proxy (a height map on the
                   dielectric, a lat-long envmap) at 16x12, 4 spp on the
                   card against the CPU: image, and the media.params and
                   emitters.params gradient
  env_nee_small    a diffuse plane lit by the envmap alone (NEE samples its
                   2-D importance map) on the card against the CPU: image
                   and the emitters.params gradient
  bump_env_render  the bumped, sky-lit liver proxy at 428x240, 64 spp, depth
                   12 (bench.py's workload path; 1,024^2 height map, 1,024
                   x 512 sky): seconds, paths/s, image checks, sweep and
                   merge launches, peak memory, then the plain proxy
                   (the ratio compares them within this call); host
                   launches per iteration of both from torch.profiler
  bump_env_render_grad  render_grad of its mean image at 16 spp, d/d
                   media.params: seconds of one run after a warm-up
                   against a 16 spp primal in the same call, launches of
                   the stored forward and the replay walk, peak memory
  cornell_small    BASELINE's Cornell box (path, depth 8) at 32x32, 4 spp
                   on the card against the CPU: its gaussian filter on the
                   fixed wavefront, a box filter on the regenerating one
  bsdf_small       the gradient tests' plane (path, depth 3) at 12x12, 8 spp
                   under each stock BSDF and wrapper (thindielectric,
                   conductor, roughconductor, plastic, roughplastic,
                   pplastic, roughdielectric, twosided, blendbsdf, mask),
                   card against CPU; the textures.data gradient of the
                   diffuse plane (box filter: the replay adjoint; gaussian:
                   the scan adjoint) and the bsdfs.params gradient of the
                   rough conductor
  wide_kernel      the sweep kernel on the Cornell box's full camera
                   wavefront and its first shadow query (4,194,304 rays
                   each, one launch) against the plain version run in
                   blocks of 262,144 rays: agreement, ms, bound, share
  cornell_render   the Cornell box at 256x256, 64 spp, depth 8, gaussian:
                   one fixed pass of 4,194,304 lanes (median of 3 after a
                   warm-up), in turns with bench.py's box-filter variant
                   on the regenerating wavefront: seconds, paths/s, image
                   checks, bounce and shadow sweeps, peak memory, and
                   torch.profiler's launches per iteration and device idle
                   share of each
  cornell_render_grad  render_grad of its mean image with respect to
                   textures.data at 16 spp: the box variant through the
                   replay adjoint, the gaussian scene through the scan
                   adjoint (its primal's fixed pass, then the
                   differentiated one), each against a 16 spp primal in
                   the same call, launches, peak memory, and the two
                   routes' gradients held to each other
  xml_files        bench.py's workload path (the bumped, sky-lit proxy at
                   428x240, 64 spp) written as scene.xml, a binary PLY
                   mesh, a 1,024^2 8-bit PNG height map and a 1,024 x 512
                   half EXR sky (tests/torch_xml_files.py): the files'
                   bytes, the seconds to read each, and load_file's
                   seconds against load_dict's of the arrays read back
  xml_small        that scene at 16x12, 4 spp, loaded from its files on
                   the card against on the CPU: image and media.params
                   gradient
  xml_render       the full-size scene loaded and rendered from the files
                   and from the dict of the arrays read back (file, then
                   dict): seconds, paths/s, xml_over_dict (render seconds,
                   file over dict), the images bit-identical in
                   deterministic mode, sweep and merge launches, peak
                   memory; a 16 spp render_grad of the loaded scene (one
                   run after a 2 spp warm-up) against a 16 spp primal
  emitters_small   the gradient tests' plane (path, depth 3) at 12x12, 8 spp
                   under a directional, a spot and a projector light (its
                   slide a PNG file), card against CPU
  samplers_small   the plane under each pattern sampler (stratified,
                   multijitter, orthogonal, ldsampler) at 4 and 8 spp and
                   each new filter (mitchell, catmullrom, lanczos), card
                   against CPU; a rough conductor's bsdfs.params gradient
                   through the scan adjoint under a mitchell filter; the
                   Cornell box's 64 spp fixed pass with a lanczos filter
                   against its gaussian, in turns
  media_small      the stock media at 16x16, 4 spp on the card against the
                   CPU: a grid cube (16^3 smoothed noise) under a point
                   light with its media.grids gradient (the voxels at the
                   grid's maximum, whose gradient blows up in both
                   packages, must be the same; the rest by cosine and
                   norm), the same cube with each extended phase
                   (rayleigh, blendphase, tabphase, sggx), the grid
                   Cornell box, and volpathmis on the chromatic fog (with
                   its media.params gradient, scan adjoint) and on the
                   liver proxy (bio media)
  grid_render      the fog Cornell box's layout with a null-BSDF cube of a
                   256^3 smoothed-noise grid medium (scale 4, albedo 0.8,
                   HG g 0.5) in place of its fog, cut to depth 8, 256x256
                   at 1 spp (one full regen wavefront; GRID_RES says why):
                   seconds, Mpaths/s, iterations, bounce and shadow
                   sweeps, peak memory; profiles of it and of the same
                   cube of homogeneous fog at the grid's mean density
                   (launches per iteration, device idle share, iterations
                   against the homogeneous fog); its 1 spp media.grids
                   render_grad: seconds, peak memory, gradient norm and
                   share of non-zero voxels
  volpathmis_render  test_volpathmis.py's chromatic fog on the Cornell box
                   at 540x540, depth 16, 2 spp: volpathmis on one fixed
                   pass in turns with volpath (regen): seconds, the ratio,
                   peak memory, image means per channel, sweeps; the
                   per-pixel variance over 4 seeds at 32x32, 4 spp of each
  bvh_query        the liver proxy mesh at subdiv 9 (5,242,880 triangles,
                   past 2^21): scene and C++ BVH build seconds, one
                   65,536-ray query through the lockstep BVH traversal,
                   a 16x12 1 spp render; at subdiv 8 (1,310,720) the same
                   rays through intersector="bvh" and the sweep kernel in
                   turns: seconds, hit and prim agreement, t
  sss_small        subsurface scattering at test size, card against CPU
                   (the VAE a seeded synthetic model at the published
                   widths, written to a temporary directory and read by
                   ssub/vae.load_model): a vaescatter and a dipole sphere
                   and the vaescatter liver proxy at subdiv 2 (images); the
                   vaescatter sphere's emitters.params gradient through the
                   scan adjoint; one subsurface_event on 4,096 fixed lanes
                   (its masks and sampler dimensions)
  sss_kernel       the sweep and merge kernels against their plain version
                   on the SSS event's own queries, captured from the first
                   event of the full-size render's warm-up: the
                   zero-scatter rays, the four projection queries (two
                   bounded by 2 kernel eps, two unbounded), the exit
                   shadow rays; agreement, ms, bound and share per query
  sss_render       the vaescatter liver proxy (scene/liver_proxy.
                   sss_liver_dict: path depth 12, tent, ldsampler, a point
                   light and the sky) at 428x240, 16 spp on regen: build
                   and render seconds, paths/s, iterations, sweep launches
                   split into bounce, SSS event, exit shadow and NEE
                   shadow, peak memory, the plain twin (its dielectric
                   alone) timed after it (sss_over_plain), launches per
                   iteration and device idle of a 2 spp CUDA-only profile,
                   and what the events of a 1 spp render did (pass-through,
                   VAE exit, absorbed, died)
  dipole_render    the dipole proxy at the same size: build seconds (point
                   cloud and irradiance), render seconds, launches
  sss_render_grad  emitters.params of the vaescatter proxy at 428x240,
                   4 spp through the scan adjoint: seconds against a 4 spp
                   primal, peak memory, launches
  codecs           the committed PIZ sky (tests/data/torch_sky_piz.exr,
                   written by OpenEXR) decoded on the card's host with the
                   C++ Huffman loop, with its plain Python loop, and its
                   ZIP twin: seconds, bytes, each bit-identical to
                   sky_map(1024, 512) in half
  cli_render       the slice's main path: bench.py's workload path written
                   to files with the PIZ sky, rendered by `python3 -m
                   liverrenderer_tpu_torch.cli scene.xml -o out.exr --spp
                   64` in a subprocess: its outputs (EXR, PNG, time.txt),
                   time.txt's and its closing line's seconds and paths/s,
                   its EXR against the in-process render of
                   load_file(scene.xml) (whose launches are counted),
                   load_file of the PIZ- and the ZIP-skied scene in turns
                   (piz_over_zip), and --aovs depth,position,sh_normal,
                   albedo at full width
  render_control   the bumped, sky-lit proxy at 428x240, 64 spp with an
                   uncancelled RenderControl after the plain render
                   (control_over_plain, the images agreeing), and a control
                   that cancels at half the progress on a film split into
                   tiles of 32,768 pixels: it stops, its frame is finite,
                   the tiles it did not reach are black
  sensors_small    each sensor type (radiancemeter, distant with and
                   without a target, irradiancemeter, batch, thinlens,
                   orthographic, perspective) at 16x12 or less, card
                   against CPU
  thinlens_render  the bumped, sky-lit proxy through a thinlens at 428x240,
                   64 spp: two fixed-wavefront passes of 3,287,040 lanes;
                   seconds, peak memory, launches, and the ratio to the
                   perspective regen render of render_control
  pipeline_render  the fork's liver pipeline at bench.py's workload size:
                   pipeline.driver.main(settings, --scenes-dir, --out-dir)
                   on a RendererSettings.yml of 428x240, 64 spp, "Max
                   Depth " 12 and the reference's tissue defaults, with
                   seeded synthetic spectra tables
                   (tests/torch_pipeline_inputs.py) and the bumped,
                   sky-lit proxy written as Liver-SingleMesh's scene
                   files: the coefficients' seconds, time.txt's load and
                   render seconds, paths/s, launches; its EXR against the
                   render of load_file with the coefficients written into
                   the liver row by hand, and against the unsubstituted
                   render (it must differ)
  pipeline_small   the driver at 16x12, 4 spp on the card against --cpu
  evaluate_render  pipeline.evaluate.main at its defaults (downsample 4:
                   428x240, 64 spp, the 16 spp denoise probe) on the
                   Liver-SingleMesh row against a golden PNG rendered by
                   the port at 1712x960, 4 spp, seed 9 and tonemapped:
                   rmse, ssim, seconds, paths/s, the noisy and denoised
                   metrics (the denoised rmse must be lower); the
                   learned-SSS row (the soap substitute, the silhouette
                   query, a synthetic VAE) at 64x48, 16 spp against an
                   EXR golden
  denoise_small    atrous_denoise and denoise_render card against CPU at
                   16x12
  inverse_render   Adam on the liver row's substituted columns (started at
                   twice their value) toward a 64 spp target, 4 steps of
                   a 16 spp render_grad at 428x240, a checkpoint after
                   each (keep 3); a fresh optimizer resumes from step 2:
                   seconds and fwd+bwd paths/s per step, losses, peak
                   memory, the steps on disk, the resumed parameters'
                   largest difference
  largesteps       LargeSteps.from_differential and its gradient on the
                   liver mesh at subdiv 4 and 8 (655,362 vertices), card
                   against CPU: CG iterations, ms
  spectral_small   the spectral variant (hero-wavelength packets) at test
                   size, card against CPU: the bumped, sky-lit proxy at
                   16x12 (image and its media.params replay gradient), the
                   fog Cornell box (volpath, NEE) and the spectral Cornell
                   box's render_specfilm bins
  spectral_render  the main path in the spectral variant at full size
                   (428x240, 64 spp, biovolpath depth 12, bump and sky) in
                   turns with the RGB render (rgb, spectral): seconds,
                   paths/s, spectral_over_rgb, iterations
                   (= sweeps), merges, peak memory, launches per iteration
                   and device idle of a 2 spp profile of each, and the
                   mean-luminance ratio of the two images (within 15 %)
  spectral_render_grad  its 16 spp render_grad of media.params on the
                   replay adjoint (packet-space pool): seconds of one run
                   after a warm-up against a 16 spp spectral primal, peak
                   memory, forward and replay launches
  specfilm_render  BASELINE's Cornell box (256x256, path depth 8) in the
                   spectral variant: render_specfilm at 64 spp, 16 bins
                   (passes of 2^20 lanes): seconds, passes, launches; the
                   bins integrated against CIE Y against the spectral
                   render's mean luminance (within 5 %)
  m10_small        the light tracer, polarized transport and the splat
                   radiance field at test size, card against CPU:
                   render_ptracer of the Cornell box at 16x16;
                   render_stokes of a polarizer-retarder-polarizer stack
                   and of a gold mirror, RGB and spectral (per pixel and
                   Stokes component); three splats (volprim_rf_basic, SH
                   degree 2): image, volprims.opacity and volprims.sh
                   gradients through the scan adjoint
  ptracer_render   BASELINE's Cornell box (256x256, 64 spp: 1,048,576
                   light paths, depth 8) through render_ptracer: seconds
                   (two runs), light paths/s, sweeps, peak memory, a
                   profile (launches per step, device idle), and its mean
                   against `path` on the same scene with hide_emitters,
                   timed in turns (within 5 %)
  stokes_render    the Cornell box with a smooth gold large box under
                   stokes, 256x256, 64 spp, depth 8: seconds, paths/s,
                   peak memory, sweeps, launches per bounce and device
                   idle of a profile; S0's mean against `path` (within
                   5 %); the DOP on the gold block's pixels, and behind a
                   polarizer at 30 deg filling the view (in (0, 1]); the
                   spectral x polarized variant in turns with RGB
                   (spectral_over_rgb, the linear DOP within 0.08, S0
                   within 15 %)
  volprim_render   16,384 seeded ellipsoids (1,310,720 triangles: K2's
                   regime; SH degree 3, srgb) at 428x240, 4 spp, max_depth
                   64: build seconds, seconds, paths/s, iterations, sweep
                   and merge launches, splits per query, ms per query on
                   the render's own rays (CUDA events) beside its bound,
                   the kernels against the plain version on 16,384 rays of
                   one query, a profile (device idle), and a 1 spp
                   render_grad of volprims.opacity and volprims.sh (scan
                   adjoint) against a 1 spp primal, peak memory
  shape_small      the vertices key at test size, card against CPU: the
                   vertex gradient of render_grad (replay adjoint plus
                   both boundary terms) on tests/test_projective.py's
                   occluder at 16^2 and the bumped, sky-lit proxy at 16x12,
                   4 spp (cosine, norms); the primary boundary term's
                   32,768 uniform samples: the same edges, the share of
                   samples with the same visibility and side
  projective_fd    the JAX tests' finite-difference gates on the card: the
                   occluder at 24^2 (render_grad 128 spp against central
                   FD at 512 spp, fd < -0.5, rtol 0.2) and the rough
                   mirror (64 spp, rtol 0.35)
  shape_grad       the vertex gradient of the bumped, sky-lit proxy at
                   428x240, 16 spp, biovolpath depth 12: the faster of 2
                   runs after a warm-up, split into the replay adjoint, the
                   primary and the indirect boundary term, the sweep and
                   merge launches of each boundary round, peak memory, the
                   media.params render_grad in turns (vertices_over_media),
                   the share of silhouette vertices with a non-zero
                   gradient
  shape_optimize   2 Adam steps on LargeSteps' latent (lambda 19) of the
                   same proxy toward its vertices scaled by 1.03 about
                   their centroid: seconds per step, the image loss at a
                   fixed seed and the mean vertex distance before and
                   after (both must fall)
  principled_small principled (clearcoat and sheen, anisotropic,
                   spec_trans seen from both sides), principledthin and a
                   measured plate (a seeded synthetic RGL file the phase
                   writes) at 32x32, 16 spp, card against CPU
  principled_render  BASELINE's Cornell box with a principled tall block
                   and a principledthin short block, 256x256, 64 spp, path
                   depth 8, gaussian (one fixed pass), in turns with the
                   diffuse box (principled_over_diffuse): seconds, peak
                   memory, launches per bounce, a profile of each (device
                   idle)
  m10b_small       the rest of M10 at test size, card against CPU: the
                   sun-lit bumped proxy (and its media.params gradient),
                   the mesh-attribute quad and the volume-textured wall,
                   4 instances (and the bsdfs.params gradient of their
                   rough-plastic cap), a 32^3 SDF sphere, a 24-strand hair
                   tuft; the instance pass and the SDF march on 16,384
                   camera rays (hit sets, prims, t)
  sunsky_render    the main path (the bumped proxy, 428x240, 64 spp,
                   biovolpath depth 12) under a Preetham sunsky, timed
                   against the synthetic-sky render (sunsky_over_envmap);
                   its 16 spp media.params render_grad
  texture_render   BASELINE's Cornell box (256x256, 64 spp, gaussian: one
                   fixed pass) with a vertex-coloured block and a
                   volume-textured block, in turns with the plain box
  instanced_render 100 instances of tests/test_instancing.py's group under
                   the constant light, 256x256, 64 spp, depth 8 (regen),
                   against the flattened twin (instanced_over_flattened,
                   the images' mean difference < 2e-3): host syncs and
                   pairs of the instance pass, its launches and seconds
                   on one query of 65,536 camera rays, peak memory and
                   geometry bytes; 16 instances of the liver proxy
                   (flattened past 65,536 triangles: K2) at 128^2, 4 spp
  sdf_render       a seeded 64^3 lumpy SDF sphere on the Cornell box,
                   256x256, 16 spp: seconds against the plain box, the
                   march's steps per query, and its launches and seconds
                   on one query of 65,536 camera rays
  hair_render      400 seeded B-spline strands (172,800 tube triangles:
                   K2's regime) with the hair BSDF, 256x256, 16 spp, depth
                   8, gaussian: seconds, ms per query on its own rays (CUDA
                   events) beside the bound from 16,384 of them, the
                   kernels against the plain version on those
  apps_small       the progressive viewer (ema, accum with an orbit,
                   denoise) and the scripted interactive loop on a 16x16
                   Cornell box, card against CPU frame by frame, the final
                   blit (each channel within one 8-bit level) and the
                   cameras (equal)
  viewer_render    run_viewer on the main path (the bumped, sky-lit proxy
                   at 428x240, depth 12), 8 ema frames and 4 denoise frames
                   at 1 spp: seconds per frame, the phase report's stages,
                   each ema frame's mean error against the 64 spp render
                   (falling), sweeps and merges per frame
  interactive_render  run_interactive on the main path's scene at 160x88
                   and 428x240 with scripted keys and the blit on: ms per
                   render, host copy and blit, accumulation restarts
  sharded_small    parallel/mesh.py as an NCCL world of one on the card
                   (the proxy at 16x12, 4 spp): render_sharded,
                   render_tiled (both layouts), render_regen_sharded and
                   render_grad_replay_sharded against the unsharded
                   functions, one make_train_step SGD step against the
                   scan adjoint, each call's collectives and bytes
  sharded_render   two ranks on the one card over gloo (a worker script in
                   subprocesses): the main path's 16 spp
                   render_regen_sharded and render_grad_replay_sharded
                   against one rank's, per-rank seconds, launches and
                   collectives, measure_scaling's proxy (host overlap)
  m9_decode        the committed DWAA sky and JPEG height map decoded on
                   the card's host, in turns with the PIZ sky and the PNG
                   height map (dwa_over_piz, jpeg_over_png), held to them
                   within the lossy bounds, and the plain decode loops
                   against the C++ ones
  m9_obj           the liver proxy at 327,680 triangles written as OBJ:
                   the C++ parse against its plain version (bit for bit),
                   both times
  m9_small         bench.py's workload path from XML with a 32^2 JPEG height
                   map and the DWAA sky at 16x12, 4 spp: card against CPU
  m9_render        the same at 428x240, CMP_SPP, in turns with its PNG +
                   PIZ twin (m9_over_png_piz), launches
  m9_phases        the seconds the m9 phases took
  m9b_decode       the committed LZW TIFF height map and GIF floor decoded
                   on the card's host in turns with the PNG height map
                   (tiff_over_png_decode), the TIFF equal to the map's
                   8-bit codes, and the plain LZW loops against the C++
                   ones
  m9b_small        bench.py's workload path from XML with a 32^2 TIFF
                   height map and a GIF-textured floor at 16x12, 4 spp:
                   card against CPU
  m9b_render       the same at 428x240, CMP_SPP, from the committed files,
                   in turns with its PNG twin (tiff_over_png), launches
  m9b_write        write_image of that render to .tif and .qoi, read back
                   equal to the dithered 8-bit pixels
  m9b_phases       the seconds the m9b phases took
  m9c_decode       the committed lossy WebP height map, BC7 DDS floor,
                   lossless RGBA WebP and animated WebP decoded on the
                   card's host in turns with the PNG height map
                   (webp_over_png_decode), the WebP height within its
                   bound of the PNG's codes, the DDS floor equal to its
                   committed PNG twin, and the plain VP8 / VP8L / BC7
                   loops against the C++ ones (on the 64^2 files, a 256^2
                   crop of the height map and 16 rows of the floor)
  m9c_small        bench.py's workload path from XML with a 32^2 WebP
                   height map and the DDS floor at 16x12, 4 spp: card
                   against CPU
  m9c_render       the same at 428x240, CMP_SPP, from the committed files,
                   in turns with its PNG twin (webp_dds_over_png), launches
  m9c_write        write_image of that render to .dds, read back equal to
                   the dithered 8-bit pixels
  m9c_phases       the seconds the m9c phases took
  m9d_decode       the committed arithmetic-coded 1,024^2 height map, CMYK
                   JPEG and YCbCr JPEG-in-TIFF floor decoded on the card's
                   host in turns with the PNG height map
                   (arith_over_png_decode), the height within its bound of
                   the PNG's codes, the CMYK file and the floor equal to
                   their committed PNG twins, and the plain arithmetic
                   loop against the C++ one (on a 128^2 crop and the 32^2
                   map)
  m9d_small        bench.py's workload path from XML with the 32^2
                   arithmetic height map and the TIFF floor at 16x12,
                   4 spp: card against CPU
  m9d_render       the same at 428x240, CMP_SPP, from the committed files,
                   in turns with its PNG twin (arith_tiff_over_png),
                   launches
  m9d_phases       the seconds the m9d phases took
  total            the script's seconds so far (every line's at_s: the
                   script's seconds at its end)
  kernels          every kernel of the path with the TPU kernels it
                   replaces, its launches (render + render_grad + fog
                   render + fog render_grad + bumped render + bumped
                   render_grad + the Cornell renders and gradients + the
                   XML-loaded render and its gradient + the grid render
                   and gradient + the volpathmis and volpath renders of
                   the chromatic fog + the vaescatter proxy, its plain
                   twin, the dipole proxy and the vaescatter gradient +
                   the CLI scene's in-process render, the render_control
                   renders and the thinlens render + the driver's render,
                   the evaluation's rows and the inverse-rendering loop +
                   the spectral render, its gradient, the spectral
                   Cornell render and its specfilm + the ptracer, stokes
                   and volprim renders and the volprim gradient + the
                   shape and principled phases' runs + the rest of
                   M10's: m10b_small, the sunsky render and gradient, the
                   textured, instanced, SDF and hair renders + the
                   viewer's and the interactive loop's frames and the
                   sharded renders and gradients (every rank) + the
                   m9 render and its PNG + PIZ twin + the m9b, m9c and
                   m9d renders and their PNG twins; the hair
                   tuft's query in K2's regime beside its bound),
                   agreement, times and bound
The last line is {"ok": true, "device": {...}}.  Any failed check exits
non-zero before it.  Without a CUDA device the script exits 2.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import warnings

WIDTH, HEIGHT, SPP, SUBDIV, SEED = 428, 240, 64, 4, 0
# the spp of the main path's comparison renders in later phases (file
# against dict, timed and in deterministic mode, the CLI and its
# in-process twin, RenderControl against the plain render, the pipeline
# driver against the render by hand and its evaluation, spectral against
# RGB, the sunsky against the envmap, the m9 to m9d files against their
# twins): cut from
# SPP for the script's time (64 -> 16 when the script took 1,331 s of its
# 1,200 s limit on an H100 whose host ran ~1.3x slower than the fastest
# seen; 16 -> 4 when it took 1,133-1,199 s on such hosts with the m9b
# phases; xml_render's timed pair 64 -> 4 when the m9d phases brought the
# script to 1,043 s on such a host); their gates compare equal
# computations or means over ~10^5 pixels and hold at any spp; the render
# and bump_env_render phases keep bench.py's 64
CMP_SPP = 4
KERNEL_SPP = 8                 # render_kernel phase
# the gradients' spp: bench.py's 16, cut to 8 with CMP_SPP (the phases'
# gates compare equal computations, finiteness and launches); the shape
# phases keep 16 (their gates need the silhouette's boundary samples and
# a falling loss)
GRAD_SPP = 8
SHAPE_SPP = 16
TRACE_SPP = 2                  # render_grad_trace phase
TIE_T, TIE_R = 40_000, 16_384  # ties regime
# the fog Cornell box: BASELINE's depth 16, 2 spp for the primal and 1
# for the gradient, timed once after a warm-up; its film cut from
# BASELINE's 1080x1080 to 540x540 (its host-bound walk runs at ~0.2
# Mpaths/s, ~6.6 bounces per path: the 1080^2 primal, gradient and their
# warm-ups took ~50-60 s of the script's 1,200 s limit, which the
# pipeline's phases need; 540^2 still tiles the gradient, in 2 walks)
FOG_RES, FOG_SPP, FOG_GRAD_SPP, FOG_DEPTH = 540, 2, 1, 16
FOG_TRACE_SPP = 1              # fog_render's profile, shadow_kernel
FOG_TRACE_RES = 256            # fog_render's profile: one full wavefront
FOG_SMALL = (32, 4, 6)         # fog_small: film, spp, depth
WALK_SMALL = (12, 16)          # nee_walk_small: film, spp
# bump_env_small: the proxy at subdiv 2 with a 32^2 height map at the
# full-size scale and a 64 x 32 sky; env_nee_small: film, spp
BUMP_SMALL, SKY_SMALL, ENV_NEE_SMALL = (32, 0.05), (64, 32), (12, 8)
BUMP_TRACE_SPP = 2             # bump_env_render's profiles
# BASELINE's Cornell box: 256x256, 64 spp, path depth 8, its gaussian
# filter (one fixed pass of 4,194,304 lanes), against bench.py's box-filter
# variant on the regen wavefront; the gradients at 16 spp
CORNELL_RES, CORNELL_SPP, CORNELL_DEPTH = 256, 64, 8
CORNELL_GRAD_SPP = 8            # both adjoints on the same samples
CORNELL_TRACE_SPP = 8          # the regen variant's profile
CORNELL_SMALL = (32, 4)        # cornell_small: film, spp
BSDF_SMALL = (12, 8)           # bsdf_small: film, spp
# emitters_small, samplers_small: film, spp; the pattern samplers at a
# square and a non-square sample count
EMITTER_SMALL = (12, 8)
SAMPLER_SPP = (4, 8)
# wide_kernel: the plain version runs in blocks of this many rays
WIDE_BLOCK = 1 << 18
# the stock media: the fog Cornell box's layout with a grid cube of a
# 256^3 smoothed-noise density (scale 4, albedo 0.8, HG g 0.5) in place of
# its fog.  Cut from the fog's 1080^2 film to 256^2 at 1 spp, one full
# regen wavefront of 65,536 lanes: every lane runs to the 64-iteration cap
# and each iteration walks ~31 NEE steps (~18,800 host launches), so a
# path costs ~0.3 ms (3,240 paths/s on the card) and 1080^2 at 2 spp
# would take ~12 min alone.  The primal, its profile, the same cube of
# homogeneous fog and the media.grids gradient all at that size.  Its
# depth is cut from the fog box's 16 to 8: at 16 the phase took ~128 s of
# a script run that passed 850 s on an H100 with the spectral phases;
# every lane runs to the 4 * depth iteration cap, and at 8 it took 46 s
# (80 s on PR 17's slower host, where the script passed its limit): 4
GRID_RES, GRID_SPP, GRID_GRAD_SPP, GRID_N = 256, 1, 1, 256
GRID_DEPTH = 4
# volpathmis on test_volpathmis.py's chromatic fog, in turns with volpath,
# at 540^2 (cut from 1080^2: volpath's two host-bound regen renders took
# 24-42 s); the per-pixel variance over VAR_SEEDS seeds at VAR_RES^2,
# VAR_SPP spp
CHROMA = (0.9, 0.3, 0.05)
MIS_RES, MIS_SPP, MIS_DEPTH = 540, 2, 16
VAR_RES, VAR_SPP, VAR_SEEDS = 32, 4, 4
# bvh_query: the liver proxy past 2^21 triangles (subdiv 9: 5,242,880) and
# at subdiv 8 (1,310,720), where the sweep kernel serves it too
BVH_SUBDIV, BVH_CMP_SUBDIV, BVH_RAYS = 9, 8, 65536
# subsurface scattering: the vaescatter liver proxy (scene/liver_proxy.
# sss_liver_dict, subdiv 4, path depth 12, tent, ldsampler, point light and
# sky) at 428x240: the primal, its plain twin and the dipole at SSS_SPP,
# the scan-adjoint gradient at SSS_GRAD_SPP, a profile at SSS_TRACE_SPP;
# sss_small: film, spp; SSS_EVENT_LANES lanes of one event card vs CPU
SSS_SPP, SSS_GRAD_SPP, SSS_TRACE_SPP = 8, 4, 2
SSS_SMALL = (16, 4)
SSS_EVENT_LANES = 4096
# the command-line renderer (cli_phases): decode reps of the PIZ sky, the
# CLI subprocess's time limit, the AOVs it writes at full width, and the
# share of its pixels that must agree with the in-process render (the
# splat's atomics differ in the last bit); RenderControl's cancel run
# splits the film into tiles of CONTROL_TILE_PIX pixels; the thinlens
# of thinlens_render, focused near the liver
CODEC_REPS = 3
CLI_TIMEOUT = 600
CLI_AOVS = ("depth", "position", "sh_normal", "albedo")
CLI_PIX_FRAC = 0.99
CONTROL_TILE_PIX = 1 << 15
THINLENS = {"aperture_radius": 0.05, "focus_distance": 5.0}
# the fork's liver pipeline (pipeline_phases): the driver's settings at
# bench.py's workload size (RendererSettings.yml's own 1920x1080 at 256
# spp is ~80x the paths, ~10 min on the card: cut for the time limit); the
# evaluation's golden at 4x that film, 4 spp (64 per evaluated pixel
# after the 4x downscale; 16 spp took ~46 s on an H100), tonemapped
# to a PNG; its SSS
# row at a small film and spp; the inverse-rendering loop's target spp,
# Adam steps, learning rate, checkpoints kept and the step it resumes
# from; the LargeSteps meshes (liver_mesh subdivisions)
PIPE_DEPTH = 12
PIPE_SMALL = (16, 12, 4)
GOLDEN_SCALE, GOLDEN_SPP, GOLDEN_SEED = 4, 4, 9
EVAL_SSS = (64, 48, 16)
# inverse_render: 3 steps keeping 2 (4 keeping 3, and a 64 spp target,
# before PR 17's cuts for the script's time), resumed from step 2
INV_TARGET_SPP, INV_STEPS, INV_LR, INV_KEEP, INV_RESUME = 16, 3, 1e-2, 2, 2
INV_SEED = 100
INV_RESUME_RTOL = 1e-5
LARGESTEPS_SUBDIVS = (4, 8)
LARGESTEPS_RTOL = 1e-5
DENOISE_RTOL, DENOISE_ATOL = 1e-5, 1e-6
# the spectral variant: spectral_small's proxy film and spp, its fog box
# (film, spp, depth); specfilm_render's bins (the film, spp and depth are
# BASELINE's Cornell box's); the gates the JAX package's own spectral
# tests set: the luminance of the spectral main path against RGB (within
# 15 %, test_spectral_biovolpath_runs_and_matches) and the specfilm's
# energy against the spectral render's luminance (5 %,
# test_specfilm_energy_consistent)
SPEC_SMALL, SPEC_FOG_SMALL = (16, 12, 4), (16, 4, 6)
SPECFILM_BINS = 16
SPEC_LUM_RTOL, SPECFILM_RTOL = 0.15, 0.05

# the light tracer, polarized transport and the splat radiance field
# (m10_phases): m10_small's film and spp; BASELINE's Cornell box (256^2,
# 64 spp, depth 8) for the ptracer (w * h * spp / 4 = 1,048,576 light
# paths) and stokes renders, the stokes one with the large box a smooth
# gold conductor, and a polarizer at POLARIZER_THETA degrees filling the
# view in front of the camera; the gates of the JAX package's own tests:
# the ptracer's and stokes S0's means within 5 % of `path`
# (test_ptracer_matches_path, test_stokes_s0_matches_path_with_area_light),
# the spectral x polarized DOP within 0.08 of RGB's and its S0 within 15 %
# (test_spectral_stokes_matches_rgb_fresnel); every profile at the timed
# render's size.
# The splat cloud: VP_SPLATS seeded ellipsoids (80 triangles each:
# 1,310,720, K2's regime) at 428x240, VP_SPP spp, max_depth 64, SH degree
# 3; its gradient at VP_GRAD_SPP; the kernels against the plain version
# on VP_SUB_RAYS rays of one of its queries.  Cut: a trained 3DGS scene
# has 10^5-10^6 splats, past 2^21 triangles, where the BVH route runs
# 99-136x slower than the sweep, so the cloud stops at 16,384.
M10_SMALL = (16, 16)
M10_PATH_RTOL = 0.05
DOP_ATOL, SPEC_S0_RTOL = 0.08, 0.15
POLARIZER_THETA = 30.0
VP_SPLATS, VP_SPP, VP_GRAD_SPP, VP_SUB_RAYS = 16384, 4, 1, 16384
VP_KEYS = ("volprims.opacity", "volprims.sh")
# shape gradients (shape_phases): shape_small's spp (the occluder at
# 16^2, the bumped, sky-lit proxy at 16x12) and its per-sample gate (the
# share of boundary samples whose visibility and side agree); the JAX
# package's own FD gates (tests/test_projective.py): the occluder at 24^2,
# render_grad at 128 spp against central FD of eps 0.05 at 512 spp (fd <
# -0.5, rtol 0.2), the rough mirror at 64 spp, eps 0.08 (|fd| > 1e-3, rtol
# 0.35); the main path's vertex gradient at 428x240, GRAD_SPP; and
# shape_optimize's Adam steps and rate on LargeSteps' latent (lambda 19,
# as tests/test_largesteps.py) toward the proxy scaled by SHAPE_SCALE
# about its centroid.  Cut from 4 steps to 2: the new phases took 171 s
# of a first run on an H100 (the script had 782 s of its 1,200 before
# them), ~7-8 s per step, and a whole run took 1,016 s on an H100
# whose host was slower than the first's.  Cut again when the rest of
# M10's phases came (69 s; the whole script 1,034 s on an H100, its
# other phases 8 % slower than the run before on a slower host):
# shape_small from 8 to 4 spp and from 65,536 to 32,768 boundary samples
# (its CPU side was ~63 of its 72 s), shape_grad from 3 timed runs to 2;
# and for the apps and multi-GPU phases (PR 17, on a slower host where
# shape_small took 89 s): 2 spp and 16,384 samples, one timed run
SHAPE_SMALL_SPP = 2
SHAPE_SMALL_SAMPLES = 1 << 14
SHAPE_GRAD_REPS = 1
SHAPE_LANE_MIN = 0.999
FD_SPP, FD_SEED, FD_GRAD_SEED = 512, 11, 5
OCC_FD = (24, 128, 0.05, 0.2)      # film, render_grad spp, eps, rtol
MIRROR_FD = (24, 64, 0.08, 0.35)
SHAPE_STEPS, SHAPE_LR, SHAPE_LAMBDA, SHAPE_SCALE = 2, 2e-3, 19.0, 1.03
SHAPE_LOSS_SEED = 77
# the principled, principledthin and measured BSDFs (principled_phases):
# principled_small's film and spp; principled_render is BASELINE's
# Cornell box (CORNELL_RES, CORNELL_SPP, depth 8, gaussian: one fixed pass)
PRINCIPLED_SMALL = (32, 16)
# the rest of M10 (m10b_phases): m10b_small's spp (one scene per step at
# test size); sunsky_render is the main path (BUMP, 428x240, CMP_SPP,
# biovolpath depth 12) under a Preetham sunsky at SUNSKY_HOUR, against the
# synthetic sky; texture_render and sdf_render are BASELINE's Cornell box
# (CORNELL_RES, gaussian: one fixed pass) with the textured blocks, and
# with a seeded SDF_RES^3 lumpy sphere at SDF_SPP; instanced_render is
# tests/test_instancing.py's group INST_N times under the constant light
# (box filter: the regen wavefront) at CORNELL_RES^2, INST_SPP, depth 8,
# and the liver proxy's group LIVER_INST times (its flattened twin past
# 65,536 triangles, K2's regime) at LIVER_INST_RES^2, LIVER_INST_SPP;
# hair_render a tuft of HAIR_STRANDS B-spline strands (6-sided tubes,
# ~432 triangles each: K2's regime) with the hair BSDF at CORNELL_RES^2,
# HAIR_SPP, depth 8, gaussian (one fixed pass).  Cuts: a head of hair has
# 10^4-10^5 strands (~10^7 tube triangles, past 2^21 and the sweep);
# every render is timed once (the phases must fit in ~100 s of the
# script's 1,200 s), the sunsky's render_grad once with no warm-up
M10B_SMALL_SPP = 8
# the instance pass's and the SDF march's hit sets on 16,384 camera rays,
# card against CPU: the march converges where an interpolated distance
# falls below 1e-3, which an ulp of t can move on a grazing ray
M10B_LANE_MIN = 0.999
SUNSKY_HOUR = 10.0
SDF_RES, SDF_SPP = 64, 16
INST_N, INST_SPP = 100, 64
LIVER_INST, LIVER_INST_RES, LIVER_INST_SPP = 16, 128, 4
HAIR_STRANDS, HAIR_SPP, HAIR_SUB_RAYS = 400, 16, 16384
# sensors_small's Cornell box film: every sensor scene at 16x12 or less
SENSOR_CORNELL_FILM = (16, 12)
# media_small: film, spp (2 before PR 17's cuts: its CPU side took most
# of its 57 s); the point light of its grid cubes
MEDIA_SMALL = (16, 1)
MEDIA_POINT = {"type": "point", "position": [0.5, 2.2, 1.6],
               "intensity": {"type": "rgb", "value": [8.0] * 3}}
MEDIA_PHASES = {
    "rayleigh": {"type": "rayleigh"},
    "blendphase": {"type": "blendphase", "weight": 0.4,
                   "a": {"type": "hg", "g": 0.5}, "b": {"type": "isotropic"}},
    "tabphase": {"type": "tabphase", "values": [0.2, 0.5, 1.0, 2.0, 1.0, 0.5]},
    "sggx": {"type": "sggx", "S": [1.0, 0.3, 0.6, 0.0, 0.0, 0.0]},
}
# a grid gradient entry above this is the ratio-tracking null weight at a
# voxel of the grid's maximum (sigma_n = 0 there: ~1e21-1e25 in both
# packages); the others are compared and summarised apart
GRID_GRAD_BLOWUP = 1e3
# bsdf_small: one plane per stock BSDF (and wrapper) the port carries
BSDF_PLANES = {
    "thindielectric": {"type": "thindielectric"},
    "conductor": {"type": "conductor", "material": "Au"},
    "roughconductor": {"type": "roughconductor", "alpha": 0.3,
                       "material": "Al"},
    "plastic": {"type": "plastic"},
    "roughplastic": {"type": "roughplastic", "alpha": 0.2},
    "pplastic": {"type": "pplastic", "alpha": 0.3},
    "roughdielectric": {"type": "roughdielectric", "alpha": 0.3},
    "twosided": {"type": "twosided", "bsdf": {"type": "diffuse"}},
    "blendbsdf": {"type": "blendbsdf", "weight": 0.4,
                  "a": {"type": "diffuse"},
                  "b": {"type": "roughconductor", "alpha": 0.2,
                        "material": "Cu"}},
    "mask": {"type": "mask", "opacity": 0.7, "bsdf": {"type": "plastic"}},
}

# the apps and multi-GPU (PR 17): apps_small's Cornell box (path depth 3,
# box filter, the camera turned 1.3 degrees off the box's diagonals, where
# two walls tie); viewer_render's ema and denoise frames at 1 spp on the
# main path; the scripted keys of interactive_render and apps_small (w, a,
# LEFT move the camera, + doubles the spp, r restarts, q quits: 7 frames,
# 4 restarts) at JAX main's 160x88 and at the main path's film; the
# sharded renders' spp, their two ranks on the card, and the spp of
# measure_scaling's fixed workload (one rep after a warm-up of each side)
APPS_RES, APPS_DEPTH = 16, 3
APPS_TURN = ([0.3, 1.0, 0.1], 1.3)
VIEWER_FRAMES, VIEWER_DENOISE_FRAMES = 8, 4
APP_KEYS = ["w", "a", "LEFT", "+", "r", None, None, "q"]
APP_FRAMES, APP_RESTARTS = 7, 4
INTERACTIVE_FILMS = ((160, 88), (WIDTH, HEIGHT))
SHARDED_SMALL_SPP = 4
SHARDED_SPP, SHARDED_RANKS, SCALING_SPP = 8, 2, 4
SHARDED_TIMEOUT = 600

# the rest of the loader (m9_phases): the committed DWAA sky
# (liver_proxy's 1,024 x 512 sky at DWA level 45) against the committed
# PIZ sky, within the lossy bound the CPU tests measured on OpenEXR's own
# decode (max 1.0178e-2, mean 6.98e-4 relative); the committed JPEG of
# the 1,024^2 height map (PIL, quality 75) against the 8-bit codes of its
# PNG (measured max 3, mean 0.41); decodes timed M9_REPS times each, in
# turns; the OBJ parse's mesh, the liver proxy at subdivision OBJ_SUBDIV
# (327,680 triangles); m9_render is the main path from those files at
# CMP_SPP, two renders in turns with its PNG + PIZ twin, their means
# within M9_TWIN_RTOL
DWA_SKY_MAX_REL, DWA_SKY_MEAN_REL = 0.0102, 7.0e-4
JPEG_HEIGHT_MAX, JPEG_HEIGHT_MEAN = 3, 0.5
M9_REPS = 3
OBJ_SUBDIV = 7
M9_TWIN_RTOL = 0.05

# tolerances: the kernel computes t with the plain version's fp32
# operations in the same order (bit-identical), but contracts p, u and v to
# FMA, which may flip a hit within a few ulps of a triangle edge to the
# neighbour (prims) or, rarely, to a miss (hit sets); its chunk culling may
# also drop a grazing hit that lies outside its chunk's box by a rounding
# error
HIT_AGREE_MIN = 0.9999
PRIM_AGREE_MIN = 0.99
T_RTOL = 1e-5
# render_small: the card's transcendentals differ from the CPU's by ulps,
# which can flip a rare dielectric / roulette decision of one path
PIX_RTOL, PIX_ATOL, PIX_FRAC_MIN, MEAN_RTOL = 1e-3, 1e-4, 0.99, 1e-3
# grad_small: the card sums per-lane gradient terms in another order than
# the CPU (and a rare path may flip, as above)
GRAD_COS_MIN, GRAD_NORM_RTOL = 0.999, 1e-2

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): fp32
# outside the tensor cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# floating-point operations of one Baldwin-Weber ray x triangle test
# (liverrenderer_tpu/accel/pallas_intersect.py:14-15), and of the part a
# pair the kernel's prefilter rejects pays: n.d and n.o (3 multiplies and
# 2 adds each) and t_num = dn - n.o
FLOP_PER_TEST = 38
PREFILTER_FLOP = 11
# ray rows the sweep reads of the (8, N) ray table: ox oy oz dx dy dz maxt
# (csrc/intersect.cu; row 7 is unused)
RAY_ROWS = 7
# a hit closer than this is counted as short (a self-hit would be one:
# spawned rays start ~1e-4 off the surface, core/types.py RAY_EPS)
SHORT_T = 1e-3
# profiler spans around render_grad and its replay walk
GRAD_SPAN = "chip_smoke.render_grad"
REPLAY_SPAN = "chip_smoke.replay_walk"


_T0 = time.perf_counter()


def emit(phase: str, **kw):
    """One JSON line of a phase; at_s: the script's seconds at its end."""
    print(json.dumps({"phase": phase, **kw,
                      "at_s": time.perf_counter() - _T0}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, reps: int, inner: int):
    """Median ms of one call, from CUDA events around `inner` calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / inner)
    out.sort()
    return out[len(out) // 2]


def compare_hits(tk, pk, tr, pr):
    hk, hr = pk >= 0, pr >= 0
    both = hk & hr
    same = both & (pk == pr)
    dt = (tk - tr).abs()[same]
    rel = (dt / tr.abs()[same].clamp(min=1e-30))
    return dict(
        n_rays=int(tk.numel()), hits=int(hr.sum()),
        hit_agree=float((hk == hr).float().mean()),
        prim_agree=float(same.sum()) / max(int(both.sum()), 1),
        max_abs_dt=float(dt.max()) if dt.numel() else 0.0,
        max_rel_dt=float(rel.max()) if rel.numel() else 0.0)


def check_agreement(r, what):
    check(r["hit_agree"] >= HIT_AGREE_MIN, f"{what}: hit sets {r}")
    check(r["prim_agree"] >= PRIM_AGREE_MIN, f"{what}: prims {r}")
    check(r["max_rel_dt"] <= T_RTOL, f"{what}: t {r}")


def merge_library(torch, t_part, p_part):
    t, idx = torch.min(t_part, dim=0)
    return t, torch.gather(p_part, 0, idx[None])[0]


def needed_work(torch, rays, tris, boxes, n_tris, t_hit):
    """Work these rays need, counted by plain torch on the card:
    (needed, candidates).  `needed` ray x triangle pairs: for each ray, the
    real triangles of every chunk whose box it enters (near <= far,
    far > 0, near < maxt), by a slab test of every ray against every box.
    `candidates`: the needed pairs whose triangle plane the ray crosses at
    0 < t <= min(maxt, t_hit) with |n.d| > 1e-12 (t_hit: the ray's closest
    hit, inf on a miss), which a sweep carries past the prefilter even when
    it meets the closest hit first."""
    n, n_chunks = rays.shape[1], boxes.shape[0]
    real = (n_tris - 128 * torch.arange(n_chunks, device=rays.device)) \
        .clamp(0, 128)
    o, d, maxt = rays[0:3], rays[3:6], rays[6]
    inv = 1.0 / torch.where(d.abs() > 1e-20, d, torch.full_like(d, 1e-20))
    lim = torch.minimum(maxt, t_hit)
    needed = cand = 0
    step = max(1, (1 << 25) // (128 * n))      # chunks per pass
    for c0 in range(0, n_chunks, step):
        bx = boxes[c0:c0 + step]
        g = bx.shape[0]
        t0 = (bx[:, 0:3, None] - o[None]) * inv[None]     # (G, 3, n)
        t1 = (bx[:, 3:6, None] - o[None]) * inv[None]
        near = torch.minimum(t0, t1).amax(1)
        far = torch.maximum(t0, t1).amin(1)
        enter = (near <= far) & (far > 0) & (near < maxt[None])
        needed += int((enter.to(torch.int64) * real[c0:c0 + g, None]).sum())
        blk = tris[c0 * 128:(c0 + g) * 128]                # (G*128, 16)
        nx, ny, nz, dn = (blk[:, k:k + 1] for k in range(4))
        ndir = nx * d[0] + ny * d[1] + nz * d[2]
        t = (dn - (nx * o[0] + ny * o[1] + nz * o[2])) / ndir
        c = (ndir.abs() > 1e-12) & (t > 0) & (t <= lim[None])
        cand += int((c.view(g, 128, n) & enter[:, None]).sum())
    return needed, cand


def query_bytes(n, tris, boxes, splits=1):
    """Bytes a query of n rays must move: the RAY_ROWS ray rows the sweep
    reads, triangle rows and boxes read once, t and prim written once per
    split (once for the query, whose merge leaves one)."""
    return 4 * (RAY_ROWS * n + tris.numel() + boxes.numel()) \
        + 8 * splits * n


def roofline(need, cand, nbytes):
    """The bound of a query's work: every needed pair pays the prefilter,
    each candidate the rest of the test, over the fp32 peak; nbytes over
    the memory rate; the larger of the two, and which one it is."""
    ops = PREFILTER_FLOP * need + (FLOP_PER_TEST - PREFILTER_FLOP) * cand
    b_ops, b_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(flop=ops, bound_needed_ms=b_ops, bytes=nbytes,
                bound_bytes_ms=b_bytes, bound_ms=max(b_ops, b_bytes),
                bound_by="operations" if b_ops >= b_bytes else "bytes")


def bounds(torch, rays, tris, boxes, n_tris, t_hit, splits):
    """Dense and data-dependent bounds of one query (sweep + merge) and of
    its sweep alone (which writes t and prim once per split)."""
    n = rays.shape[1]
    dense = n * n_tris
    need, cand = needed_work(torch, rays, tris, boxes, n_tris, t_hit)
    sweep = roofline(need, cand, query_bytes(n, tris, boxes, splits))
    return dict(dense_tests=dense,
                bound_dense_ms=dense * FLOP_PER_TEST / PEAK_FP32 * 1e3,
                needed_tests=need, candidate_tests=cand,
                **roofline(need, cand, query_bytes(n, tris, boxes)),
                sweep_bytes=sweep["bytes"], sweep_bound_ms=sweep["bound_ms"],
                sweep_bound_by=sweep["bound_by"])


def sweep_alone(torch, ci, rays, tris, boxes):
    """The sweep kernel alone, launched through its C function on
    preallocated partials: (median ms, t_part, prim_part)."""
    lib = ci.build_kernel()
    n, n_chunks = rays.shape[1], boxes.shape[0]
    splits, per = ci.split_plan(n, n_chunks, rays.device)
    t_part = torch.empty((splits, n), dtype=torch.float32, device=rays.device)
    p_part = torch.empty((splits, n), dtype=torch.int32, device=rays.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.lr_intersect_sweep(
            rays.data_ptr(), n, tris.data_ptr(), boxes.data_ptr(), n_chunks,
            per, splits, t_part.data_ptr(), p_part.data_ptr(), stream)
        check(err == 0, f"sweep launch failed: CUDA error {err}")

    return cuda_ms(run, reps=7, inner=10), t_part, p_part


def kernel_vs_plain(torch, ci, rays, tris, boxes, n_tris, reps_plain):
    tk, pk = ci.intersect_closest(rays, tris, boxes)
    tr, pr = ci.intersect_closest_reference(rays, tris, boxes)
    torch.cuda.synchronize()
    res = compare_hits(tk, pk, tr, pr)
    res["splits"], res["chunks_per_split"] = ci.split_plan(
        rays.shape[1], boxes.shape[0], rays.device)
    res["ms"] = cuda_ms(lambda: ci.intersect_closest(rays, tris, boxes),
                        reps=7, inner=10)
    res["sweep_ms"], t_part, p_part = sweep_alone(torch, ci, rays, tris,
                                                  boxes)
    ts, ps = ci.merge_partials_reference(t_part, p_part)
    check(bool(torch.equal(ts, tk) and torch.equal(ps, pk)),
          "the sweep alone differs from intersect_closest")
    res["plain_ms"] = cuda_ms(
        lambda: ci.intersect_closest_reference(rays, tris, boxes),
        reps=reps_plain, inner=1)
    res.update(bounds(torch, rays, tris, boxes, n_tris, tr, res["splits"]))
    res["share"] = res["bound_needed_ms"] / res["ms"]
    res["sweep_share"] = res["sweep_bound_ms"] / res["sweep_ms"]
    check(res["share"] <= 1 and res["sweep_share"] <= 1,
          f"a time below its bound: {res}")
    return res, pk, pr


def proxy_rays(torch, scene, n_cam, n_in, gen):
    """Camera rays through random film positions, and rays from random
    points inside the liver with random directions; half of the interior
    rays are cut short by a finite maxt."""
    from liverrenderer_tpu_torch.sensor.perspective import sample_ray
    dev = scene.device
    pos = torch.rand((n_cam, 2), generator=gen, device=dev) \
        * torch.tensor([scene.film_w, scene.film_h], device=dev)
    cam = sample_ray(scene, pos)
    p = torch.randn((n_in, 3), generator=gen, device=dev)
    p = p / p.norm(dim=-1, keepdim=True) \
        * torch.rand((n_in, 1), generator=gen, device=dev) ** (1 / 3)
    o_in = p * torch.tensor([1.5, 0.9, 0.75], device=dev) * 0.8
    d_in = torch.randn((n_in, 3), generator=gen, device=dev)
    d_in = d_in / d_in.norm(dim=-1, keepdim=True)
    cut = torch.rand(n_in, generator=gen, device=dev) < 0.5
    maxt_in = torch.where(
        cut, torch.rand(n_in, generator=gen, device=dev) * 1.0 + 0.02,
        float("inf"))
    o = torch.cat([cam.o, o_in]) - scene.tri_center
    d = torch.cat([cam.d, d_in])
    maxt = torch.cat([cam.maxt, maxt_in])
    return torch.cat([o.T, d.T, maxt[None], torch.zeros_like(maxt)[None]],
                     0).contiguous()


def k2_inputs(np, torch, ci):
    """~100k random small triangles (no BVH order: every chunk's box spans
    the cloud) and 16,384 rays aimed at it."""
    rs = np.random.default_rng(SEED)
    T = 100_000
    v0 = rs.uniform(-1, 1, (T, 3)).astype(np.float32)
    v1 = v0 + rs.uniform(-0.05, 0.05, (T, 3)).astype(np.float32)
    v2 = v0 + rs.uniform(-0.05, 0.05, (T, 3)).astype(np.float32)
    buf, boxes, _, center = ci.pack_tris(v0, v1, v2)
    R = 16384
    o = rs.uniform(-2, 2, (R, 3)).astype(np.float32)
    aim = rs.uniform(-0.6, 0.6, (R, 3)).astype(np.float32)
    d = aim - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.ascontiguousarray(np.concatenate(
        [(o - center).T, d.T, np.full((1, R), np.inf), np.zeros((1, R))]),
        np.float32)
    return (torch.from_numpy(rays).cuda(), torch.from_numpy(buf).cuda(),
            torch.from_numpy(boxes).cuda(), T)


def _tests_module(name="torch_tie_inputs"):
    """tests/<name>.py, loaded by path (a package named `tests` elsewhere
    on sys.path must not shadow it)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent / "tests" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tie_regime_inputs(torch, ci):
    mod = _tests_module()
    pack_rays, tie_inputs = mod.pack_rays, mod.tie_inputs
    v0, v1, v2, o, d, maxt, expected = tie_inputs(TIE_T, TIE_R, SEED)
    buf, boxes, _, center = ci.pack_tris(v0, v1, v2)
    return (torch.from_numpy(pack_rays(o, d, maxt, center)).cuda(),
            torch.from_numpy(buf).cuda(), torch.from_numpy(boxes).cuda(),
            torch.from_numpy(expected).to(torch.int32).cuda())


def capture_render(torch, lrt, ci, scene, spp, shadow_only=False):
    """Render with CUDA events around every intersect_closest call (the
    module attribute is wrapped for the call and restored after).
    Returns (wall seconds, [(event ms, rays, tris, boxes)]) of every call,
    or of the shadow queries only."""
    calls = []
    orig = ci.intersect_closest

    def timed(rays, tris, boxes, shadow=False):
        if shadow_only and not shadow:
            return orig(rays, tris, boxes, shadow=shadow)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig(rays, tris, boxes, shadow=shadow)
        b.record()
        calls.append((a, b, rays.clone(), tris, boxes))
        return out

    torch.cuda.synchronize()
    ci.intersect_closest = timed
    try:
        t0 = time.perf_counter()
        img = lrt.render(scene, spp=spp, seed=SEED)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        ci.intersect_closest = orig
    check(bool(torch.isfinite(img).all()), "render_kernel: non-finite image")
    return secs, [(a.elapsed_time(b), r, t, bx) for a, b, r, t, bx in calls]


def launch_counts(ci):
    """The kernels' launch counts: sweep and merge, and the shadow queries'
    part of each."""
    return (ci.LAUNCHES, ci.MERGE_LAUNCHES, ci.SHADOW_LAUNCHES,
            ci.SHADOW_MERGE_LAUNCHES)


def reset_counts(ci):
    ci.LAUNCHES = ci.MERGE_LAUNCHES = 0
    ci.SHADOW_LAUNCHES = ci.SHADOW_MERGE_LAUNCHES = 0


def split_counts(c):
    """Launch counts as bounce and shadow queries."""
    sweep, merge, s_sweep, s_merge = c
    return dict(bounce_launches=sweep - s_sweep, shadow_launches=s_sweep,
                bounce_merge_launches=merge - s_merge,
                shadow_merge_launches=s_merge)


def timed_call(torch, fn):
    """Wall seconds of fn() from a synchronised card, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def timed_render(torch, lrt, scene, spp):
    """Wall seconds of one render, from a synchronised card."""
    return timed_call(torch, lambda: lrt.render(scene, spp=spp, seed=SEED))


def grad_run(torch, lrt, ci, treplay, scene, spp, walks=1,
             key="media.params"):
    """One render_grad of mean(image) with respect to `key`, with the
    kernel counts set to 0 just before it and split at the replay walks'
    entries and exits (module attribute wrapped for the call) -> (seconds,
    gradient, image, launches of the stored forwards and of the walks).
    walks: the replay walks the schedule must run (1: the single walk; the
    tiled schedule walks each partition; 0: the scan adjoint)."""
    spans = []
    orig = treplay._replay_walk

    def walk(*args, **kw):
        c0 = launch_counts(ci)
        with torch.profiler.record_function(REPLAY_SPAN):
            out = orig(*args, **kw)
        spans.append((c0, launch_counts(ci)))
        return out

    torch.cuda.synchronize()
    reset_counts(ci)
    treplay._replay_walk = walk
    try:
        t0 = time.perf_counter()
        with torch.profiler.record_function(GRAD_SPAN):
            _, grads, img = lrt.render_grad(
                scene, {key: lrt.traverse(scene, [key])[key]},
                lambda im: im.mean(), spp=spp, seed=SEED)
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        treplay._replay_walk = orig
    check(len(spans) == walks, f"render_grad walked {len(spans)} times, "
          f"not {walks}")
    total = launch_counts(ci)
    replay = [sum(b[i] - a[i] for a, b in spans) for i in range(4)]
    fwd = [t - r for t, r in zip(total, replay)]
    out = dict(fwd_launches=fwd[0], fwd_merge_launches=fwd[1],
               replay_launches=replay[0], replay_merge_launches=replay[1])
    if total[2] or total[3]:
        out.update(fwd_shadow_launches=fwd[2],
                   fwd_shadow_merge_launches=fwd[3],
                   replay_shadow_launches=replay[2],
                   replay_shadow_merge_launches=replay[3])
    return secs, grads[key], img, out


def _busy_us(spans):
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def raw_events(prof):
    """(name, on the device, start us, end us, user annotation) of every
    event of a torch.profiler run, read from its kineto results: building
    the profiler's FunctionEvent tree (prof.events()) took ~8 minutes for
    the grid render's ~1.2M launches."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        ann = getattr(e, "is_user_annotation", None)
        out.append((e.name(), e.device_type() == DeviceType.CUDA, start,
                    start + e.duration_ns() / 1e3, bool(ann and ann())))
    return out


def primal_trace(prof, secs, iterations):
    """Host kernel launches per regen iteration and the device's busy time
    and idle share of a primal render profiled for CUDA activity alone
    (the CUDA runtime's launch calls are part of it; leaving out the CPU
    ops halves the events to read)."""
    events = raw_events(prof)
    dev = [(a, b) for _, cuda, a, b, ann in events if cuda and not ann]
    launches = sum(1 for e in events if e[0] in LAUNCH_NAMES)
    busy = _busy_us(dev) / 1e3
    return dict(trace_seconds=secs, trace_iterations=iterations,
                trace_host_launches=launches,
                launches_per_iteration=launches / max(iterations, 1),
                device_busy_ms=busy,
                device_idle_share=1.0 - busy / 1e3 / secs)


def load_scene(lrt, d, device="cuda", variant=None):
    """A scene dict through load_dict, or an XML file's path through
    load_file."""
    if isinstance(d, str):
        return lrt.load_file(d, device=device, variant=variant)
    return lrt.load_dict(d, device=device, variant=variant)


def arrays_agree(np, img, ref):
    """Card image against CPU image, per pixel over the trailing axes ->
    (pixel fraction within tolerance, difference of the means relative
    to the mean magnitude, card mean).  The magnitude, not the mean: the
    signed Stokes components S1..S3 may average to ~0."""
    close = np.abs(img - ref) <= PIX_ATOL + PIX_RTOL * np.abs(ref)
    close = close.reshape(close.shape[:2] + (-1,))
    return (float(close.all(-1).mean()),
            float(abs(img.mean() - ref.mean())
                  / max(float(np.abs(ref).mean()), 1e-12)),
            float(img.mean()))


def image_vs_cpu(np, lrt, d, spp, variant=None):
    """The same render on the card and on the CPU (plain version) ->
    (pixel fraction within tolerance, relative difference of the means,
    card image mean, pixel fraction exactly equal).  d: a scene dict or
    an XML file's path."""
    img_cpu = lrt.render(load_scene(lrt, d, "cpu", variant), spp=spp,
                         seed=SEED).numpy()
    img_gpu = lrt.render(load_scene(lrt, d, variant=variant), spp=spp,
                         seed=SEED).cpu().numpy()
    return arrays_agree(np, img_gpu, img_cpu) \
        + (float((img_gpu == img_cpu).all(-1).mean()),)


def grad_vs_cpu(lrt, d, spp, keys=("media.params",), variant=None):
    """Gradient of the mean image with respect to `keys` (flattened and
    joined) on the card and on the CPU -> (cosine, relative difference of
    the norms, CPU gradient norm, card gradient finite).  d: a scene dict
    or an XML file's path."""
    import torch

    def grad(sc):
        prm = lrt.traverse(sc, keys)
        _, g, _ = lrt.render_grad(sc, {k: prm[k] for k in keys},
                                  lambda im: im.mean(), spp=spp, seed=SEED)
        return torch.cat([g[k].cpu().double().reshape(-1) for k in keys])

    b = grad(load_scene(lrt, d, "cpu", variant))
    a = grad(load_scene(lrt, d, variant=variant))
    cos = float((a * b).sum() / (a.norm() * b.norm()))
    return (cos, abs(float(a.norm() / b.norm()) - 1.0), float(b.norm()),
            bool(a.isfinite().all()))


def shadow_vs_plain(torch, ci, calls, n_tris):
    """Captured queries against the plain version: agreement, their bound
    as kernel_vs_plain computes it (per launch), and the kernel's and the
    plain version's ms per launch replayed back to back."""
    agree = dict(n_rays=0, hits=0, hit_same=0, both=0, prim_same=0,
                 max_rel_dt=0.0, needed=0, candidates=0, bytes=0)
    for _, r, t, bx in calls:
        tk, pk = ci.intersect_closest(r, t, bx)
        tr, pr = ci.intersect_closest_reference(r, t, bx)
        c = compare_hits(tk, pk, tr, pr)
        agree["n_rays"] += c["n_rays"]
        agree["hits"] += c["hits"]
        agree["hit_same"] += int(((pk >= 0) == (pr >= 0)).sum())
        agree["both"] += int(((pk >= 0) & (pr >= 0)).sum())
        agree["prim_same"] += int(((pk == pr) & (pr >= 0)).sum())
        agree["max_rel_dt"] = max(agree["max_rel_dt"], c["max_rel_dt"])
        b = bounds(torch, r, t, bx, n_tris, tr, 1)
        agree["needed"] += b["needed_tests"]
        agree["candidates"] += b["candidate_tests"]
        agree["bytes"] += b["bytes"]
    n = len(calls)
    bound = roofline(agree["needed"] / n, agree["candidates"] / n,
                     agree["bytes"] / n)

    def replay(fn):
        def run():
            for _, r, t, bx in calls:
                fn(r, t, bx)
        return cuda_ms(run, reps=3, inner=1) / n

    return dict(
        launches=n, n_rays=agree["n_rays"], hits=agree["hits"],
        hit_agree=agree["hit_same"] / agree["n_rays"],
        prim_agree=agree["prim_same"] / max(agree["both"], 1),
        max_rel_dt=agree["max_rel_dt"],
        needed_tests_per_launch=agree["needed"] / n,
        candidate_tests_per_launch=agree["candidates"] / n,
        bound_ops_ms=bound["bound_needed_ms"],
        bound_bytes_ms=bound["bound_bytes_ms"], bound_ms=bound["bound_ms"],
        bound_by=bound["bound_by"],
        replay_ms_per_launch=replay(ci.intersect_closest),
        plain_ms_per_launch=replay(ci.intersect_closest_reference))


def liver_shadow_rays(torch, scene, n, gen):
    """Shadow rays on the liver proxy: from points in its bounding box to a
    point light above it, maxt just short of the light and origins offset
    as the NEE shadow query offsets them (volpath
    sample_emitter_attenuated)."""
    dev = scene.device
    p = (torch.rand((n, 3), generator=gen, device=dev) * 2 - 1) \
        * torch.tensor([1.6, 1.0, 0.85], device=dev)
    light = torch.tensor([0.4, 3.0, 2.0], device=dev)
    dvec = light - p
    dist = dvec.norm(dim=-1)
    d = dvec / dist[:, None]
    eps = (1.0 + p.abs().amax(-1)) * 1e-4
    o = p + d * eps[:, None] - scene.tri_center
    maxt = dist * (1.0 - 1e-3) - eps
    return torch.cat([o.T, d.T, maxt[None], torch.zeros_like(maxt)[None]],
                     0).contiguous()


def trace_summary(prof, secs, iterations, top=10):
    """Device busy time (union of the device intervals) and idle share,
    host kernel launches per regen iteration, for the whole render_grad
    and for its two walks (split at the replay walk's span), and the top
    device ops of a torch.profiler run.  iterations: (forward, replay)."""
    events = raw_events(prof)
    # the host side of each span (CUDA traces also hold a device-side
    # annotation of the same name)
    spans = {name: [(a, b) for n, cuda, a, b, _ in events
                    if n == name and not cuda]
             for name in (GRAD_SPAN, REPLAY_SPAN)}
    check(len(spans[GRAD_SPAN]) == 1 and len(spans[REPLAY_SPAN]) == 1,
          "trace: render_grad or replay walk span missing")
    t0, (w0, w1) = spans[GRAD_SPAN][0][0], spans[REPLAY_SPAN][0]
    # device work: kernels, copies and sets (not the spans' annotations)
    dev_ev = [e for e in events if e[1] and not e[4] and e[0] not in spans]
    dev = [(a, b) for _, _, a, b, _ in dev_ev]
    launch = [e[2] for e in events if e[0] in LAUNCH_NAMES]
    out = dict(seconds=secs, device_events=len(dev),
               host_launches=len(launch),
               device_busy_ms=_busy_us(dev) / 1e3)
    out["device_idle_share"] = 1.0 - out["device_busy_ms"] / 1e3 / secs
    for name, (a, b), its in (("fwd", (t0, w0), iterations[0]),
                              ("replay", (w0, w1), iterations[1])):
        n = sum(1 for x in launch if a <= x < b)
        busy = _busy_us((r0, r1) for r0, r1 in dev if a <= r0 < b)
        out[f"{name}_iterations"] = its
        out[f"{name}_host_launches"] = n
        out[f"{name}_launches_per_iteration"] = n / max(its, 1)
        out[f"{name}_device_busy_ms"] = busy / 1e3
        out[f"{name}_window_ms"] = (b - a) / 1e3
        out[f"{name}_device_idle_share"] = 1.0 - busy / max(b - a, 1e-9)

    by_name = {}
    for name, _, a, b, _ in dev_ev:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += b - a
        acc[1] += 1
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    out["top_device_ops"] = [dict(name=k[:80], device_ms=us / 1e3, calls=n)
                             for k, (us, n) in ops]
    return out


def nee_phases(torch, np, lrt, ci, treplay, smi, scene, gen):
    """Phases fog_small, nee_walk_small, fog_render, shadow_kernel and
    fog_render_grad -> the launch counts and shadow-query results the
    kernels line reports.  scene: the liver proxy at full size."""
    from torch.profiler import ProfilerActivity, profile
    from liverrenderer_tpu_torch.scene.cornell import (fog_cornell_box,
                                                       plane_light_dict)
    # ---- 6a. next-event estimation at test size, card against CPU
    res_s, spp_s, depth_s = FOG_SMALL
    frac, mean_rel, mean, exact = image_vs_cpu(
        np, lrt, fog_cornell_box(res_s, max_depth=depth_s), spp_s)
    emit("fog_small", film=[res_s, res_s], spp=spp_s, max_depth=depth_s,
         pixel_frac=frac, pixel_exact=exact, mean_rel=mean_rel, mean=mean)
    check(frac >= PIX_FRAC_MIN and mean_rel <= MEAN_RTOL,
          "fog_small: the card's render disagrees with the CPU's")

    res_w, spp_w = WALK_SMALL
    walk_d = plane_light_dict(res_w, fog_cube=True)
    frac, mean_rel, mean, exact = image_vs_cpu(np, lrt, walk_d, spp_w)
    cos, norm_rel, gnorm, gfin = grad_vs_cpu(lrt, walk_d, spp_w)
    emit("nee_walk_small", film=[res_w, res_w], spp=spp_w, pixel_frac=frac,
         pixel_exact=exact, mean_rel=mean_rel, mean=mean, grad_cosine=cos,
         grad_norm_rel=norm_rel, grad_norm=gnorm)
    check(frac >= PIX_FRAC_MIN and mean_rel <= MEAN_RTOL,
          "nee_walk_small: the card's render disagrees with the CPU's")
    check(gfin and gnorm > 0, "nee_walk_small: gradient not finite or zero")
    check(cos >= GRAD_COS_MIN and norm_rel <= GRAD_NORM_RTOL,
          "nee_walk_small: the card's gradient disagrees with the CPU's")

    # ---- 6b. the fog Cornell box at full size: primal
    fog = lrt.load_dict(fog_cornell_box(FOG_RES, max_depth=FOG_DEPTH))
    check(fog.device.type == "cuda" and fog.needs_surface_nee,
          "fog scene not on the card or without NEE")
    lrt.render(fog, spp=1, seed=SEED + 1)                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ci)
    t0 = time.perf_counter()
    img = lrt.render(fog, spp=FOG_SPP, seed=SEED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fog_counts = launch_counts(ci)
    fog_split = split_counts(fog_counts)
    finite = bool(torch.isfinite(img).all())
    paths = FOG_RES * FOG_RES * FOG_SPP
    fog_tr = lrt.load_dict(fog_cornell_box(FOG_TRACE_RES,
                                           max_depth=FOG_DEPTH))
    lrt.render(fog_tr, spp=FOG_TRACE_SPP, seed=SEED)           # warm-up
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        reset_counts(ci)
        t0 = time.perf_counter()
        lrt.render(fog_tr, spp=FOG_TRACE_SPP, seed=SEED)
        torch.cuda.synchronize()
        secs_tr = time.perf_counter() - t0
    # one bounce query per regen iteration
    tr_iters = ci.LAUNCHES - ci.SHADOW_LAUNCHES
    emit("fog_render", film=[FOG_RES, FOG_RES], spp=FOG_SPP,
         max_depth=fog.max_depth, tris=fog.n_tris, card=smi,
         seconds=round(secs, 3), paths_per_s=paths / secs, finite=finite,
         shape=list(img.shape), mean=float(img.mean()),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         iterations=fog_split["bounce_launches"], **fog_split,
         trace_film=[FOG_TRACE_RES, FOG_TRACE_RES], trace_spp=FOG_TRACE_SPP,
         **primal_trace(prof, secs_tr, tr_iters))
    check(tuple(img.shape) == (FOG_RES, FOG_RES, 3), "fog image shape")
    check(finite, "fog image has non-finite values")
    check(0.0 < float(img.mean()) < 1.0, "fog image mean out of range")
    check(fog_split["bounce_launches"] > 0
          and fog_split["shadow_launches"] > 0,
          "the fog render did not launch the sweep kernel for both queries")

    # ---- 6c. the shadow queries against the plain version
    _, calls_f = capture_render(torch, lrt, ci, fog, FOG_TRACE_SPP,
                                shadow_only=True)
    check(len(calls_f) > 0, "shadow_kernel: no shadow query captured")
    inline = sum(c[0] for c in calls_f) / len(calls_f)
    sh = shadow_vs_plain(torch, ci, calls_f, fog.n_tris)
    sh_liver = shadow_vs_plain(
        torch, ci, [(0.0, liver_shadow_rays(torch, scene, 65536, gen),
                     scene.tri_buf, scene.tri_boxes)], scene.n_tris)
    splits_l = ci.split_plan(65536, scene.tri_boxes.shape[0],
                             scene.device)[0]
    emit("shadow_kernel", card=smi, fog_render_ms_per_launch=inline,
         fog=sh, liver_proxy_point_light=dict(splits=splits_l, **sh_liver))
    for r, what in ((sh, "fog shadow rays"),
                    (sh_liver, "liver proxy shadow rays")):
        check_agreement(r, what)
        check(r["bound_ms"] <= r["replay_ms_per_launch"],
              f"{what}: a time below its bound: {r}")
    check(sh["hits"] > 0 and sh_liver["hits"] > 0,
          "shadow rays: no occluder hit")
    check(splits_l > 1, "liver shadow rays: the chunk range was not split")

    # ---- 6d. the fog Cornell box at full size: gradient (tiled schedule)
    # one timed run after a warm-up (the script's longest phase)
    n_fog_walks = -(-FOG_RES * FOG_RES // treplay.regen_mod.TILE_PIX)
    fruns = [grad_run(torch, lrt, ci, treplay, fog, FOG_GRAD_SPP,
                      walks=n_fog_walks)]                       # warm-up
    torch.cuda.reset_peak_memory_stats()
    fruns.append(grad_run(torch, lrt, ci, treplay, fog, FOG_GRAD_SPP,
                          walks=n_fog_walks))
    fog_peak = torch.cuda.max_memory_allocated()
    fog_grad_counts = fruns[1][3]
    fg = fruns[1][1]
    ft_primal, _ = timed_render(torch, lrt, fog, FOG_GRAD_SPP)
    ft_grad = fruns[1][0]
    fpaths = FOG_RES * FOG_RES * FOG_GRAD_SPP
    finite_fg = bool(torch.isfinite(fg).all())
    emit("fog_render_grad", film=[FOG_RES, FOG_RES], spp=FOG_GRAD_SPP,
         max_depth=fog.max_depth, card=smi, walks=n_fog_walks,
         seconds=ft_grad, warm_up_seconds=fruns[0][0],
         fwd_bwd_paths_per_s=fpaths / ft_grad, primal_seconds=ft_primal,
         primal_paths_per_s=fpaths / ft_primal,
         fwd_bwd_over_primal=ft_grad / ft_primal, grad_finite=finite_fg,
         grad_abs_max=float(fg.abs().max()),
         grad_sigma_t_albedo=[float(x) for x in fg[0, 0:6]],
         image_mean=float(fruns[1][2].mean()),
         max_memory_allocated=fog_peak, **fog_grad_counts)
    check(finite_fg and float(fg.abs().max()) > 0,
          "fog render_grad: gradient not finite or zero")
    check(all(r[3] == fog_grad_counts for r in fruns),
          "fog render_grad: launch counts differ between reps")
    for k in ("fwd_launches", "replay_launches", "fwd_shadow_launches",
              "replay_shadow_launches"):
        check(fog_grad_counts.get(k, 0) > 0, f"fog render_grad: {k} is 0")
    return dict(fog_counts=fog_counts, fog_grad_counts=fog_grad_counts,
                shadow=sh, liver_shadow=sh_liver)


def bump_env_phases(torch, np, lrt, ci, treplay, smi, plain):
    """Phases bump_env_small, env_nee_small, bump_env_render and
    bump_env_render_grad -> the launch counts the kernels line reports.
    plain: the plain liver proxy at full size (the render's comparison)."""
    from torch.profiler import ProfilerActivity, profile
    from liverrenderer_tpu_torch.scene.cornell import plane_light_dict
    from liverrenderer_tpu_torch.scene.liver_proxy import (BUMP, SKY,
                                                           liver_proxy_dict,
                                                           sky_map)
    # ---- 7a. at test size, card against CPU
    small = liver_proxy_dict(16, 12, 4, 2, SEED, bump=BUMP_SMALL,
                             sky=SKY_SMALL)
    keys = ("media.params", "emitters.params")
    frac, mean_rel, mean, exact = image_vs_cpu(np, lrt, small, 4)
    cos, norm_rel, gnorm, gfin = grad_vs_cpu(lrt, small, 4, keys)
    emit("bump_env_small", film=[16, 12], spp=4, bump=list(BUMP_SMALL),
         sky=list(SKY_SMALL), pixel_frac=frac, pixel_exact=exact,
         mean_rel=mean_rel, mean=mean,
         grad_keys=list(keys), grad_cosine=cos, grad_norm_rel=norm_rel,
         grad_norm=gnorm)
    check(frac >= PIX_FRAC_MIN and mean_rel <= MEAN_RTOL,
          "bump_env_small: the card's render disagrees with the CPU's")
    check(gfin and gnorm > 0, "bump_env_small: gradient not finite or zero")
    check(cos >= GRAD_COS_MIN and norm_rel <= GRAD_NORM_RTOL,
          "bump_env_small: the card's gradient disagrees with the CPU's")

    res_e, spp_e = ENV_NEE_SMALL
    env_d = plane_light_dict(res_e, light={"type": "envmap",
                                           "data": sky_map(*SKY_SMALL)})
    frac, mean_rel, mean, exact = image_vs_cpu(np, lrt, env_d, spp_e)
    cos, norm_rel, gnorm, gfin = grad_vs_cpu(lrt, env_d, spp_e,
                                             ("emitters.params",))
    emit("env_nee_small", film=[res_e, res_e], spp=spp_e,
         sky=list(SKY_SMALL), pixel_frac=frac, pixel_exact=exact,
         mean_rel=mean_rel, mean=mean,
         grad_keys=["emitters.params"], grad_cosine=cos,
         grad_norm_rel=norm_rel, grad_norm=gnorm)
    check(frac >= PIX_FRAC_MIN and mean_rel <= MEAN_RTOL,
          "env_nee_small: the card's render disagrees with the CPU's")
    check(gfin and gnorm > 0, "env_nee_small: gradient not finite or zero")
    check(cos >= GRAD_COS_MIN and norm_rel <= GRAD_NORM_RTOL,
          "env_nee_small: the card's gradient disagrees with the CPU's")

    # ---- 7b. bench.py's workload path at full size: primal
    t0 = time.perf_counter()
    bumped = lrt.load_dict(liver_proxy_dict(WIDTH, HEIGHT, SPP, SUBDIV, SEED,
                                            bump=BUMP, sky=SKY))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(bumped.device.type == "cuda" and bumped.has_heightmap
          and bumped.emitters.env_index >= 0
          and bumped.textures.has_quads and not bumped.needs_surface_nee,
          "bumped proxy: not on the card, or without its bump map or sky")
    lrt.render(bumped, spp=1, seed=SEED + 1)                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ci)
    secs, img = timed_render(torch, lrt, bumped, SPP)
    counts = launch_counts(ci)
    peak = torch.cuda.max_memory_allocated()
    # then the plain proxy (one render each: the second pair took ~15 s of
    # the script's time limit)
    torch.cuda.reset_peak_memory_stats()
    plain_s = [timed_render(torch, lrt, plain, SPP)[0]]
    plain_peak = torch.cuda.max_memory_allocated()
    bumped_s = [secs]
    traces = {}
    for name, sc in (("bumped", bumped), ("plain", plain)):
        lrt.render(sc, spp=BUMP_TRACE_SPP, seed=SEED)            # warm-up
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            reset_counts(ci)
            secs_tr, _ = timed_render(torch, lrt, sc, BUMP_TRACE_SPP)
        traces[name] = primal_trace(prof, secs_tr, ci.LAUNCHES)
    finite = bool(torch.isfinite(img).all())
    paths = WIDTH * HEIGHT * SPP
    t_b, t_p = bumped_s[0], plain_s[0]
    emit("bump_env_render", film=[WIDTH, HEIGHT], spp=SPP,
         max_depth=bumped.max_depth, tris=bumped.n_tris, bump=list(BUMP),
         sky=list(SKY), card=smi, build_seconds=build_s,
         seconds=round(secs, 3), paths_per_s=paths / secs, finite=finite,
         shape=list(img.shape), mean=float(img.mean()),
         max_memory_allocated=peak,
         plain_max_memory_allocated=plain_peak, launches=counts[0],
         merge_launches=counts[1], shadow_launches=counts[2],
         bumped_seconds_reps=bumped_s, plain_seconds_reps=plain_s,
         bumped_over_plain=t_b / t_p,
         trace_spp=BUMP_TRACE_SPP, trace=traces,
         launches_per_iteration_added=traces["bumped"][
             "launches_per_iteration"] - traces["plain"][
             "launches_per_iteration"])
    check(tuple(img.shape) == (HEIGHT, WIDTH, 3), "bumped image shape")
    check(finite, "bumped image has non-finite values")
    check(0.05 < float(img.mean()) < 5.0, "bumped image mean out of range")
    check(counts[0] > 0 and counts[1] > 0,
          "the bumped render did not launch the sweep and merge kernels")
    check(counts[2] == 0, "the bumped liver render made shadow queries")

    # ---- 7c. its gradient (single walk)
    # one timed run after the warm-up, against one primal (the script's
    # time allows no more)
    runs = [grad_run(torch, lrt, ci, treplay, bumped, GRAD_SPP)]  # warm-up
    torch.cuda.reset_peak_memory_stats()
    runs.append(grad_run(torch, lrt, ci, treplay, bumped, GRAD_SPP))
    gpeak = torch.cuda.max_memory_allocated()
    grad_counts = runs[1][3]
    check(all(r[3] == grad_counts for r in runs),
          "bumped render_grad: launch counts differ between reps")
    g = runs[1][1]
    primal = [timed_render(torch, lrt, bumped, GRAD_SPP)[0]]
    t_grad, t_primal = runs[1][0], primal[0]
    gpaths = WIDTH * HEIGHT * GRAD_SPP
    finite_g = bool(torch.isfinite(g).all())
    emit("bump_env_render_grad", film=[WIDTH, HEIGHT], spp=GRAD_SPP,
         max_depth=bumped.max_depth, card=smi, seconds=t_grad,
         seconds_reps=[r[0] for r in runs],
         fwd_bwd_paths_per_s=gpaths / t_grad, primal_seconds=t_primal,
         primal_seconds_reps=primal, primal_paths_per_s=gpaths / t_primal,
         fwd_bwd_over_primal=t_grad / t_primal, grad_finite=finite_g,
         grad_abs_max=float(g.abs().max()),
         grad_sigma_t=[float(x) for x in g[0, 0:3]],
         image_mean=float(runs[1][2].mean()), max_memory_allocated=gpeak,
         **grad_counts)
    check(finite_g and float(g.abs().max()) > 0,
          "bumped render_grad: gradient not finite or zero")
    for k in ("fwd_launches", "fwd_merge_launches", "replay_launches",
              "replay_merge_launches"):
        check(grad_counts[k] > 0, f"bumped render_grad: {k} is 0")
    return dict(counts=counts, grad_counts=grad_counts, scene=bumped,
                image=img)


def _first_queries(torch, lrt, ci, scene, spp):
    """Render once and keep copies of the first bounce query (the camera
    wavefront) and the first shadow query -> {kind: (rays, tris, boxes)}."""
    kept = {}
    orig = ci.intersect_closest

    def keep(rays, tris, boxes, shadow=False):
        kind = "shadow" if shadow else "camera"
        if kind not in kept:
            kept[kind] = (rays.clone(), tris, boxes)
        return orig(rays, tris, boxes, shadow=shadow)

    ci.intersect_closest = keep
    try:
        lrt.render(scene, spp=spp, seed=SEED)
        torch.cuda.synchronize()
    finally:
        ci.intersect_closest = orig
    return kept


def wide_vs_plain(torch, ci, rays, tris, boxes, n_tris):
    """The sweep kernel on one wide wavefront (one launch) against its plain
    version, run in blocks of WIDE_BLOCK rays (its (128, N) temporaries
    would take tens of GB at 4 M rays): agreement, ms per launch, the
    blocked plain version's ms, and the bound as kernel_vs_plain computes
    it (needed and candidate pairs summed over the blocks)."""
    n = rays.shape[1]
    tk, pk = ci.intersect_closest(rays, tris, boxes)
    blocks = [ci.intersect_closest_reference(
        rays[:, i:i + WIDE_BLOCK].contiguous(), tris, boxes)
        for i in range(0, n, WIDE_BLOCK)]
    tr = torch.cat([b[0] for b in blocks])
    pr = torch.cat([b[1] for b in blocks])
    res = compare_hits(tk, pk, tr, pr)
    res["splits"], res["chunks_per_split"] = ci.split_plan(
        n, boxes.shape[0], rays.device)
    res["ms"] = cuda_ms(lambda: ci.intersect_closest(rays, tris, boxes),
                        reps=5, inner=3)

    def plain():
        for i in range(0, n, WIDE_BLOCK):
            ci.intersect_closest_reference(rays[:, i:i + WIDE_BLOCK], tris,
                                           boxes)
    res["plain_ms"] = cuda_ms(plain, reps=3, inner=1)
    res["plain_blocks"] = len(blocks)
    need = cand = 0
    for i in range(0, n, WIDE_BLOCK):
        a, b = needed_work(torch, rays[:, i:i + WIDE_BLOCK], tris, boxes,
                           n_tris, tr[i:i + WIDE_BLOCK])
        need, cand = need + a, cand + b
    res.update(needed_tests=need, candidate_tests=cand,
               **roofline(need, cand, query_bytes(n, tris, boxes)))
    res["share"] = res["bound_ms"] / res["ms"]
    return res


def _cornell_dict(cornell_box, res, rfilter, depth=CORNELL_DEPTH):
    d = cornell_box()
    d["integrator"] = {"type": "path", "max_depth": depth}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": res, "height": res,
                           "rfilter": {"type": rfilter}}
    return d


def cornell_phases(torch, np, lrt, ci, treplay, smi):
    """Phases cornell_small, bsdf_small, wide_kernel, cornell_render and
    cornell_render_grad -> the launch counts and wide-wavefront results the
    kernels line reports."""
    from torch.profiler import ProfilerActivity, profile
    from liverrenderer_tpu_torch.integrators import prb as tprb
    from liverrenderer_tpu_torch.integrators.common import MAX_WAVEFRONT
    from liverrenderer_tpu_torch.integrators.regen import regen_applicable
    from liverrenderer_tpu_torch.scene.cornell import (cornell_box,
                                                       plane_light_dict)
    # ---- 8a. the Cornell box at test size on both wavefronts, card
    # against CPU
    res_s, spp_s = CORNELL_SMALL
    small = {}
    for rf in ("gaussian", "box"):
        frac, mean_rel, mean, exact = image_vs_cpu(
            np, lrt, _cornell_dict(cornell_box, res_s, rf), spp_s)
        small[rf] = dict(pixel_frac=frac, pixel_exact=exact,
                         mean_rel=mean_rel, mean=mean)
    emit("cornell_small", film=[res_s, res_s], spp=spp_s,
         max_depth=CORNELL_DEPTH, fixed_gaussian=small["gaussian"],
         regen_box=small["box"])
    for rf, r in small.items():
        check(r["pixel_frac"] >= PIX_FRAC_MIN and r["mean_rel"] <= MEAN_RTOL,
              f"cornell_small ({rf}): the card's render disagrees with the "
              f"CPU's: {r}")

    # ---- 8b. the stock BSDFs on the gradient tests' plane, card against
    # CPU: images of one plane per BSDF, and two gradients
    res_p, spp_p = BSDF_SMALL
    planes = {}
    for name, bsdf in BSDF_PLANES.items():
        d = plane_light_dict(res_p, integrator="path", max_depth=3,
                             bsdf=bsdf)
        frac, mean_rel, mean, exact = image_vs_cpu(np, lrt, d, spp_p)
        planes[name] = dict(pixel_frac=frac, pixel_exact=exact,
                            mean_rel=mean_rel, mean=mean)
        check(frac >= PIX_FRAC_MIN and mean_rel <= MEAN_RTOL,
              f"bsdf_small ({name}): the card's render disagrees with the "
              f"CPU's: {planes[name]}")
    grads = {}
    for name, bsdf, rfilter, key in (
            ("diffuse_albedo", None, "box", "textures.data"),
            ("rough_alpha", BSDF_PLANES["roughconductor"], "box",
             "bsdfs.params"),
            # the gaussian filter is not regen-able: the scan adjoint
            ("diffuse_albedo_scan", None, "gaussian", "textures.data")):
        d = plane_light_dict(res_p, integrator="path", max_depth=3,
                             bsdf=bsdf)
        d["sensor"]["film"]["rfilter"] = {"type": rfilter}
        check(regen_applicable(lrt.load_dict(d, device="cpu"), "primal")
              == (rfilter == "box"), f"bsdf_small ({name}): the gradient "
              "takes the wrong adjoint")
        cos, norm_rel, gnorm, gfin = grad_vs_cpu(lrt, d, spp_p, (key,))
        grads[name] = dict(key=key, rfilter=rfilter, grad_cosine=cos,
                           grad_norm_rel=norm_rel, grad_norm=gnorm)
        check(gfin and gnorm > 0, f"bsdf_small ({name}): gradient not "
              "finite or zero")
        check(cos >= GRAD_COS_MIN and norm_rel <= GRAD_NORM_RTOL,
              f"bsdf_small ({name}): the card's gradient disagrees with the "
              f"CPU's: {grads[name]}")
    emit("bsdf_small", film=[res_p, res_p], spp=spp_p, max_depth=3,
         images=planes, grads=grads)

    # ---- 8c. the sweep kernel on BASELINE's full Cornell wavefront
    scene_g = lrt.load_dict(_cornell_dict(cornell_box, CORNELL_RES,
                                          "gaussian"))
    scene_b = lrt.load_dict(_cornell_dict(cornell_box, CORNELL_RES, "box"))
    n_lanes = CORNELL_RES * CORNELL_RES * CORNELL_SPP
    check(not regen_applicable(scene_g, "primal")
          and regen_applicable(scene_b, "primal"),
          "Cornell: the gaussian scene must take the fixed wavefront and the "
          "box scene the regenerating one")
    check(n_lanes <= MAX_WAVEFRONT, "Cornell: more lanes than one pass")
    kept = _first_queries(torch, lrt, ci, scene_g, CORNELL_SPP)
    wide = {}
    for kind in ("camera", "shadow"):
        rays, tris, boxes = kept[kind]
        check(rays.shape[1] == n_lanes, f"wide_kernel: the {kind} query has "
              f"{rays.shape[1]} rays, not {n_lanes}")
        wide[kind] = wide_vs_plain(torch, ci, rays, tris, boxes,
                                   scene_g.n_tris)
    emit("wide_kernel", card=smi, tris=scene_g.n_tris,
         chunks=int(scene_g.tri_boxes.shape[0]), plain_block=WIDE_BLOCK,
         **wide)
    for kind, r in wide.items():
        check_agreement(r, f"wide {kind} rays")
        check(r["share"] <= 1, f"wide {kind} rays: a time below its bound "
              f"{r}")
    del kept

    # ---- 8d. BASELINE's Cornell box: one fixed pass of 4,194,304 lanes,
    # in turns with bench.py's box-filter variant on the regen wavefront
    lrt.render(scene_g, spp=CORNELL_SPP, seed=SEED + 1)         # warm-ups
    lrt.render(scene_b, spp=CORNELL_TRACE_SPP, seed=SEED + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ci)
    fixed_s, img = timed_render(torch, lrt, scene_g, CORNELL_SPP)
    fixed_counts = launch_counts(ci)
    fixed_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ci)
    regen_s, img_b = timed_render(torch, lrt, scene_b, CORNELL_SPP)
    regen_counts = launch_counts(ci)
    regen_peak = torch.cuda.max_memory_allocated()
    fixed_reps, regen_reps = [fixed_s], [regen_s]
    for _ in range(1):          # 2 before PR 17's cuts for the time
        fixed_reps.append(timed_render(torch, lrt, scene_g, CORNELL_SPP)[0])
        regen_reps.append(timed_render(torch, lrt, scene_b, CORNELL_SPP)[0])
    traces = {}
    for name, sc, spp in (("fixed", scene_g, CORNELL_SPP),
                          ("regen", scene_b, CORNELL_TRACE_SPP)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            reset_counts(ci)
            secs_tr, _ = timed_render(torch, lrt, sc, spp)
        traces[name] = dict(spp=spp, **primal_trace(
            prof, secs_tr, ci.LAUNCHES - ci.SHADOW_LAUNCHES))
    t_fixed, t_regen = sorted(fixed_reps)[1], sorted(regen_reps)[1]
    finite = bool(torch.isfinite(img).all())
    emit("cornell_render", film=[CORNELL_RES, CORNELL_RES], spp=CORNELL_SPP,
         max_depth=scene_g.max_depth, tris=scene_g.n_tris, card=smi,
         lanes_per_pass=n_lanes, seconds=t_fixed, seconds_reps=fixed_reps,
         paths_per_s=n_lanes / t_fixed, finite=finite,
         shape=list(img.shape), mean=float(img.mean()),
         max_memory_allocated=fixed_peak, **split_counts(fixed_counts),
         regen_box=dict(seconds=t_regen, seconds_reps=regen_reps,
                        paths_per_s=n_lanes / t_regen,
                        mean=float(img_b.mean()),
                        finite=bool(torch.isfinite(img_b).all()),
                        max_memory_allocated=regen_peak,
                        **split_counts(regen_counts)),
         regen_over_fixed=t_regen / t_fixed, trace=traces)
    check(tuple(img.shape) == (CORNELL_RES, CORNELL_RES, 3),
          "Cornell image shape")
    check(finite and bool(torch.isfinite(img_b).all()),
          "Cornell image has non-finite values")
    # the two filters weight the same paths differently; their means agree
    # to the noise of 4 M paths
    check(0.05 < float(img.mean()) < 1.0
          and abs(float(img.mean()) / float(img_b.mean()) - 1) < 0.02,
          "Cornell image mean out of range")
    for what, c in (("fixed", fixed_counts), ("regen", regen_counts)):
        sc = split_counts(c)
        check(sc["bounce_launches"] > 0 and sc["shadow_launches"] > 0,
              f"the {what} Cornell render did not launch the sweep kernel "
              "for both queries")
    check(fixed_counts[0] == 2 * traces["fixed"]["trace_iterations"],
          "the fixed Cornell render: one shadow query per bounce")

    # ---- 8e. its gradients: the box variant through the replay adjoint,
    # the gaussian scene through the scan adjoint
    key = "textures.data"
    prim_calls = []
    orig_pass = tprb.render_pass

    def counted_pass(*a, **kw):
        c0 = launch_counts(ci)
        out = orig_pass(*a, **kw)
        if not torch.is_grad_enabled():
            prim_calls.append((c0, launch_counts(ci)))
        return out

    gruns, gvec = {}, {}
    for name, sc, walks in (("replay_box", scene_b, 1),
                            ("scan_gaussian", scene_g, 0)):
        tprb.render_pass = counted_pass
        try:
            grad_run(torch, lrt, ci, treplay, sc, CORNELL_GRAD_SPP, walks,
                     key)                                        # warm-up
            torch.cuda.reset_peak_memory_stats()
            runs = []
            for _ in range(3):
                prim_calls.clear()
                runs.append(grad_run(torch, lrt, ci, treplay, sc,
                                     CORNELL_GRAD_SPP, walks, key))
            peak = torch.cuda.max_memory_allocated()
        finally:
            tprb.render_pass = orig_pass
        counts = dict(runs[0][3])
        if walks == 0:
            # the scan adjoint: the primal's fixed passes (no grad), then
            # the differentiated passes (forward + checkpointed backward)
            prim = sum(b[0] - a[0] for a, b in prim_calls)
            counts.update(primal_launches=prim,
                          adjoint_launches=counts["fwd_launches"] - prim)
        check(all(r[3] == runs[0][3] for r in runs),
              f"Cornell render_grad ({name}): launch counts differ")
        primal = [timed_render(torch, lrt, sc, CORNELL_GRAD_SPP)[0]
                  for _ in range(3)]
        g = runs[0][1]
        t_grad, t_primal = sorted(r[0] for r in runs)[1], sorted(primal)[1]
        paths = CORNELL_RES * CORNELL_RES * CORNELL_GRAD_SPP
        gruns[name] = dict(
            seconds=t_grad, seconds_reps=[r[0] for r in runs],
            fwd_bwd_paths_per_s=paths / t_grad, primal_seconds=t_primal,
            primal_seconds_reps=primal, fwd_bwd_over_primal=t_grad / t_primal,
            grad_finite=bool(torch.isfinite(g).all()),
            grad_albedo=[[float(x) for x in g[i, 0:3]] for i in range(3)],
            image_mean=float(runs[0][2].mean()), max_memory_allocated=peak,
            **counts)
        check(gruns[name]["grad_finite"] and float(g[:, 0:3].sum()) > 0,
              f"Cornell render_grad ({name}): gradient not finite or not "
              "positive")
        check(counts["fwd_launches"] > 0 and counts["fwd_shadow_launches"]
              > 0, f"Cornell render_grad ({name}): no forward launches")
        if walks:
            check(counts["replay_launches"] > 0
                  and counts["replay_shadow_launches"] > 0,
                  f"Cornell render_grad ({name}): no replay launches")
        gvec[name] = g.double().reshape(-1)
    # the two routes walk the same paths (one sampler stream per pixel
    # sample); only the filters' weights differ, most at the film's border
    # (0.6 % in the gradient's norm at 32x32, on the CPU), so the adjoints
    # agree
    a, b = gvec["scan_gaussian"], gvec["replay_box"]
    routes = dict(cosine=float((a * b).sum() / (a.norm() * b.norm())),
                  norm_rel=abs(float(a.norm() / b.norm()) - 1.0))
    emit("cornell_render_grad", film=[CORNELL_RES, CORNELL_RES],
         spp=CORNELL_GRAD_SPP, key=key, card=smi, scan_vs_replay=routes,
         **gruns)
    check(routes["cosine"] >= GRAD_COS_MIN
          and routes["norm_rel"] <= GRAD_NORM_RTOL,
          f"Cornell render_grad: the scan adjoint disagrees with the replay "
          f"adjoint: {routes}")
    return dict(fixed=fixed_counts, regen=regen_counts, grads=gruns,
                wide=wide)


def timed_load(torch, fn):
    """(seconds, scene) of a scene build on the card, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, scene


def xml_phases(torch, np, lrt, ci, treplay, smi, workdir):
    """Phases xml_files, xml_small and xml_render: bench.py's workload path
    written to scene.xml, liver.ply, height.png and sky.exr in `workdir`
    and loaded by load_file -> the xml render's launch counts and its
    gradient's."""
    from liverrenderer_tpu_torch.bridge import numpy_tree
    from liverrenderer_tpu_torch.io.exr import read_exr_any
    from liverrenderer_tpu_torch.io.png import read_png
    from liverrenderer_tpu_torch.scene.liver_proxy import (BUMP, SKY,
                                                           liver_proxy_dict)
    from liverrenderer_tpu_torch.scene.meshio import load_mesh
    from liverrenderer_tpu_torch.scene.xml import parse_xml
    xf = _tests_module("torch_xml_files")
    # ---- 9a. the files at full size, and what reading them costs
    t0 = time.perf_counter()
    path, sizes = xf.write_proxy_files(
        os.path.join(workdir, "full"), WIDTH, HEIGHT, SPP, SUBDIV, SEED,
        bump_res=BUMP[0], sky=SKY)
    write_s = time.perf_counter() - t0
    base = os.path.dirname(path)
    read_s = {}
    for name, fn in (("scene.xml", lambda p: parse_xml(p)),
                     ("liver.ply", load_mesh), ("height.png", read_png),
                     ("sky.exr", read_exr_any)):
        t0 = time.perf_counter()
        fn(os.path.join(base, name))
        read_s[name] = time.perf_counter() - t0
    # the dict of the arrays read back: the same scene, no file read
    d_back = xf.inline_files(parse_xml(path), base, lrt.read_image,
                             load_mesh)
    gen_s, _ = timed_load(torch, lambda: liver_proxy_dict(
        WIDTH, HEIGHT, SPP, SUBDIV, SEED, bump=BUMP, sky=SKY))
    file_s, scene_f = timed_load(torch, lambda: lrt.load_file(path))
    dict_s, _ = timed_load(torch, lambda: lrt.load_dict(d_back))
    emit("xml_files", film=[WIDTH, HEIGHT], spp=SPP, bump=list(BUMP),
         sky=list(SKY), bytes=sizes, write_seconds=write_s,
         read_seconds=read_s, load_file_seconds=file_s,
         load_dict_seconds=dict_s, load_file_over_load_dict=file_s / dict_s,
         proxy_dict_seconds=gen_s)
    check(scene_f.device.type == "cuda" and scene_f.n_tris == 5120
          and scene_f.has_heightmap and scene_f.emitters.env_index >= 0,
          "xml_files: load_file did not build the bumped, sky-lit proxy "
          "on the card")

    # ---- 9b. at test size, loaded from files, card against CPU
    small, _ = xf.write_proxy_files(os.path.join(workdir, "small"), 16, 12,
                                    4, 2, SEED, bump_res=BUMP_SMALL[0],
                                    sky=SKY_SMALL)
    frac, mean_rel, mean, exact = image_vs_cpu(np, lrt, small, 4)
    cos, norm_rel, gnorm, gfin = grad_vs_cpu(lrt, small, 4)
    emit("xml_small", film=[16, 12], spp=4, pixel_frac=frac,
         pixel_exact=exact, mean_rel=mean_rel, mean=mean,
         grad_keys=["media.params"], grad_cosine=cos,
         grad_norm_rel=norm_rel, grad_norm=gnorm)
    check(frac >= PIX_FRAC_MIN and mean_rel <= MEAN_RTOL,
          "xml_small: the card's render disagrees with the CPU's")
    check(gfin and gnorm > 0, "xml_small: gradient not finite or zero")
    check(cos >= GRAD_COS_MIN and norm_rel <= GRAD_NORM_RTOL,
          "xml_small: the card's gradient disagrees with the CPU's")

    # ---- 9c. at full size: load and render, file and dict in turns
    torch.cuda.reset_peak_memory_stats()
    runs = {"file": [], "dict": []}
    counts, imgs, scenes = {}, {"file": [], "dict": []}, {}
    for which in ("file", "dict"):
        load_s, scenes[which] = timed_load(
            torch, lambda: lrt.load_file(path) if which == "file"
            else lrt.load_dict(d_back))
        reset_counts(ci)
        secs, img = timed_render(torch, lrt, scenes[which], CMP_SPP)
        counts.setdefault(which, launch_counts(ci))
        imgs[which].append(img)
        runs[which].append(dict(load_seconds=load_s, render_seconds=secs))
    peak = torch.cuda.max_memory_allocated()
    img = imgs["file"][0]
    finite = bool(torch.isfinite(img).all())
    # the same buffers: every tensor of the two scenes equal
    fa, fs = numpy_tree(scenes["file"])
    da, ds = numpy_tree(scenes["dict"])
    buffers_equal = fs == ds and fa.keys() == da.keys() and all(
        fa[k].dtype == da[k].dtype and np.array_equal(fa[k], da[k])
        for k in fa)
    # the film splat's index_add_ sums with atomics on the card, so two
    # renders of one scene differ in the last bits; in deterministic mode
    # they do not, and the file-loaded and dict-loaded images are equal
    # bit for bit
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det = {w: lrt.render(scenes[w], spp=CMP_SPP, seed=SEED)
                   for w in ("file", "dict")}
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    identical = bool(torch.equal(det["file"], det["dict"]))
    t_f = runs["file"][0]["render_seconds"]
    t_d = runs["dict"][0]["render_seconds"]
    paths = WIDTH * HEIGHT * CMP_SPP
    # ---- 9d. its gradient (one run after a warm-up) against a primal
    grad_run(torch, lrt, ci, treplay, scene_f, TRACE_SPP)        # warm-up
    g_s, g, _, grad_counts = grad_run(torch, lrt, ci, treplay, scene_f,
                                      GRAD_SPP)
    p_s, _ = timed_render(torch, lrt, scene_f, GRAD_SPP)
    emit("xml_render", film=[WIDTH, HEIGHT], spp=CMP_SPP, card=smi,
         tris=scene_f.n_tris, seconds=runs["file"][0]["render_seconds"],
         paths_per_s=paths / runs["file"][0]["render_seconds"],
         file_runs=runs["file"], dict_runs=runs["dict"],
         xml_over_dict=t_f / t_d, buffers_equal=buffers_equal,
         bit_identical_deterministic=identical,
         file_vs_dict_max_abs=float((imgs["file"][0] - imgs["dict"][0])
                                    .abs().max()),
         finite=finite,
         mean=float(img.mean()), launches=counts["file"][0],
         merge_launches=counts["file"][1],
         dict_launches=counts["dict"][0],
         dict_merge_launches=counts["dict"][1],
         max_memory_allocated=peak, grad_spp=GRAD_SPP, grad_seconds=g_s,
         grad_primal_seconds=p_s, fwd_bwd_over_primal=g_s / p_s,
         grad_finite=bool(torch.isfinite(g).all()),
         grad_abs_max=float(g.abs().max()), **grad_counts)
    check(buffers_equal, "xml_render: load_file and load_dict built "
          "different buffers")
    check(identical, "xml_render: the file-loaded image differs from the "
          "dict-loaded one in deterministic mode")
    check(finite and 0.05 < float(img.mean()) < 5.0,
          "xml_render: image not finite or its mean out of range")
    check(counts["file"] == counts["dict"] and counts["file"][0] > 0
          and counts["file"][1] > 0, "xml_render: the file-loaded and "
          "dict-loaded renders launched the kernels differently or not "
          "at all")
    check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
          "xml_render: gradient not finite or zero")
    return dict(counts=counts["file"], grad_counts=grad_counts)


def emitter_sampler_phases(torch, np, lrt, smi, workdir):
    """Phases emitters_small and samplers_small: the directional, spot and
    projector lights (its slide a PNG file), the pattern samplers and the
    mitchell, catmullrom and lanczos filters on the gradient tests' plane,
    card against CPU; the lanczos against the gaussian on the Cornell
    box's fixed pass, timed in turns."""
    from liverrenderer_tpu_torch.scene.cornell import (cornell_box,
                                                       plane_light_dict)
    from liverrenderer_tpu_torch.scene.transform import Transform
    res, spp = EMITTER_SMALL
    down = Transform().translate([0.0, 0.0, 1.5]).rotate([1, 0, 0], 180) \
        .matrix.copy()
    slide = os.path.join(workdir, "slide.png")
    lrt.write_image(slide, np.random.default_rng(SEED).uniform(
        0.0, 1.0, (16, 16, 3)).astype(np.float32))
    lights = {
        "directional": {"type": "directional",
                        "direction": [0.2, -0.3, -1.0],
                        "irradiance": {"type": "rgb",
                                       "value": [3.0, 2.5, 2.0]}},
        "spot": {"type": "spot", "to_world": down, "cutoff_angle": 30.0,
                 "intensity": {"type": "rgb", "value": [8.0, 7.0, 6.0]}},
        "projector": {"type": "projector", "to_world": down, "fov": 60.0,
                      "scale": 5.0, "irradiance": {"type": "bitmap",
                                                   "filename": slide}}}

    def plane(**kw):
        return plane_light_dict(res, integrator="path", max_depth=3, **kw)

    def compare(d, n_spp, what):
        frac, mean_rel, mean, exact = image_vs_cpu(np, lrt, d, n_spp)
        check(frac >= PIX_FRAC_MIN and mean_rel <= MEAN_RTOL and mean > 0,
              f"{what}: the card's render disagrees with the CPU's")
        return dict(pixel_frac=frac, pixel_exact=exact, mean_rel=mean_rel,
                    mean=mean)

    out = {k: compare(plane(light=v), spp, f"emitters_small ({k})")
           for k, v in lights.items()}
    emit("emitters_small", film=[res, res], spp=spp, **out)

    samplers = {}
    for kind in ("stratified", "multijitter", "orthogonal", "ldsampler"):
        for n_spp in SAMPLER_SPP:
            d = plane()
            d["sensor"]["sampler"] = {"type": kind, "sample_count": n_spp}
            samplers[f"{kind}_{n_spp}"] = compare(
                d, n_spp, f"samplers_small ({kind}, {n_spp} spp)")
    filters = {}
    for rf in ("mitchell", "catmullrom", "lanczos"):
        d = plane()
        d["sensor"]["film"]["rfilter"] = {"type": rf}
        filters[rf] = compare(d, spp, f"samplers_small ({rf})")
    d = plane(bsdf={"type": "roughconductor", "alpha": 0.3,
                    "material": "Al"})
    d["sensor"]["film"]["rfilter"] = {"type": "mitchell"}
    cos, norm_rel, gnorm, gfin = grad_vs_cpu(lrt, d, spp, ("bsdfs.params",))
    check(gfin and gnorm > 0 and cos >= GRAD_COS_MIN
          and norm_rel <= GRAD_NORM_RTOL, "samplers_small: the mitchell "
          "scan-adjoint gradient disagrees with the CPU's")
    # the lanczos splat (36 scatter-adds per sample) against the
    # gaussian's (16) on the Cornell box's fixed pass: gaussian, lanczos,
    # lanczos, gaussian
    cb = {rf: lrt.load_dict(_cornell_dict(cornell_box, CORNELL_RES, rf))
          for rf in ("gaussian", "lanczos")}
    lrt.render(cb["lanczos"], spp=CORNELL_SPP, seed=SEED)        # warm-up
    secs = {"gaussian": [], "lanczos": []}
    for rf in ("gaussian", "lanczos", "lanczos", "gaussian"):
        secs[rf].append(timed_render(torch, lrt, cb[rf], CORNELL_SPP)[0])
    emit("samplers_small", film=[res, res], spp=spp,
         sampler_spp=list(SAMPLER_SPP), samplers=samplers, filters=filters,
         mitchell_grad=dict(key="bsdfs.params", cosine=cos,
                            norm_rel=norm_rel, norm=gnorm),
         cornell_fixed_pass=dict(film=[CORNELL_RES, CORNELL_RES],
                                 spp=CORNELL_SPP, card=smi,
                                 seconds_reps=secs,
                                 lanczos_over_gaussian=sum(secs["lanczos"])
                                 / sum(secs["gaussian"])))


def _chroma_dict(cornell_box, res, integrator, depth, sigma=CHROMA):
    """tests/test_volpathmis.py's chroma_fog: the Cornell box in a
    chromatic homogeneous sensor fog (albedo 0.8, isotropic)."""
    d = cornell_box()
    d["integrator"] = {"type": integrator, "max_depth": depth}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": res, "height": res,
                           "rfilter": {"type": "box"}}
    d["sensor"]["medium"] = {
        "type": "homogeneous",
        "sigma_t": {"type": "rgb", "value": list(sigma)},
        "albedo": {"type": "rgb", "value": [0.8] * 3},
        "phase": {"type": "isotropic"}}
    return d


def grid_grad_vs_cpu(lrt, d, spp):
    """The media.grids gradient of the mean image on the card and on the
    CPU: the voxels past GRID_GRAD_BLOWUP must be the same in both, the
    others are compared by cosine and norm."""
    import torch

    def grad(sc):
        _, g, _ = lrt.render_grad(sc, {"media.grids": sc.media.grids},
                                  lambda im: im.mean(), spp=spp, seed=SEED)
        return g["media.grids"].cpu().double().reshape(-1)

    b = grad(lrt.load_dict(d, device="cpu"))
    a = grad(lrt.load_dict(d))
    big_a, big_b = a.abs() > GRID_GRAD_BLOWUP, b.abs() > GRID_GRAD_BLOWUP
    a0, b0 = a[~big_b], b[~big_b]
    return dict(grad_cosine=float((a0 * b0).sum() / (a0.norm() * b0.norm())),
                grad_norm_rel=abs(float(a0.norm() / b0.norm()) - 1.0),
                grad_norm=float(b0.norm()), blowup_voxels=int(big_b.sum()),
                blowup_same=bool(torch.equal(big_a, big_b)),
                grad_finite=bool(a.isfinite().all()))


def media_phases(torch, np, lrt, ci, treplay, smi):
    """Phases media_small, grid_render, volpathmis_render and bvh_query ->
    the launch counts the kernels line reports."""
    from torch.profiler import ProfilerActivity, profile
    from liverrenderer_tpu_torch.accel import bvh as tbvh
    from liverrenderer_tpu_torch.accel.intersect import (_tri_strategy,
                                                         _bvh_tris,
                                                         ray_intersect)
    from liverrenderer_tpu_torch.core.types import Ray
    from liverrenderer_tpu_torch.scene.cornell import (cornell_box,
                                                       grid_cornell_box,
                                                       grid_cube_dict,
                                                       smooth_noise_grid)
    from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict

    # ---- 11a. the stock media at test size, card against CPU
    res_s, spp_s = MEDIA_SMALL
    grid_s = smooth_noise_grid(16, SEED)
    cases = {"grid_cube": grid_cube_dict(res_s, grid=grid_s, scale=2.0,
                                         light=MEDIA_POINT),
             "grid_cornell": grid_cornell_box(res_s, grid_res=32, seed=SEED),
             "volpathmis_chroma_fog": _chroma_dict(cornell_box, res_s,
                                                   "volpathmis", 6)}
    for name, phase in MEDIA_PHASES.items():
        cases[f"phase_{name}"] = grid_cube_dict(
            res_s, grid=grid_s, scale=2.0, light=MEDIA_POINT, phase=phase)
    bio = liver_proxy_dict(16, 12, spp_s, 2, SEED)
    bio["integrator"]["type"] = "volpathmis"
    cases["volpathmis_bio"] = bio
    small = {}
    for name, d in cases.items():
        frac, mean_rel, mean, exact = image_vs_cpu(np, lrt, d, spp_s)
        small[name] = dict(pixel_frac=frac, pixel_exact=exact,
                           mean_rel=mean_rel, mean=mean)
        check(frac >= PIX_FRAC_MIN and mean_rel <= MEAN_RTOL and mean > 0,
              f"media_small {name}: the card's render disagrees with the "
              f"CPU's: {small[name]}")
    gg = grid_grad_vs_cpu(lrt, cases["grid_cube"], spp_s)
    small["grid_cube"].update(gg)
    cos, norm_rel, gnorm, gfin = grad_vs_cpu(
        lrt, cases["volpathmis_chroma_fog"], spp_s)
    small["volpathmis_chroma_fog"].update(
        grad_cosine=cos, grad_norm_rel=norm_rel, grad_norm=gnorm)
    emit("media_small", film=[res_s, res_s], spp=spp_s, **small)
    check(gg["grad_finite"] and gg["blowup_same"] and gg["grad_norm"] > 0
          and gg["grad_cosine"] >= GRAD_COS_MIN
          and gg["grad_norm_rel"] <= GRAD_NORM_RTOL,
          f"media_small: the card's media.grids gradient disagrees: {gg}")
    check(gfin and gnorm > 0 and cos >= GRAD_COS_MIN
          and norm_rel <= GRAD_NORM_RTOL,
          "media_small: the card's volpathmis gradient disagrees")

    # ---- 11b. the grid medium at full size
    t0 = time.perf_counter()
    grid = smooth_noise_grid(GRID_N, SEED)
    gscene = lrt.load_dict(grid_cornell_box(GRID_RES, grid=grid,
                                            max_depth=GRID_DEPTH))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(gscene.device.type == "cuda" and gscene.needs_medium_nee,
          "grid scene not on the card or without medium NEE")
    # profiles of the same cube of homogeneous fog at the grid's mean
    # density (after its warm-up; it counts the iterations the null
    # collisions add) and of the grid render, which warms the timed run up
    homog = grid_cornell_box(GRID_RES, grid=grid, max_depth=GRID_DEPTH)
    homog["grid_box"]["interior"] = {
        "type": "homogeneous", "scale": 4.0,
        "sigma_t": {"type": "rgb", "value": [float(grid.mean())] * 3},
        "albedo": {"type": "rgb", "value": [0.8] * 3},
        "phase": {"type": "hg", "g": 0.5}}
    hscene = lrt.load_dict(homog)
    lrt.render(hscene, spp=GRID_SPP, seed=SEED + 1)           # warm-up
    iters = {}
    for name, sc in (("homogeneous", hscene), ("grid", gscene)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            reset_counts(ci)
            t1 = time.perf_counter()
            lrt.render(sc, spp=GRID_SPP, seed=SEED)
            torch.cuda.synchronize()
            secs_tr = time.perf_counter() - t1
        c = split_counts(launch_counts(ci))
        iters[name] = dict(seconds=secs_tr, **c, **primal_trace(
            prof, secs_tr, c["bounce_launches"]))
    del hscene
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ci)
    t1 = time.perf_counter()
    img = lrt.render(gscene, spp=GRID_SPP, seed=SEED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    grid_counts = launch_counts(ci)
    gsplit = split_counts(grid_counts)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(img).all())
    paths = GRID_RES * GRID_RES * GRID_SPP
    n_walks = -(-GRID_RES * GRID_RES // treplay.regen_mod.TILE_PIX)
    torch.cuda.reset_peak_memory_stats()
    g_secs, gg_full, g_img, grid_grad = grad_run(
        torch, lrt, ci, treplay, gscene, GRID_GRAD_SPP, walks=n_walks,
        key="media.grids")
    g_peak = torch.cuda.max_memory_allocated()
    big = gg_full.abs() > GRID_GRAD_BLOWUP
    g_rest = gg_full[~big]
    emit("grid_render", film=[GRID_RES, GRID_RES], spp=GRID_SPP,
         grid=[GRID_N] * 3, max_depth=gscene.max_depth, card=smi,
         build_seconds=build_s, seconds=round(secs, 3),
         paths_per_s=paths / secs, mpaths_per_s=paths / secs / 1e6,
         finite=finite, mean=float(img.mean()),
         iterations=gsplit["bounce_launches"], **gsplit,
         max_memory_allocated=peak,
         trace=iters, iterations_over_homogeneous=(
             iters["grid"]["bounce_launches"]
             / max(iters["homogeneous"]["bounce_launches"], 1)),
         grad_spp=GRID_GRAD_SPP, grad_walks=n_walks, grad_seconds=g_secs,
         grad_fwd_bwd_paths_per_s=GRID_RES * GRID_RES * GRID_GRAD_SPP
         / g_secs, grad_max_memory_allocated=g_peak,
         grad_finite=bool(torch.isfinite(gg_full).all()),
         grad_norm=float(gg_full.norm()),
         grad_norm_below_blowup=float(g_rest.norm()),
         grad_blowup_voxels=int(big.sum()),
         grad_nonzero_share=float((gg_full[..., 0] != 0).float().mean()),
         grad_image_mean=float(g_img.mean()), **grid_grad)
    check(tuple(img.shape) == (GRID_RES, GRID_RES, 3) and finite
          and 0.0 < float(img.mean()) < 1.0, "grid image")
    check(gsplit["bounce_launches"] > 0 and gsplit["shadow_launches"] > 0,
          "the grid render did not launch the sweep for both queries")
    check(bool(torch.isfinite(gg_full).all())
          and float(g_rest.abs().max()) > 0, "grid gradient")
    for k in ("fwd_launches", "replay_launches", "fwd_shadow_launches",
              "replay_shadow_launches"):
        check(grid_grad.get(k, 0) > 0, f"grid render_grad: {k} is 0")
    del gscene, img, gg_full, g_img

    # ---- 11c. volpathmis against volpath on the chromatic fog, in turns
    mis = lrt.load_dict(_chroma_dict(cornell_box, MIS_RES, "volpathmis",
                                     MIS_DEPTH))
    vp = lrt.load_dict(_chroma_dict(cornell_box, MIS_RES, "volpath",
                                    MIS_DEPTH))
    runs = {"volpathmis": [], "volpath": []}
    for name, sc in (("volpathmis", mis), ("volpath", vp), ("volpath", vp),
                     ("volpathmis", mis)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ci)
        secs, img = timed_render(torch, lrt, sc, MIS_SPP)
        runs[name].append(dict(
            seconds=secs, counts=launch_counts(ci),
            peak=torch.cuda.max_memory_allocated(),
            means=[float(x) for x in img.mean((0, 1))],
            finite=bool(torch.isfinite(img).all())))
    var = {}
    for name in runs:
        sc = lrt.load_dict(_chroma_dict(cornell_box, VAR_RES, name,
                                        MIS_DEPTH))
        imgs = torch.stack([lrt.render(sc, spp=VAR_SPP, seed=200 + k)
                            for k in range(VAR_SEEDS)])
        var[name] = float(imgs.var(0).mean())
    out = {}
    for name, rs in runs.items():
        out[name] = dict(seconds=[r["seconds"] for r in rs],
                         max_memory_allocated=[r["peak"] for r in rs],
                         image_mean_rgb=rs[0]["means"],
                         **split_counts(rs[0]["counts"]),
                         pixel_variance=var[name])
        check(all(r["finite"] for r in rs), f"{name}: non-finite image")
        check(all(r["counts"] == rs[0]["counts"] for r in rs),
              f"{name}: launch counts differ between runs")
        check(rs[0]["counts"][0] > 0 and rs[0]["counts"][2] > 0,
              f"{name}: no bounce or shadow sweep")
    fastest = {k: min(v["seconds"]) for k, v in out.items()}
    emit("volpathmis_render", film=[MIS_RES, MIS_RES], spp=MIS_SPP,
         max_depth=MIS_DEPTH, sigma_t=list(CHROMA), card=smi,
         lanes_per_fixed_pass=MIS_RES * MIS_RES * MIS_SPP,
         mis_over_volpath=[a["seconds"] / b["seconds"] for a, b in
                           zip(runs["volpathmis"], runs["volpath"])],
         variance_film=[VAR_RES, VAR_RES], variance_spp=VAR_SPP,
         variance_seeds=VAR_SEEDS,
         variance_ratio=var["volpathmis"] / var["volpath"],
         min_seconds=fastest, **out)
    del mis, vp

    # ---- 11d. the lockstep BVH: a mesh past 2^21 triangles, and the
    # sweep kernel against it at subdiv 8
    def bvh_scene(subdiv):
        t1 = time.perf_counter()
        sc = lrt.load_dict(liver_proxy_dict(16, 12, 1, subdiv, SEED))
        torch.cuda.synchronize()
        return sc, time.perf_counter() - t1, dict(tbvh.BUILD_INFO)

    def query(sc, ray):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        si = ray_intersect(sc, ray)
        torch.cuda.synchronize()
        return time.perf_counter() - t1, si

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    big, big_s, info = bvh_scene(BVH_SUBDIV)
    check(big.n_tris == 20 * 4 ** BVH_SUBDIV
          and big.n_tris > ci.MAX_STREAM_TRIS
          and _tri_strategy(big) is _bvh_tris,
          f"the {big.n_tris}-triangle mesh does not take the BVH")
    check(info.get("build_tris") == big.n_tris,
          "the large mesh's BVH was not built by the C++ build")
    r = proxy_rays(torch, big, BVH_RAYS // 2, BVH_RAYS // 2, gen)
    ray = Ray(o=r[0:3].T + big.tri_center, d=r[3:6].T.contiguous(),
              maxt=r[6].contiguous())
    query(big, Ray(o=ray.o[:1024], d=ray.d[:1024], maxt=ray.maxt[:1024]))
    q_secs, si_big = query(big, ray)
    t1 = time.perf_counter()
    img = lrt.render(big, spp=1, seed=SEED)
    torch.cuda.synchronize()
    r_secs = time.perf_counter() - t1
    res_big = dict(tris=big.n_tris, scene_seconds=big_s,
                   native_compile_seconds=info.get("seconds"),
                   native_build_seconds=info.get("build_seconds"),
                   bvh_depth=big.bvh.depth, query_rays=BVH_RAYS,
                   query_seconds=q_secs, hits=int(si_big.valid.sum()),
                   render_film=[16, 12], render_spp=1,
                   render_seconds=r_secs,
                   render_finite=bool(torch.isfinite(img).all()),
                   render_mean=float(img.mean()))
    check(res_big["render_finite"] and res_big["hits"] > BVH_RAYS // 4,
          f"bvh_query: {res_big}")
    del big, si_big, img
    mid, mid_s, info = bvh_scene(BVH_CMP_SUBDIV)
    r = proxy_rays(torch, mid, BVH_RAYS // 2, BVH_RAYS // 2, gen)
    ray = Ray(o=r[0:3].T + mid.tri_center, d=r[3:6].T.contiguous(),
              maxt=r[6].contiguous())
    mid_bvh = mid.replace(intersector="bvh")
    query(mid, ray)
    query(mid_bvh, ray)                                         # warm-ups
    times = {"kernel": [], "bvh": []}
    reset_counts(ci)
    for name in ("kernel", "bvh", "bvh", "kernel"):
        s_, si = query(mid if name == "kernel" else mid_bvh, ray)
        times[name].append(s_)
        if name == "kernel":
            si_k = si
        else:
            si_b = si
    cmp_counts = launch_counts(ci)
    same = (si_k.prim == si_b.prim) & si_k.valid
    both = si_k.valid & si_b.valid
    # compute_si re-derives t from the winner's row, so an equal prim gives
    # an equal t unless the kernel's hit lies on an edge Moeller-Trumbore
    # rejects (then the kernel's own t stays)
    dt = ((si_k.t - si_b.t).abs() / si_b.t.abs().clamp(min=1e-30))[same]
    res_mid = dict(
        tris=mid.n_tris, scene_seconds=mid_s,
        native_build_seconds=info.get("build_seconds"), rays=BVH_RAYS,
        kernel_seconds=times["kernel"], bvh_seconds=times["bvh"],
        bvh_over_kernel=sorted(times["bvh"])[0] / sorted(times["kernel"])[0],
        kernel_sweep_launches=cmp_counts[0] // 2,
        kernel_merge_launches=cmp_counts[1] // 2,
        hits=int(si_k.valid.sum()),
        hit_agree=float((si_k.valid == si_b.valid).float().mean()),
        prim_agree=float(same.sum()) / max(int(both.sum()), 1),
        t_equal_share=float((si_k.t[same] == si_b.t[same]).float()
                            .mean()),
        max_rel_dt=float(dt.max()) if dt.numel() else 0.0,
        ties_dt_max=float((si_k.t - si_b.t)[both & ~same].abs().max())
        if bool((both & ~same).any()) else 0.0)
    emit("bvh_query", card=smi, mesh=f"liver_proxy.liver_mesh(subdiv, "
         f"{SEED})", past_stream_limit=res_big, against_kernel=res_mid)
    check(res_mid["hit_agree"] >= HIT_AGREE_MIN
          and res_mid["prim_agree"] >= PRIM_AGREE_MIN
          and res_mid["t_equal_share"] >= HIT_AGREE_MIN
          and res_mid["max_rel_dt"] <= T_RTOL,
          f"bvh_query: the BVH and the sweep kernel disagree: {res_mid}")
    return dict(grid_counts=grid_counts, grid_grad=grid_grad,
                mis_counts=runs["volpathmis"][0]["counts"],
                vp_counts=runs["volpath"][0]["counts"])


def _event_lanes(torch, inputs, scene, n):
    """Lanes for one subsurface_event on `scene`'s device: the rays of
    torch_sss_inputs.event_rays, their hits, directions bent into the
    surface, a sampler per lane."""
    from liverrenderer_tpu_torch.accel.intersect import ray_intersect
    from liverrenderer_tpu_torch.core.rng import make_sampler
    from liverrenderer_tpu_torch.core.types import Ray
    dev = scene.device
    o, d = (torch.from_numpy(x).to(dev) for x in
            inputs.event_rays(n, SEED + 4))
    si = ray_intersect(scene, Ray(o=o, d=d, maxt=torch.full(
        (n,), float("inf"), device=dev)))
    refr = d - 0.3 * si.ng
    refr = refr / refr.norm(dim=-1, keepdim=True)
    return si, refr, make_sampler(torch.arange(n, device=dev), 0, SEED + 9)


class EventTally:
    """Wraps the subsurface event (module attributes of path and event,
    restored on exit): counts its calls and the kernel launches made
    inside it, captures copies of the first call's queries (capture=True),
    and tallies what the event did to the lanes it ran for (tally=True:
    host syncs, so not in a timed run)."""

    def __init__(self, torch, ci, capture=False, tally=False):
        from liverrenderer_tpu_torch.integrators import path as tpath
        from liverrenderer_tpu_torch.ssub import event as tevent
        self.torch, self.ci, self.mods = torch, ci, (tpath, tevent)
        self.capture, self.tally = capture, tally
        self.calls, self.queries = 0, []
        self.launches = [0, 0, 0, 0]
        self.lanes = dict(lane_bounces=0, events=0, passthrough=0,
                          vae_exit=0, absorbed=0, died=0)

    def __enter__(self):
        tpath, tevent = self.mods
        self.orig_ev = tevent.subsurface_event
        self.orig_q = self.ci.intersect_closest
        first = []

        def query(rays, tris, boxes, shadow=False):
            if first:
                self.queries.append((rays.clone(), tris, boxes, shadow))
            return self.orig_q(rays, tris, boxes, shadow=shadow)

        def event(scene, si, refr_d, sampler, active):
            c0 = launch_counts(self.ci)
            if self.capture and self.calls == 0:
                first.append(1)
            try:
                ev, smp = self.orig_ev(scene, si, refr_d, sampler, active)
            finally:
                first.clear()
            self.launches = [a + c - b for a, b, c in zip(
                self.launches, c0, launch_counts(self.ci))]
            self.calls += 1
            if self.tally:
                t = self.lanes
                t["lane_bounces"] += active.numel()
                t["events"] += int(active.sum())
                t["passthrough"] += int(ev.passthrough.sum())
                t["vae_exit"] += int((ev.alive & ~ev.passthrough).sum())
                t["absorbed"] += int(ev.absorbed.sum())
                t["died"] += int((active & ~ev.alive & ~ev.absorbed).sum())
            return ev, smp

        self.ci.intersect_closest = query
        tpath.subsurface_event = tevent.subsurface_event = event
        return self

    def __exit__(self, *exc):
        tpath, tevent = self.mods
        tpath.subsurface_event = tevent.subsurface_event = self.orig_ev
        self.ci.intersect_closest = self.orig_q

    def shares(self):
        """Outcomes as shares of the events, and the events' share of
        the lane-bounces that ran the event."""
        n = max(self.lanes["events"], 1)
        out = {k: v / n for k, v in self.lanes.items()
               if k not in ("events", "lane_bounces")}
        out["events_per_lane_bounce"] = n / max(self.lanes["lane_bounces"],
                                                1)
        return out


def sss_phases(torch, np, lrt, ci, treplay, smi, workdir):
    """Phases sss_small, sss_kernel, sss_render, dipole_render and
    sss_render_grad -> the launch counts the kernels line reports.  The
    VAE is a seeded synthetic model at the published widths, written under
    workdir and substituted for the reference's absent files."""
    from torch.profiler import ProfilerActivity, profile
    from liverrenderer_tpu_torch.scene.liver_proxy import sss_liver_dict
    from liverrenderer_tpu_torch.ssub import event as tevent
    from liverrenderer_tpu_torch.ssub import vae as tvae
    inputs = _tests_module("torch_sss_inputs")
    model = inputs.write_model(workdir, seed=SEED + 3)
    out = {}
    with inputs.substituted(*model, tvae):
        # ---- 12a. at test size, card against CPU
        check(not torch.backends.cuda.matmul.allow_tf32,
              "TF32 matmuls are on: the VAE would differ from the CPU")
        res_s, spp_s = SSS_SMALL
        cases = {"vae_sphere": inputs.sphere_dict("vaescatter", res_s,
                                                  rfilter="tent"),
                 "dipole_sphere": inputs.sphere_dict("dipole", res_s,
                                                     rfilter="tent"),
                 "vae_proxy": sss_liver_dict(res_s, 12, spp_s, subdiv=2,
                                             sky=SKY_SMALL)}
        images = {}
        for name, d in cases.items():
            frac, mean_rel, mean, exact = image_vs_cpu(np, lrt, d, spp_s)
            images[name] = dict(pixel_frac=frac, pixel_exact=exact,
                                mean_rel=mean_rel, mean=mean)
            check(frac >= PIX_FRAC_MIN and mean_rel <= MEAN_RTOL,
                  f"sss_small: {name}: the card's render disagrees with "
                  f"the CPU's: {images[name]}")
            check(mean > 1e-3, f"sss_small: {name}: black image")
        gd = inputs.sphere_dict("vaescatter", 8, depth=4, rfilter="tent")
        check(not treplay.replay_applicable(
            load_scene(lrt, gd), {"emitters.params": None}, spp_s),
            "sss_small: a subsurface scene took the replay adjoint")
        cos, norm_rel, gnorm, gfin = grad_vs_cpu(lrt, gd, spp_s,
                                                 ("emitters.params",))
        check(gfin and gnorm > 0, "sss_small: gradient not finite or zero")
        check(cos >= GRAD_COS_MIN and norm_rel <= GRAD_NORM_RTOL,
              "sss_small: the card's gradient disagrees with the CPU's")
        ed = inputs.sphere_dict("vaescatter", 8, extra=inputs.SHEET,
                                sigma_t=(3.0, 4.0, 6.0))
        evs = {}
        for dev in ("cpu", "cuda"):
            sc = load_scene(lrt, ed, dev)
            si, refr, smp = _event_lanes(torch, inputs, sc,
                                         SSS_EVENT_LANES)
            ev, smp = tevent.subsurface_event(sc, si, refr, smp, si.valid)
            evs[dev] = {k: getattr(ev, k).cpu() for k in
                        ("alive", "passthrough", "absorbed")}
            evs[dev]["dim"] = smp.dim.cpu()
        masks = {k: float((evs["cpu"][k] == evs["cuda"][k]).float().mean())
                 for k in ("alive", "passthrough", "absorbed")}
        emit("sss_small", film=[res_s, res_s], spp=spp_s, images=images,
             grad_key="emitters.params", grad_route="scan adjoint",
             grad_cosine=cos, grad_norm_rel=norm_rel, grad_norm=gnorm,
             event_lanes=SSS_EVENT_LANES, event_masks_equal=masks,
             event_alive=int(evs["cuda"]["alive"].sum()),
             event_passthrough=int(evs["cuda"]["passthrough"].sum()),
             event_absorbed=int(evs["cuda"]["absorbed"].sum()))
        check(min(masks.values()) >= 0.99,
              f"sss_small: event masks differ card vs CPU: {masks}")
        check(bool(torch.equal(evs["cpu"]["dim"], evs["cuda"]["dim"])),
              "sss_small: the event's sampler dimensions differ")

        # ---- 12b. the main path at full size, and the event's queries
        t0 = time.perf_counter()
        scene = lrt.load_dict(sss_liver_dict(WIDTH, HEIGHT, SSS_SPP,
                                             subdiv=SUBDIV, seed=SEED))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(scene.device.type == "cuda" and scene.ssub.has_vae
              and scene.n_tris == 5120 and scene.integrator == "path",
              "sss proxy: not on the card, or without its VAE")
        with EventTally(torch, ci, capture=True, tally=True) as warm:
            lrt.render(scene, spp=1, seed=SEED + 1)           # warm-up
            torch.cuda.synchronize()
        groups = {"zero_scatter": warm.queries[0:1],
                  "projection": warm.queries[1:5],
                  "exit_shadow": warm.queries[5:6]}
        check(len(warm.queries) == 6 and warm.queries[5][3]
              and not any(q[3] for q in warm.queries[:5]),
              "sss_kernel: the event did not make its six queries")
        kern = {}
        for gname, qs in groups.items():
            rs = [kernel_vs_plain(torch, ci, r, t, bx, scene.n_tris,
                                  reps_plain=3)[0] for r, t, bx, _ in qs]
            kern[gname] = dict(
                queries=len(rs), n_rays=sum(r["n_rays"] for r in rs),
                hits=sum(r["hits"] for r in rs),
                hit_agree=min(r["hit_agree"] for r in rs),
                prim_agree=min(r["prim_agree"] for r in rs),
                max_abs_dt=max(r["max_abs_dt"] for r in rs),
                max_rel_dt=max(r["max_rel_dt"] for r in rs),
                short_maxt_rays=[int((r_[6] < 0.1).sum())
                                 for r_, _, _, _ in qs],
                ms=[r["ms"] for r in rs], sweep_ms=[r["sweep_ms"]
                                                    for r in rs],
                plain_ms=[r["plain_ms"] for r in rs],
                bound_ms=[r["bound_ms"] for r in rs],
                bound_by=[r["bound_by"] for r in rs],
                needed_tests=[r["needed_tests"] for r in rs],
                share=[r["share"] for r in rs],
                splits=[r["splits"] for r in rs])
            check_agreement(kern[gname], f"sss_kernel {gname}")
        emit("sss_kernel", film=[WIDTH, HEIGHT], tris=scene.n_tris,
             card=smi, **kern)
        out["kernel"] = kern

        torch.cuda.reset_peak_memory_stats()
        reset_counts(ci)
        with EventTally(torch, ci) as tally:
            secs, img = timed_render(torch, lrt, scene, SSS_SPP)
        counts = launch_counts(ci)
        peak = torch.cuda.max_memory_allocated()
        plain = lrt.load_dict(sss_liver_dict(WIDTH, HEIGHT, SSS_SPP,
                                             kind=None, subdiv=SUBDIV,
                                             seed=SEED))
        lrt.render(plain, spp=1, seed=SEED + 1)               # warm-up
        # in turns: sss (above), plain, plain, sss
        reset_counts(ci)
        plain_s, plain_img = timed_render(torch, lrt, plain, SSS_SPP)
        plain_counts = launch_counts(ci)
        plain_reps = [plain_s, timed_render(torch, lrt, plain, SSS_SPP)[0]]
        sss_reps = [secs, timed_render(torch, lrt, scene, SSS_SPP)[0]]
        lrt.render(scene, spp=SSS_TRACE_SPP, seed=SEED)       # warm-up
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with EventTally(torch, ci) as tr:
                secs_tr, _ = timed_render(torch, lrt, scene, SSS_TRACE_SPP)
        trace = primal_trace(prof, secs_tr, tr.calls)
        ev_l = tally.launches
        shadow_nee = counts[2] - ev_l[2]
        finite = bool(torch.isfinite(img).all())
        paths = WIDTH * HEIGHT * SSS_SPP
        emit("sss_render", film=[WIDTH, HEIGHT], spp=SSS_SPP,
             max_depth=scene.max_depth, tris=scene.n_tris, card=smi,
             kind="vaescatter (synthetic VAE weights, published widths)",
             build_seconds=build_s, seconds=secs, paths_per_s=paths / secs,
             iterations=tally.calls, finite=finite, shape=list(img.shape),
             mean=float(img.mean()), max_memory_allocated=peak,
             launches=dict(bounce=counts[0] - ev_l[0] - shadow_nee,
                           sss_event=ev_l[0] - ev_l[2],
                           sss_exit_shadow=ev_l[2], nee_shadow=shadow_nee,
                           merge=counts[1], sss_event_merge=ev_l[1]),
             seconds_reps=sss_reps, plain_seconds_reps=plain_reps,
             plain_mean=float(plain_img.mean()),
             plain_launches=split_counts(plain_counts),
             sss_over_plain=sum(sss_reps) / sum(plain_reps),
             trace_spp=SSS_TRACE_SPP,
             trace=trace, event_shares_1spp=warm.shares(),
             event_lanes_1spp=warm.lanes["events"])
        check(tuple(img.shape) == (HEIGHT, WIDTH, 3) and finite,
              "sss_render: image shape or non-finite values")
        check(0.01 < float(img.mean()) < 10.0, "sss_render: image mean")
        check(counts[0] > 0 and counts[1] > 0 and ev_l[0] > 0,
              "sss_render: the sweep / merge kernels or the event's "
              "queries were not launched")
        out["counts"], out["plain_counts"] = counts, plain_counts

        # ---- 12c. the dipole at the same size
        t0 = time.perf_counter()
        dip = lrt.load_dict(sss_liver_dict(WIDTH, HEIGHT, SSS_SPP,
                                           kind="dipole", subdiv=SUBDIV,
                                           seed=SEED))
        torch.cuda.synchronize()
        dip_build = time.perf_counter() - t0
        check(dip.ssub.has_dipole and float(
            dip.ssub.dip_irradiance.max()) > 0,
            "dipole proxy: no irradiance point cloud")
        lrt.render(dip, spp=1, seed=SEED + 1)                 # warm-up
        reset_counts(ci)
        dip_s, dip_img = timed_render(torch, lrt, dip, SSS_SPP)
        dip_counts = launch_counts(ci)
        emit("dipole_render", film=[WIDTH, HEIGHT], spp=SSS_SPP, card=smi,
             build_seconds=dip_build,
             points=int((dip.ssub.dip_area > 0).sum()),
             seconds=dip_s, paths_per_s=paths / dip_s,
             mean=float(dip_img.mean()),
             finite=bool(torch.isfinite(dip_img).all()),
             launches=split_counts(dip_counts))
        check(bool(torch.isfinite(dip_img).all())
              and float(dip_img.mean()) > 0.01,
              "dipole_render: image not finite or black")
        check(dip_counts[0] > 0, "dipole_render: no sweep launches")
        out["dipole_counts"] = dip_counts

        # ---- 12d. the gradient through the scan adjoint
        torch.cuda.reset_peak_memory_stats()
        g_s, g, g_img, g_counts = grad_run(torch, lrt, ci, treplay, scene,
                                           SSS_GRAD_SPP, walks=0,
                                           key="emitters.params")
        gpeak = torch.cuda.max_memory_allocated()
        p_s, _ = timed_render(torch, lrt, scene, SSS_GRAD_SPP)
        finite_g = bool(torch.isfinite(g).all())
        emit("sss_render_grad", film=[WIDTH, HEIGHT], spp=SSS_GRAD_SPP,
             card=smi, key="emitters.params", route="scan adjoint",
             seconds=g_s, primal_seconds=p_s, fwd_bwd_over_primal=g_s / p_s,
             fwd_bwd_paths_per_s=WIDTH * HEIGHT * SSS_GRAD_SPP / g_s,
             grad_finite=finite_g, grad_abs_max=float(g.abs().max()),
             grad_nonzero=int((g != 0).sum()),
             image_mean=float(g_img.mean()), max_memory_allocated=gpeak,
             **g_counts)
        check(finite_g and float(g.abs().max()) > 0,
              "sss_render_grad: gradient not finite or zero")
        check(g_counts["fwd_launches"] > 0,
              "sss_render_grad: no sweep launches")
        out["grad_counts"] = g_counts
    return out


def cli_phases(torch, np, lrt, ci, smi, workdir):
    """Phases codecs, cli_render, render_control, sensors_small and
    thinlens_render: the command-line renderer on bench.py's workload
    path from files with the committed PIZ sky, and what it brings with
    it -> launch counts of the in-process render of the CLI's scene, the
    render_control renders and the thinlens render."""
    from liverrenderer_tpu_torch.integrators import regen as tregen
    from liverrenderer_tpu_torch.io import exr as texr
    from liverrenderer_tpu_torch.scene.liver_proxy import (BUMP, SKY,
                                                           liver_proxy_dict,
                                                           sky_map)
    xf = _tests_module("torch_xml_files")
    ss = _tests_module("torch_sensor_scenes")
    root = os.path.dirname(os.path.abspath(__file__))
    sky = os.path.join(root, "tests", "data", "torch_sky_piz.exr")

    # ---- 13a. the PIZ decoder on the committed sky, on the card's host
    t0 = time.perf_counter()
    texr.huf_library()
    huf_build_s = time.perf_counter() - t0
    ref = sky_map(*SKY).astype(np.float16).astype(np.float32)
    zip_sky = os.path.join(workdir, "sky_zip.exr")
    texr.write_exr(zip_sky, sky_map(*SKY))
    dec = {"piz": [], "piz_plain": [], "zip": []}
    imgs = {}
    plain_loop = texr._huf_decode_plain
    for _ in range(CODEC_REPS):
        for kind, path in (("piz", sky), ("piz_plain", sky),
                           ("zip", zip_sky)):
            native = texr._huf_decode_native
            if kind == "piz_plain":     # the plain loop in the C++ one's place
                texr._huf_decode_native = plain_loop
            try:
                t0 = time.perf_counter()
                imgs[kind] = texr.read_exr_any(path)
                dec[kind].append(time.perf_counter() - t0)
            finally:
                texr._huf_decode_native = native
    exact = {k: bool(np.array_equal(v, ref)) for k, v in imgs.items()}
    emit("codecs", file="tests/data/torch_sky_piz.exr",
         bytes=os.path.getsize(sky), zip_bytes=os.path.getsize(zip_sky),
         shape=list(imgs["piz"].shape), huf_build_seconds=huf_build_s,
         decode_seconds=statistics.median(dec["piz"]),
         plain_loop_decode_seconds=statistics.median(dec["piz_plain"]),
         zip_decode_seconds=statistics.median(dec["zip"]),
         decode_seconds_reps=dec, bit_identical=exact)
    check(all(exact.values()), "codecs: a decode of the sky differs from "
          f"sky_map(1024, 512) in half: {exact}")

    # ---- 13b. the command-line renderer on the main path from files
    piz_xml, sizes = xf.write_proxy_files(
        os.path.join(workdir, "cli"), WIDTH, HEIGHT, CMP_SPP, SUBDIV,
        SEED, bump_res=BUMP[0], sky_file=sky)
    zip_xml, _ = xf.write_proxy_files(
        os.path.join(workdir, "cli_zip"), WIDTH, HEIGHT, CMP_SPP, SUBDIV,
        SEED, bump_res=BUMP[0], sky=SKY)
    base = os.path.dirname(piz_xml)
    out = os.path.join(base, "out.exr")
    cmd = [sys.executable, "-m", "liverrenderer_tpu_torch.cli", piz_xml,
           "-o", out, "--spp", str(CMP_SPP), "--seed", str(SEED)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=root,
                       timeout=CLI_TIMEOUT)
    cli_s = time.perf_counter() - t0
    check(r.returncode == 0, "cli_render: the CLI failed: "
          + r.stderr[-2000:])
    files = {n: os.path.exists(os.path.join(base, n))
             for n in ("out.exr", "out.png", "time.txt")}
    check(all(files.values()), f"cli_render: missing outputs {files}")
    times = dict(ln.split(": ", 1) for ln in open(os.path.join(
        base, "time.txt")).read().splitlines())
    last = r.stdout.strip().splitlines()[-1]
    closing = json.loads(last[last.index("{"):])
    # the same path in this process: load_file (the PIZ decoder) and
    # render (the kernels), its launches counted
    reset_counts(ci)
    scene = lrt.load_file(piz_xml)
    secs, img = timed_render(torch, lrt, scene, CMP_SPP)
    counts = launch_counts(ci)
    got = lrt.read_image(out)
    frac, mean_rel = ss.images_agree(got, img.cpu().numpy())
    # load_file of the PIZ-skied scene and its ZIP-skied twin, in turns
    loads = {"piz": [], "zip": []}
    for kind in ("piz", "zip", "zip", "piz"):
        loads[kind].append(timed_load(torch, lambda: lrt.load_file(
            piz_xml if kind == "piz" else zip_xml))[0])
    piz_over_zip = sum(loads["piz"]) / sum(loads["zip"])
    aov_out = os.path.join(base, "aov.exr")
    ra = subprocess.run(cmd[:4] + ["-o", aov_out, "--aovs",
                                   ",".join(CLI_AOVS)],
                        capture_output=True, text=True, cwd=root,
                        timeout=CLI_TIMEOUT)
    check(ra.returncode == 0, "cli_render: the CLI's --aovs failed: "
          + ra.stderr[-2000:])
    aovs = {}
    for name in CLI_AOVS:
        a = lrt.read_image(os.path.join(base, f"aov_{name}.exr"))
        aovs[name] = dict(shape=list(a.shape), finite=bool(
            np.isfinite(a).all()), mean=float(a.mean()))
    emit("cli_render", card=smi, command=" ".join(["python3"] + cmd[1:]),
         film=[WIDTH, HEIGHT], spp=CMP_SPP, bytes=sizes, outputs=files,
         subprocess_seconds=cli_s, time_txt=times,
         cli_load_seconds=closing["load_s"],
         cli_render_seconds=closing["render_s"],
         cli_paths_per_s=closing["paths_per_s"],
         in_process_render_seconds=secs,
         in_process_paths_per_s=WIDTH * HEIGHT * CMP_SPP / secs,
         cli_vs_in_process_pixel_frac=frac,
         cli_vs_in_process_mean_rel=mean_rel, launches=counts[0],
         merge_launches=counts[1], shadow_launches=counts[2],
         load_file_seconds=loads, piz_over_zip=piz_over_zip, aovs=aovs)
    check(tuple(got.shape) == (HEIGHT, WIDTH, 3)
          and bool(np.isfinite(got).all()), "cli_render: the CLI's EXR")
    check(frac >= CLI_PIX_FRAC and mean_rel <= MEAN_RTOL,
          "cli_render: the CLI's EXR differs from the in-process render")
    check(counts[0] > 0 and counts[1] > 0,
          "cli_render: the render did not launch the kernels")
    check(all(a["finite"] and a["shape"] == [HEIGHT, WIDTH, 3]
              for a in aovs.values()), f"cli_render: AOVs {aovs}")

    # ---- 13c. RenderControl on the bumped, sky-lit proxy
    bumped = lrt.load_dict(liver_proxy_dict(WIDTH, HEIGHT, CMP_SPP, SUBDIV,
                                            SEED, bump=BUMP, sky=SKY))
    runs = {"plain": [], "control": []}
    ctl_img = plain_img = None
    ctl_counts = plain_counts = None
    for kind in ("plain", "control"):
        reset_counts(ci)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        im = lrt.render(bumped, spp=CMP_SPP, seed=SEED,
                        control=lrt.RenderControl() if kind == "control"
                        else None)
        torch.cuda.synchronize()
        runs[kind].append(time.perf_counter() - t0)
        if kind == "control":
            ctl_img, ctl_counts = im, launch_counts(ci)
        else:
            plain_img, plain_counts = im, launch_counts(ci)
    frac_c, mean_rel_c = ss.images_agree(ctl_img.cpu().numpy(),
                                         plain_img.cpu().numpy())
    # the film split into tiles, so that a stop leaves pixels unrendered
    tile = tregen.TILE_PIX
    tregen.TILE_PIX = CONTROL_TILE_PIX
    try:
        ctl = lrt.RenderControl()
        prog = []

        def on_progress(f):
            prog.append(f)
            if f >= 0.5:
                ctl.cancel()
        ctl.on_progress = on_progress
        part = lrt.render(bumped, spp=CMP_SPP, seed=SEED, control=ctl)
        torch.cuda.synchronize()
    finally:
        tregen.TILE_PIX = tile
    frame = ctl.frame()
    # the tiles the render reached come first and are lit; the rest are
    # black
    flat = part.reshape(-1, 3)
    tiles = [flat[i:i + CONTROL_TILE_PIX]
             for i in range(0, WIDTH * HEIGHT, CONTROL_TILE_PIX)]
    reached = [bool(t.sum() > 0) for t in tiles]
    black = [bool((t == 0).all()) for t in tiles]
    n_reached = sum(reached)
    partial_ok = 0 < n_reached < len(tiles) \
        and all(reached[:n_reached]) and all(black[n_reached:])
    emit("render_control", card=smi, film=[WIDTH, HEIGHT], spp=CMP_SPP,
         plain_seconds=runs["plain"], control_seconds=runs["control"],
         control_over_plain=sum(runs["control"]) / sum(runs["plain"]),
         uncancelled_pixel_frac=frac_c, uncancelled_mean_rel=mean_rel_c,
         control_launches=ctl_counts[0],
         control_merge_launches=ctl_counts[1],
         plain_launches=plain_counts[0], cancel_tile_pix=CONTROL_TILE_PIX,
         cancel_progress=prog, stopped=ctl.stopped,
         frame_finite=bool(torch.isfinite(frame).all()),
         tiles_reached=n_reached, tiles=len(tiles),
         unrendered_black=partial_ok)
    check(frac_c >= PIX_FRAC_MIN and mean_rel_c <= MEAN_RTOL,
          "render_control: an uncancelled control changed the image")
    check(ctl_counts[0] > 0 and ctl_counts[1] > 0,
          "render_control: the controlled render did not launch the "
          "kernels")
    check(ctl.stopped and bool(torch.isfinite(frame).all()) and partial_ok,
          "render_control: the cancelled render did not stop with its "
          "first tiles rendered and the rest black")

    # ---- 13d. every sensor type, card against CPU
    small = {}
    for name, (d, spp) in ss.sensor_scenes(SENSOR_CORNELL_FILM).items():
        frac_s, mean_rel_s, mean, exact_s = image_vs_cpu(np, lrt, d, spp)
        small[name] = dict(pixel_frac=frac_s, mean_rel=mean_rel_s,
                           mean=mean, pixel_exact=exact_s, spp=spp)
    emit("sensors_small", card=smi, sensors=small)
    bad = [k for k, v in small.items()
           if v["pixel_frac"] < PIX_FRAC_MIN or v["mean_rel"] > MEAN_RTOL]
    check(not bad, f"sensors_small: the card disagrees with the CPU: {bad}")

    # ---- 13e. the bumped proxy through a thinlens: the fixed wavefront
    d = liver_proxy_dict(WIDTH, HEIGHT, SPP, SUBDIV, SEED, bump=BUMP,
                         sky=SKY)
    d["sensor"].update(type="thinlens", **THINLENS)
    thin = lrt.load_dict(d)
    check(not tregen.regen_applicable(thin, "primal"),
          "thinlens_render: a thinlens took the regen wavefront")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ci)
    t_thin, img_t = timed_render(torch, lrt, thin, SPP)
    thin_counts = launch_counts(ci)
    peak = torch.cuda.max_memory_allocated()
    finite_t = bool(torch.isfinite(img_t).all())
    n_pix = WIDTH * HEIGHT
    emit("thinlens_render", card=smi, film=[WIDTH, HEIGHT], spp=SPP,
         thinlens=THINLENS, seconds=t_thin,
         paths_per_s=n_pix * SPP / t_thin,
         max_memory_allocated=peak, launches=thin_counts[0],
         merge_launches=thin_counts[1], finite=finite_t,
         mean=float(img_t.mean()),
         perspective_regen_seconds=runs["plain"],
         thinlens_over_perspective=t_thin / (sum(runs["plain"]) / 2))
    check(finite_t and 0.05 < float(img_t.mean()) < 5.0,
          "thinlens_render: image not finite or its mean out of range")
    check(thin_counts[0] > 0, "thinlens_render: no sweep launched")
    return dict(counts=counts, control=ctl_counts, plain=plain_counts,
                thinlens=thin_counts)


def _liver_columns():
    """The liver medium's columns that pipeline.driver writes: lipid-water
    (3:6), the four collagen and elastin layers (12:36), blood, bile and
    the hepatocyte term (40:47)."""
    return [3, 4, 5] + list(range(12, 36)) + list(range(40, 47))


def _by_hand(torch, scene, coeffs):
    """The scene with `coeffs` written into its liver row column by column
    (independent of driver.apply_medium_coefficients)."""
    from liverrenderer_tpu_torch.scene.ir import MEDIUM_LIVER
    prm = scene.media.params.clone()
    rows = (scene.media.mtype == MEDIUM_LIVER).nonzero().flatten().tolist()
    for i in rows:
        for layer in range(4):
            for c, ch in enumerate("RGB"):
                prm[i, 12 + 3 * layer + c] = coeffs[
                    f"sigma_collagen{layer + 1}_{ch}"]
                prm[i, 24 + 3 * layer + c] = coeffs[
                    f"sigma_elastin{layer + 1}_{ch}"]
        for col, key in ((40, "sigma_blood"), (43, "sigma_bile"),
                         (3, "sigma_lipid_water")):
            prm[i, col:col + 3] = torch.as_tensor(coeffs[key])
        prm[i, 46] = coeffs["sigma_hepatocity"]
    return scene.replace(media=scene.media.replace(params=prm)), rows


def _quiet(fn, logfile):
    """fn() with its stdout (the tools' log lines and tables) in logfile."""
    import contextlib
    with open(logfile, "a") as f, contextlib.redirect_stdout(f):
        return fn()


def pipeline_phases(torch, np, lrt, ci, smi, workdir):
    """Phases pipeline_render, pipeline_small, evaluate_render,
    denoise_small, inverse_render and largesteps: the fork's liver
    pipeline on the card, with seeded synthetic spectra tables
    (tests/torch_pipeline_inputs.py) in the reference's place -> the
    launch counts of the driver's render, the evaluation's two rows and
    the inverse-rendering loop."""
    from liverrenderer_tpu_torch.pipeline import medium_models
    from liverrenderer_tpu_torch.scene.liver_proxy import BUMP, SKY
    pin = _tests_module("torch_pipeline_inputs")
    data_dir = medium_models.DATA_DIR
    medium_models.DATA_DIR = pin.write_tables(os.path.join(workdir, "data"))
    try:
        scenes = os.path.join(workdir, "scenes")
        xml = pin.write_scenes(scenes, WIDTH, HEIGHT, CMP_SPP, SUBDIV, SEED,
                               bump_res=BUMP[0], sky=SKY,
                               max_depth=PIPE_DEPTH)
        settings = pin.write_settings(
            os.path.join(workdir, "RendererSettings.yml"), WIDTH, HEIGHT,
            CMP_SPP, PIPE_DEPTH)
        logfile = os.path.join(workdir, "tools.log")
        pipe_counts, coeffs, rows = driver_phases(
            torch, np, lrt, ci, smi, workdir, xml, scenes, settings, logfile,
            pin)
        eval_counts, sss_counts = evaluate_phase(
            torch, np, lrt, ci, smi, workdir, xml, scenes, logfile, pin)
        denoise_phase(torch, np, lrt)
        inv_counts = inverse_phase(torch, lrt, ci, smi, workdir, xml, coeffs,
                                   rows)
        largesteps_phase(torch, np, lrt, smi)
    finally:
        medium_models.DATA_DIR = data_dir
    return dict(pipeline=pipe_counts, evaluate=eval_counts,
                evaluate_sss=sss_counts, inverse=inv_counts)


def driver_phases(torch, np, lrt, ci, smi, workdir, xml, scenes, settings,
                  logfile, pin):
    """pipeline_render and pipeline_small -> (launch counts of the
    driver's render, the coefficients, the liver rows)."""
    from liverrenderer_tpu_torch.pipeline import driver
    from liverrenderer_tpu_torch.pipeline.prepare_medium import \
        compute_coefficients
    ss = _tests_module("torch_sensor_scenes")
    n_pix = WIDTH * HEIGHT
    # ---- 14a. the driver at full width: settings -> coefficients ->
    # load_file -> the media's rows -> render -> EXR, PNG, time.txt
    t0 = time.perf_counter()
    coeffs = compute_coefficients(driver.load_settings(settings)["tissue"])
    coeff_s = time.perf_counter() - t0
    out = os.path.join(workdir, "driver")
    reset_counts(ci)
    t0 = time.perf_counter()
    rc = _quiet(lambda: driver.main([settings, "--scenes-dir", scenes,
                                     "--out-dir", out]), logfile)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    pipe_counts = launch_counts(ci)
    times = dict(ln.split(": ", 1) for ln in open(os.path.join(
        out, "time.txt")).read().splitlines())
    load_s = float(times["Load time"].split()[0])
    render_s = 60.0 * float(times["Render time"].split()[0])
    exr = lrt.read_image(os.path.join(out, "liver-singlemesh.exr"))
    by_hand, rows = _by_hand(torch, lrt.load_file(xml), coeffs)
    _, ref = timed_render(torch, lrt, by_hand, CMP_SPP)
    frac, mean_rel = ss.images_agree(exr, ref.cpu().numpy())
    _, plain = timed_render(torch, lrt, lrt.load_file(xml), CMP_SPP)
    plain = plain.cpu().numpy()
    changed = float(np.abs(exr - plain).mean() / np.abs(plain).mean())
    emit("pipeline_render", card=smi, film=[WIDTH, HEIGHT], spp=CMP_SPP,
         max_depth=PIPE_DEPTH, command="driver.main([settings, "
         "'--scenes-dir', D, '--out-dir', O])", returncode=rc,
         coefficients_seconds=coeff_s, main_seconds=main_s,
         time_txt=times, load_seconds=load_s, render_seconds=render_s,
         paths_per_s=n_pix * CMP_SPP / render_s, liver_rows=rows,
         coefficients={k: coeffs[k] for k in (
             "sigma_collagen1_R", "sigma_elastin1_G", "sigma_blood",
             "sigma_bile", "sigma_lipid_water", "sigma_hepatocity")},
         launches=pipe_counts[0], merge_launches=pipe_counts[1],
         vs_by_hand_pixel_frac=frac, vs_by_hand_mean_rel=mean_rel,
         vs_unsubstituted_mean_abs_rel=changed, mean=float(exr.mean()))
    check(rc == 0 and exr.shape == (HEIGHT, WIDTH, 3)
          and bool(np.isfinite(exr).all()), "pipeline_render: the EXR")
    check(rows, "pipeline_render: the scene has no liver medium")
    check(frac >= CLI_PIX_FRAC and mean_rel <= MEAN_RTOL,
          "pipeline_render: the driver's EXR differs from the render with "
          "the coefficients written by hand")
    check(changed > 1e-3, "pipeline_render: the coefficients did not "
          f"reach the medium (mean change {changed})")
    check(pipe_counts[0] > 0 and pipe_counts[1] > 0,
          "pipeline_render: the render did not launch the kernels")

    # ---- 14b. the driver at test size (the proxy at subdiv 2 with the
    # small height map and sky of xml_small), card against CPU
    w_s, h_s, spp_s = PIPE_SMALL
    scenes_s = os.path.join(workdir, "scenes_small")
    pin.write_scenes(scenes_s, w_s, h_s, spp_s, 2, SEED,
                     bump_res=BUMP_SMALL[0], sky=SKY_SMALL,
                     max_depth=PIPE_DEPTH)
    settings_s = pin.write_settings(os.path.join(workdir, "small.yml"), w_s,
                                    h_s, spp_s, PIPE_DEPTH)
    small = {}
    for dev, extra in (("card", []), ("cpu", ["--cpu"])):
        o = os.path.join(workdir, f"small_{dev}")
        _quiet(lambda: driver.main([settings_s, "--scenes-dir", scenes_s,
                                    "--out-dir", o, *extra]), logfile)
        small[dev] = lrt.read_image(os.path.join(o, "liver-singlemesh.exr"))
    frac_s, mean_rel_s = ss.images_agree(small["card"], small["cpu"])
    emit("pipeline_small", film=[w_s, h_s], spp=spp_s, pixel_frac=frac_s,
         mean_rel=mean_rel_s, mean=float(small["card"].mean()))
    check(frac_s >= PIX_FRAC_MIN and mean_rel_s <= MEAN_RTOL,
          "pipeline_small: the card's image disagrees with the CPU's")
    return pipe_counts, coeffs, rows


def evaluate_phase(torch, np, lrt, ci, smi, workdir, xml, scenes, logfile,
                   pin):
    """evaluate_render -> launch counts of the Liver-SingleMesh and the
    SSS rows."""
    from liverrenderer_tpu_torch.io.png import write_png
    from liverrenderer_tpu_torch.pipeline import evaluate
    from liverrenderer_tpu_torch.ssub import vae as tvae
    from liverrenderer_tpu_torch.tonemap import tonemap
    sss_in = _tests_module("torch_sss_inputs")
    # ---- 14c. evaluate at its defaults against a golden PNG
    golden = os.path.join(scenes, pin.LIVER_GOLDEN)
    os.makedirs(os.path.dirname(golden), exist_ok=True)
    g_scene = lrt.load_file(xml, res_width=GOLDEN_SCALE * WIDTH,
                            res_height=GOLDEN_SCALE * HEIGHT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = lrt.render(g_scene, spp=GOLDEN_SPP, seed=GOLDEN_SEED)
    g = g.cpu().numpy()
    golden_s = time.perf_counter() - t0
    del g_scene
    write_png(golden, (tonemap(g) * 255 + 0.5).astype(np.uint8))
    ev_out = os.path.join(workdir, "evaluate")
    reset_counts(ci)
    t0 = time.perf_counter()
    _quiet(lambda: evaluate.main(["--scenes-dir", scenes, "--scenes",
                                  "Liver-SingleMesh", "--out-dir", ev_out]),
           logfile)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_counts = launch_counts(ci)
    with open(os.path.join(ev_out, "results.json")) as f:
        row = json.load(f)["Liver-SingleMesh"]
    # the learned-SSS row with the soap substitute and a synthetic VAE
    w_e, h_e, spp_e = EVAL_SSS
    model = sss_in.write_model(os.path.join(workdir, "vae"), seed=SEED)
    with sss_in.substituted(*model, tvae):
        pin.write_sss_scene(scenes, w_e, h_e, spp_e, GOLDEN_SCALE)
        reset_counts(ci)
        t0 = time.perf_counter()
        sss_row = _quiet(lambda: evaluate.evaluate(
            scenes, ev_out, GOLDEN_SCALE, spp_e, ["SphereLiverPoint-SSS"],
            merge=True), logfile)["SphereLiverPoint-SSS"]
        torch.cuda.synchronize()
        sss_s = time.perf_counter() - t0
        sss_counts = launch_counts(ci)

    def finite(x):
        vals = x.values() if isinstance(x, dict) else \
            x if isinstance(x, list) else [x]
        return all(finite(v) for v in vals) if isinstance(
            x, (dict, list)) else isinstance(x, (bool, str)) or \
            bool(np.isfinite(x))
    emit("evaluate_render", card=smi, film=[WIDTH, HEIGHT], spp=CMP_SPP,
         golden=[GOLDEN_SCALE * WIDTH, GOLDEN_SCALE * HEIGHT],
         golden_spp=GOLDEN_SPP, golden_seconds=golden_s,
         evaluate_seconds=eval_s, row=row, launches=eval_counts[0],
         merge_launches=eval_counts[1], sss_film=[w_e, h_e], sss_spp=spp_e,
         sss_seconds=sss_s, sss_row=sss_row, sss_launches=sss_counts[0],
         sss_merge_launches=sss_counts[1])
    check("error" not in row and "error" not in sss_row,
          f"evaluate_render: an error row: {row} {sss_row}")
    check(finite(row) and finite(sss_row),
          "evaluate_render: a value is not finite")
    check(row["denoise"]["denoised_rmse"] < row["denoise"]["noisy_rmse"],
          "evaluate_render: the denoised image is no closer to the golden")
    check(sss_row.get("silhouette_iou", 0) > 0.5,
          "evaluate_render: the SSS row's silhouette")
    check(eval_counts[0] > 0 and sss_counts[0] > 0,
          "evaluate_render: no sweep launched")
    return eval_counts, sss_counts


def denoise_phase(torch, np, lrt):
    """denoise_small."""
    from liverrenderer_tpu_torch import denoise as tdn
    from liverrenderer_tpu_torch.scene.liver_proxy import liver_proxy_dict
    ss = _tests_module("torch_sensor_scenes")
    w_s, h_s, spp_s = PIPE_SMALL
    # ---- 14d. the denoiser, card against CPU
    rng = np.random.default_rng(SEED)
    bufs = [rng.random((h_s, w_s, 3)).astype(np.float32) for _ in range(3)]
    bufs.append(0.05 * rng.random((h_s, w_s)).astype(np.float32))
    at_cpu = tdn.atrous_denoise(*[torch.as_tensor(b) for b in bufs])
    at_card = tdn.atrous_denoise(*[torch.as_tensor(b).cuda() for b in bufs])
    at_err = float((at_card.cpu() - at_cpu).abs().max())
    at_ok = bool(torch.allclose(at_card.cpu(), at_cpu, rtol=DENOISE_RTOL,
                                atol=DENOISE_ATOL))
    d_small = liver_proxy_dict(w_s, h_s, spp_s, 2, SEED)
    dn = {dev: tdn.denoise_render(lrt.load_dict(d_small, device=dev),
                                  spp=spp_s, seed=SEED).cpu().numpy()
          for dev in ("cuda", "cpu")}
    frac_d, mean_rel_d = ss.images_agree(dn["cuda"], dn["cpu"])
    emit("denoise_small", film=[w_s, h_s], spp=spp_s,
         atrous_max_abs_err=at_err, atrous_equal_within_tol=at_ok,
         denoise_render_pixel_frac=frac_d, denoise_render_mean_rel=mean_rel_d)
    check(at_ok, f"denoise_small: atrous_denoise card vs CPU {at_err}")
    check(frac_d >= PIX_FRAC_MIN and mean_rel_d <= MEAN_RTOL,
          "denoise_small: denoise_render card vs CPU")


def inverse_phase(torch, lrt, ci, smi, workdir, xml, coeffs, rows):
    """inverse_render -> the loop's launch counts."""
    from liverrenderer_tpu_torch.checkpoint import \
        OptimizationCheckpointer as Checkpointer
    from liverrenderer_tpu_torch.pipeline import driver
    n_pix = WIDTH * HEIGHT
    # ---- 14e. inverse rendering: Adam on media.params with checkpoints
    scene = driver.apply_medium_coefficients(lrt.load_file(xml), coeffs)
    cols = torch.tensor(_liver_columns(), device=scene.device)
    mask = torch.zeros_like(scene.media.params)
    mask[rows[0], cols] = 1.0
    reset_counts(ci)
    target = lrt.render(scene, spp=INV_TARGET_SPP, seed=SEED + 7)

    def loss_fn(img):
        return torch.mean((img - target) ** 2)

    def step(param, opt, k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, _ = lrt.render_grad(
            lrt.apply_params(scene, {"media.params": param.detach()}),
            {"media.params": param.detach()}, loss_fn, spp=GRAD_SPP,
            seed=INV_SEED + k)
        g = grads["media.params"] * mask
        opt.zero_grad()
        param.grad = g
        opt.step()
        with torch.no_grad():
            param.clamp_(min=0.0)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, float(loss), g

    ck_dir = os.path.join(workdir, "checkpoints")
    p0 = scene.media.params * (1.0 + mask)        # the liver columns x2
    param = p0.clone().requires_grad_(True)
    opt = torch.optim.Adam([param], lr=INV_LR)
    ck = Checkpointer(ck_dir, keep=INV_KEEP)
    torch.cuda.reset_peak_memory_stats()
    secs, losses, gnorms, saved = [], [], [], {}
    g_finite = True
    for k in range(1, INV_STEPS + 1):
        s_k, l_k, g = step(param, opt, k)
        secs.append(s_k)
        losses.append(l_k)
        gnorms.append(float(g.norm()))
        g_finite = g_finite and bool(torch.isfinite(g).all())
        ck.save(k, {"media.params": param.detach()}, opt.state_dict())
        saved[k] = param.detach().clone()
    peak = torch.cuda.max_memory_allocated()
    on_disk = ck.all_steps()
    ck.close()
    # a fresh run resumes from step INV_RESUME and redoes the rest
    ck2 = Checkpointer(ck_dir, keep=INV_KEEP)
    p_like = {"media.params": torch.zeros_like(p0)}
    fresh = torch.optim.Adam([torch.zeros_like(p0, requires_grad=True)],
                             lr=INV_LR)
    r_step, r_params, r_state = ck2.restore(p_like, fresh.state_dict(),
                                            step=INV_RESUME)
    param2 = r_params["media.params"].clone().requires_grad_(True)
    opt2 = torch.optim.Adam([param2], lr=INV_LR)
    opt2.load_state_dict(r_state)
    restored_equal = bool(torch.equal(param2.detach(), saved[INV_RESUME]))
    resumed = []
    for k in range(INV_RESUME + 1, INV_STEPS + 1):
        resumed.append(step(param2, opt2, k)[0])
    inv_counts = launch_counts(ci)
    diff = float((param2.detach() - param.detach()).abs().max())
    scale = float(param.detach().abs().max())
    emit("inverse_render", card=smi, film=[WIDTH, HEIGHT],
         target_spp=INV_TARGET_SPP, spp=GRAD_SPP, steps=INV_STEPS, lr=INV_LR,
         seconds_per_step=secs, resumed_seconds_per_step=resumed,
         fwd_bwd_paths_per_s=[n_pix * GRAD_SPP / x for x in secs],
         loss=losses, grad_norm=gnorms, max_memory_allocated=peak,
         steps_on_disk=on_disk, restored_step=r_step,
         restored_equal=restored_equal, resumed_max_abs_diff=diff,
         param_abs_max=scale, launches=inv_counts[0],
         merge_launches=inv_counts[1])
    check(g_finite and min(gnorms) > 0,
          "inverse_render: a gradient is not finite or zero")
    check(on_disk == list(range(INV_STEPS - INV_KEEP + 1, INV_STEPS + 1)),
          f"inverse_render: steps on disk {on_disk}")
    check(r_step == INV_RESUME and restored_equal,
          "inverse_render: the restored parameters differ from the saved")
    check(diff <= INV_RESUME_RTOL * scale,
          f"inverse_render: resumed parameters differ by {diff}")
    return inv_counts


def largesteps_phase(torch, np, lrt, smi):
    """largesteps."""
    from liverrenderer_tpu_torch.scene.liver_proxy import liver_mesh
    # ---- 14f. LargeSteps: the CG solve and its gradient, card vs CPU
    ls_out = {}
    for subdiv in LARGESTEPS_SUBDIVS:
        v, f, _, _ = liver_mesh(subdiv, SEED)
        w = torch.as_tensor(np.random.default_rng(subdiv).normal(
            size=v.shape).astype(np.float32))
        res = {}
        for dev in ("cuda", "cpu"):
            ls = lrt.LargeSteps(len(v), f, device=dev)
            u = ls.to_differential(torch.as_tensor(v, device=dev) * 1.1)
            u.requires_grad_(True)
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = ls.from_differential(u)
            if dev == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            (x * w.to(dev)).sum().backward()
            if dev == "cuda":
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            res[dev] = dict(x=x.detach().cpu(), g=u.grad.cpu(),
                            ms=(t1 - t0) * 1e3, backward_ms=(t2 - t1) * 1e3,
                            iterations=ls.iterations,
                            backward_iterations=ls.backward_iterations)
        errs = {k: float((res["cuda"][k] - res["cpu"][k]).abs().max()
                         / res["cpu"][k].abs().max()) for k in ("x", "g")}
        ls_out[f"subdiv_{subdiv}"] = dict(
            vertices=len(v), edges=int(ls.edges.shape[0]), rel_err=errs,
            **{f"{dev}_{k}": res[dev][k] for dev in res
               for k in ("ms", "backward_ms", "iterations",
                         "backward_iterations")})
    emit("largesteps", card=smi, **ls_out)
    bad = [k for k, v in ls_out.items()
           if max(v["rel_err"].values()) > LARGESTEPS_RTOL]
    check(not bad, f"largesteps: the card disagrees with the CPU: {bad}")



def spectral_phases(torch, np, lrt, ci, treplay, smi):
    """Phases spectral_small, spectral_render, spectral_render_grad and
    specfilm_render -> the launch counts the kernels line reports."""
    from torch.profiler import ProfilerActivity, profile
    from liverrenderer_tpu_torch.core import spectrum as spec
    from liverrenderer_tpu_torch.scene.cornell import (cornell_box,
                                                       fog_cornell_box)
    from liverrenderer_tpu_torch.scene.liver_proxy import (BUMP, SKY,
                                                           liver_proxy_dict)
    SP = "spectral"

    # ---- 15a. at test size, card against CPU
    w, h, spp = SPEC_SMALL
    small = liver_proxy_dict(w, h, spp, 2, SEED, bump=BUMP_SMALL,
                             sky=SKY_SMALL)
    frac, mean_rel, mean, exact = image_vs_cpu(np, lrt, small, spp, SP)
    cos, norm_rel, gnorm, gfin = grad_vs_cpu(lrt, small, spp, variant=SP)
    res_f, spp_f, depth_f = SPEC_FOG_SMALL
    fog = fog_cornell_box(res_f, max_depth=depth_f)
    ffrac, fmean_rel, fmean, fexact = image_vs_cpu(np, lrt, fog, spp_f, SP)
    cb_small = _cornell_dict(cornell_box, res_f, "box", 4)
    bins = [lrt.render_specfilm(lrt.load_dict(cb_small, device=dev,
                                              variant=SP),
                                n_bins=SPECFILM_BINS, spp=spp_f,
                                seed=SEED).cpu().numpy()
            for dev in ("cpu", "cuda")]
    bclose = np.abs(bins[1] - bins[0]) <= PIX_ATOL + PIX_RTOL \
        * np.abs(bins[0])
    bfrac = float(bclose.mean())
    bmean_rel = float(abs(bins[1].mean() - bins[0].mean())
                      / abs(bins[0].mean()))
    emit("spectral_small", film=[w, h], spp=spp, bump=list(BUMP_SMALL),
         sky=list(SKY_SMALL), pixel_frac=frac, pixel_exact=exact,
         mean_rel=mean_rel, mean=mean, grad_cosine=cos,
         grad_norm_rel=norm_rel, grad_norm=gnorm, fog_film=[res_f, res_f],
         fog_spp=spp_f, fog_pixel_frac=ffrac, fog_pixel_exact=fexact,
         fog_mean_rel=fmean_rel, fog_mean=fmean,
         specfilm_bins=SPECFILM_BINS, specfilm_frac=bfrac,
         specfilm_mean_rel=bmean_rel)
    check(frac >= PIX_FRAC_MIN and mean_rel <= MEAN_RTOL,
          "spectral_small: the card's proxy disagrees with the CPU's")
    check(gfin and gnorm > 0, "spectral_small: gradient not finite or zero")
    check(cos >= GRAD_COS_MIN and norm_rel <= GRAD_NORM_RTOL,
          "spectral_small: the card's gradient disagrees with the CPU's")
    check(ffrac >= PIX_FRAC_MIN and fmean_rel <= MEAN_RTOL,
          "spectral_small: the card's fog box disagrees with the CPU's")
    check(bfrac >= PIX_FRAC_MIN and bmean_rel <= MEAN_RTOL,
          "spectral_small: the card's specfilm disagrees with the CPU's")

    # ---- 15b. the main path in the spectral variant at full size, in
    # turns with RGB
    d = liver_proxy_dict(WIDTH, HEIGHT, CMP_SPP, SUBDIV, SEED, bump=BUMP,
                         sky=SKY)
    sp, rgb = lrt.load_dict(d, variant=SP), lrt.load_dict(d)
    check(sp.spectral and sp.device.type == "cuda" and not rgb.spectral,
          "spectral proxy: not spectral, or not on the card")
    for sc in (sp, rgb):
        lrt.render(sc, spp=1, seed=SEED + 1)                   # warm-up
    rgb_s, img_rgb = timed_render(torch, lrt, rgb, CMP_SPP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ci)
    secs, img = timed_render(torch, lrt, sp, CMP_SPP)
    counts = launch_counts(ci)
    peak = torch.cuda.max_memory_allocated()
    # one timed render each (a second pair took ~27 s of the script's
    # time limit)
    sp_s, rgb_s = [secs], [rgb_s]
    traces = {}
    for name, sc in (("spectral", sp), ("rgb", rgb)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            reset_counts(ci)
            secs_tr, _ = timed_render(torch, lrt, sc, BUMP_TRACE_SPP)
        traces[name] = primal_trace(prof, secs_tr, ci.LAUNCHES)
    finite = bool(torch.isfinite(img).all())
    lum_sp = float(spec.luminance(img).mean())
    lum_rgb = float(spec.luminance(img_rgb).mean())
    paths = WIDTH * HEIGHT * CMP_SPP
    t_sp, t_rgb = sp_s[0], rgb_s[0]
    emit("spectral_render", film=[WIDTH, HEIGHT], spp=CMP_SPP,
         max_depth=sp.max_depth, tris=sp.n_tris, n_spec=spec.N_SPEC,
         card=smi, seconds=round(secs, 3), paths_per_s=paths / secs,
         spectral_seconds_reps=sp_s, rgb_seconds_reps=rgb_s,
         spectral_paths_per_s=paths / t_sp, rgb_paths_per_s=paths / t_rgb,
         spectral_over_rgb=t_sp / t_rgb, finite=finite,
         shape=list(img.shape), mean=float(img.mean()),
         luminance=lum_sp, rgb_luminance=lum_rgb,
         luminance_ratio=lum_sp / lum_rgb, iterations=counts[0],
         launches=counts[0], merge_launches=counts[1],
         shadow_launches=counts[2], max_memory_allocated=peak,
         trace_spp=BUMP_TRACE_SPP, trace=traces,
         launches_per_iteration_added=traces["spectral"][
             "launches_per_iteration"] - traces["rgb"][
             "launches_per_iteration"])
    check(tuple(img.shape) == (HEIGHT, WIDTH, 3), "spectral image shape")
    check(finite, "spectral image has non-finite values")
    check(abs(lum_sp / lum_rgb - 1.0) <= SPEC_LUM_RTOL,
          f"spectral luminance {lum_sp} vs RGB {lum_rgb}: beyond "
          f"{SPEC_LUM_RTOL:.0%}")
    check(counts[0] > 0 and counts[1] > 0,
          "the spectral render did not launch the sweep and merge kernels")
    check(counts[2] == 0, "the spectral liver render made shadow queries")

    # ---- 15c. its gradient (single walk, packet-space pool)
    runs = [grad_run(torch, lrt, ci, treplay, sp, GRAD_SPP)]   # warm-up
    torch.cuda.reset_peak_memory_stats()
    runs.append(grad_run(torch, lrt, ci, treplay, sp, GRAD_SPP))
    gpeak = torch.cuda.max_memory_allocated()
    grad_counts = runs[1][3]
    check(runs[0][3] == grad_counts,
          "spectral render_grad: launch counts differ between reps")
    g = runs[1][1]
    t_primal = timed_render(torch, lrt, sp, GRAD_SPP)[0]
    t_grad = runs[1][0]
    gpaths = WIDTH * HEIGHT * GRAD_SPP
    finite_g = bool(torch.isfinite(g).all())
    emit("spectral_render_grad", film=[WIDTH, HEIGHT], spp=GRAD_SPP,
         max_depth=sp.max_depth, card=smi, seconds=t_grad,
         seconds_reps=[r[0] for r in runs],
         fwd_bwd_paths_per_s=gpaths / t_grad, primal_seconds=t_primal,
         primal_paths_per_s=gpaths / t_primal,
         fwd_bwd_over_primal=t_grad / t_primal, grad_finite=finite_g,
         grad_abs_max=float(g.abs().max()),
         grad_sigma_t=[float(x) for x in g[0, 0:3]],
         image_mean=float(runs[1][2].mean()), max_memory_allocated=gpeak,
         **grad_counts)
    check(finite_g and float(g.abs().max()) > 0,
          "spectral render_grad: gradient not finite or zero")
    for k in ("fwd_launches", "fwd_merge_launches", "replay_launches",
              "replay_merge_launches"):
        check(grad_counts[k] > 0, f"spectral render_grad: {k} is 0")
    del sp, rgb

    # ---- 15d. the binned spectral film of BASELINE's Cornell box
    box = lrt.load_dict(_cornell_dict(cornell_box, CORNELL_RES, "gaussian"),
                        variant=SP)
    from liverrenderer_tpu_torch.integrators.spectral import \
        MAX_SPEC_WAVEFRONT
    n_pix = CORNELL_RES * CORNELL_RES
    spp_pass = max(1, min(CORNELL_SPP, MAX_SPEC_WAVEFRONT // n_pix))
    lrt.render_specfilm(box, n_bins=SPECFILM_BINS, spp=spp_pass,
                        seed=SEED + 1)                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ci)
    t0 = time.perf_counter()
    film = lrt.render_specfilm(box, n_bins=SPECFILM_BINS, spp=CORNELL_SPP,
                               seed=SEED)
    torch.cuda.synchronize()
    film_s = time.perf_counter() - t0
    film_counts = launch_counts(ci)
    film_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ci)
    box_s, box_img = timed_render(torch, lrt, box, CORNELL_SPP)
    box_counts = launch_counts(ci)
    box_peak = torch.cuda.max_memory_allocated()
    centers = spec.SPEC_MIN + (np.arange(SPECFILM_BINS) + 0.5) * (
        spec.SPEC_MAX - spec.SPEC_MIN) / SPECFILM_BINS
    ybar = torch.tensor(spec.cie1931_xyz_bar(centers)[:, 1],
                        dtype=torch.float32, device="cuda")
    Y = float(((film * ybar).sum(-1) / spec._CIE_Y_INT).mean())
    lum = float(spec.luminance(box_img).mean())
    cpaths = n_pix * CORNELL_SPP
    emit("specfilm_render", film=[CORNELL_RES, CORNELL_RES],
         spp=CORNELL_SPP, max_depth=box.max_depth, bins=SPECFILM_BINS,
         card=smi, seconds=film_s, paths_per_s=cpaths / film_s,
         passes=CORNELL_SPP // spp_pass, lanes_per_pass=n_pix * spp_pass,
         shape=list(film.shape), finite=bool(torch.isfinite(film).all()),
         min=float(film.min()), energy_Y=Y, render_luminance=lum,
         energy_ratio=Y / lum, max_memory_allocated=film_peak,
         **split_counts(film_counts), render_seconds=box_s,
         render_paths_per_s=cpaths / box_s,
         render_max_memory_allocated=box_peak,
         render_launches=split_counts(box_counts))
    check(tuple(film.shape) == (CORNELL_RES, CORNELL_RES, SPECFILM_BINS),
          "specfilm shape")
    check(bool(torch.isfinite(film).all()) and float(film.min()) >= 0,
          "specfilm has negative or non-finite bins")
    check(abs(Y / lum - 1.0) <= SPECFILM_RTOL,
          f"specfilm energy {Y} vs the render's luminance {lum}: beyond "
          f"{SPECFILM_RTOL:.0%}")
    check(film_counts[0] > 0 and box_counts[0] > 0,
          "the specfilm or the spectral Cornell render launched no sweep")
    return dict(counts=counts, grad_counts=grad_counts, film=film_counts,
                box=box_counts)


def stokes_dop(S, mask, linear=False):
    """Degree of polarization of the Stokes vector averaged over the
    masked pixels and the channels (S: (h, w, 4, C)); linear: of S1 and
    S2 only, the per-channel means first (test_polarization.py's)."""
    s = S[mask].mean(0)                               # (4, C)
    if linear:
        return float((s[1].mean() ** 2 + s[2].mean() ** 2) ** 0.5
                     / max(float(s[0].mean()), 1e-9))
    v = s.mean(-1)
    return float((v[1:] ** 2).sum() ** 0.5 / max(float(v[0]), 1e-9))


def m10_phases(torch, np, lrt, ci, smi):
    """Phases m10_small, ptracer_render, stokes_render and volprim_render
    -> the launch counts the kernels line reports."""
    from torch.profiler import ProfilerActivity, profile
    from liverrenderer_tpu_torch.scene.cornell import cornell_box
    from liverrenderer_tpu_torch.scene.ir import BSDF_CONDUCTOR
    from liverrenderer_tpu_torch.scene.transform import Transform
    ms = _tests_module("torch_m10_scenes")

    # ---- 16a. at test size, card against CPU
    res_s, spp_s = M10_SMALL
    small = {}
    d = _cornell_dict(cornell_box, res_s, "box")
    img = [lrt.render_ptracer(lrt.load_dict(d, device=dev), spp=spp_s,
                              seed=SEED).cpu().numpy()
           for dev in ("cpu", "cuda")]
    small["ptracer_cornell"] = arrays_agree(np, img[1], img[0])
    stack = ms.stack_dict([{"type": "polarizer", "theta": 90.0},
                           {"type": "retarder", "theta": 45.0},
                           {"type": "polarizer", "theta": POLARIZER_THETA}])
    for name, sd in (("stack", stack), ("gold_mirror",
                                        ms.gold_mirror_dict())):
        for var in (None, "spectral"):
            S = [lrt.render_stokes(lrt.load_dict(sd, device=dev,
                                                 variant=var),
                                   spp=spp_s, seed=SEED).cpu().numpy()
                 for dev in ("cpu", "cuda")]
            small[f"stokes_{name}_{var or 'rgb'}"] = arrays_agree(
                np, S[1], S[0])
    splats = ms.three_splats(srgb=True, degree=2)
    frac, mean_rel, mean, _ = image_vs_cpu(np, lrt, splats, spp_s)
    small["volprim_3_splats"] = (frac, mean_rel, mean)
    cos, norm_rel, gnorm, gfin = grad_vs_cpu(lrt, splats, spp_s, VP_KEYS)
    emit("m10_small", film=[res_s, res_s], spp=spp_s,
         **{k: dict(pixel_frac=v[0], mean_rel=v[1], mean=v[2])
            for k, v in small.items()},
         volprim_grad_cosine=cos, volprim_grad_norm_rel=norm_rel,
         volprim_grad_norm=gnorm)
    for k, v in small.items():
        check(v[0] >= PIX_FRAC_MIN and v[1] <= MEAN_RTOL,
              f"m10_small ({k}): the card disagrees with the CPU: {v}")
    check(gfin and gnorm > 0, "m10_small: volprims gradient not finite or 0")
    check(cos >= GRAD_COS_MIN and norm_rel <= GRAD_NORM_RTOL,
          "m10_small: the card's volprims gradient disagrees with the CPU's")

    # ---- 16b. the light tracer on BASELINE's Cornell box, in turns with
    # the path tracer on the same scene with its emitters hidden
    d = _cornell_dict(cornell_box, CORNELL_RES, "gaussian")
    box = lrt.load_dict(d)
    hidden = box.replace(hide_emitters=True)
    n_paths = CORNELL_RES * CORNELL_RES * max(1, CORNELL_SPP // 4)
    lrt.render_ptracer(box, spp=4, seed=SEED + 1)              # warm-up
    lrt.render(hidden, spp=1, seed=SEED + 1)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ci)
    pt_s, pt = timed_call(torch, lambda: lrt.render_ptracer(
        box, spp=CORNELL_SPP, seed=SEED))
    pt_counts = launch_counts(ci)
    pt_peak = torch.cuda.max_memory_allocated()
    path_s, fw = timed_render(torch, lrt, hidden, CORNELL_SPP)
    path_s = [path_s, timed_render(torch, lrt, hidden, CORNELL_SPP)[0]]
    pt_s = [pt_s, timed_call(torch, lambda: lrt.render_ptracer(
        box, spp=CORNELL_SPP, seed=SEED))[0]]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        secs_tr, _ = timed_call(torch, lambda: lrt.render_ptracer(
            box, spp=CORNELL_SPP, seed=SEED))
    pt_trace = primal_trace(prof, secs_tr, box.max_depth)
    rel = abs(float(pt.mean()) - float(fw.mean())) / float(fw.mean())
    emit("ptracer_render", film=[CORNELL_RES, CORNELL_RES], spp=CORNELL_SPP,
         max_depth=box.max_depth, light_paths=n_paths, card=smi,
         seconds=pt_s[0], seconds_reps=pt_s,
         light_paths_per_s=n_paths / pt_s[0],
         path_seconds_reps=path_s, ptracer_over_path=pt_s[0] / path_s[0],
         finite=bool(torch.isfinite(pt).all()), mean=float(pt.mean()),
         path_mean=float(fw.mean()), mean_rel_to_path=rel,
         max_memory_allocated=pt_peak, **split_counts(pt_counts),
         trace=pt_trace)
    check(tuple(pt.shape) == (CORNELL_RES, CORNELL_RES, 3),
          "ptracer image shape")
    check(bool(torch.isfinite(pt).all()), "ptracer image not finite")
    check(rel <= M10_PATH_RTOL, f"ptracer mean {float(pt.mean())} vs path "
          f"{float(fw.mean())}: beyond {M10_PATH_RTOL:.0%}")
    check(pt_counts[0] >= 2 * box.max_depth,
          "the ptracer render did not launch the sweep kernel")

    # ---- 16c. polarized transport: the Cornell box with a gold block
    d = _cornell_dict(cornell_box, CORNELL_RES, "gaussian")
    d["large-box"]["bsdf"] = {"type": "conductor", "material": "Au"}
    d_st = dict(d, integrator={"type": "stokes", "max_depth": CORNELL_DEPTH})
    st, pth = lrt.load_dict(d_st), lrt.load_dict(d)
    sp = lrt.load_dict(d_st, variant="spectral")
    check(sp.spectral and st.integrator == "stokes", "stokes scenes")
    for sc in (st, sp):
        lrt.render_stokes(sc, spp=1, seed=SEED + 1)            # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ci)
    st_s, S = timed_call(torch, lambda: lrt.render_stokes(
        st, spp=CORNELL_SPP, seed=SEED))
    st_counts = launch_counts(ci)
    st_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ci)
    sp_s, Ssp = timed_call(torch, lambda: lrt.render_stokes(
        sp, spp=CORNELL_SPP, seed=SEED))
    sp_counts = launch_counts(ci)
    sp_peak = torch.cuda.max_memory_allocated()
    sp_s = [sp_s, timed_call(torch, lambda: lrt.render_stokes(
        sp, spp=CORNELL_SPP, seed=SEED))[0]]
    st_s = [st_s, timed_call(torch, lambda: lrt.render_stokes(
        st, spp=CORNELL_SPP, seed=SEED))[0]]
    path_s, img = timed_render(torch, lrt, pth, CORNELL_SPP)
    s0_rel = abs(float(S[..., 0, :].mean()) - float(img.mean())) \
        / float(img.mean())
    # the gold block's pixels: the primary hits on the conductor's shape
    bt = pth.bsdfs.btype[pth.shape_bsdf]
    gold = int(torch.nonzero(bt == BSDF_CONDUCTOR)[0, 0])
    mask = lrt.render_aovs(pth, ("shape_index",))["shape_index"] == gold
    dop_gold = stokes_dop(S, mask)
    # a polarizer at POLARIZER_THETA filling the view in front of the
    # camera (at z = 3.5, the camera at 3.9)
    d_pol = dict(d_st, polarizer={
        "type": "rectangle",
        "to_world": Transform().translate([0, 0, 3.5]).scale(0.5)
        .matrix.copy(),
        "bsdf": {"type": "polarizer", "theta": POLARIZER_THETA}})
    pol = lrt.load_dict(d_pol)
    reset_counts(ci)
    pol_s, Sp = timed_call(torch, lambda: lrt.render_stokes(
        pol, spp=CORNELL_SPP, seed=SEED))
    pol_counts = launch_counts(ci)
    dop_pol = stokes_dop(Sp, mask)
    dop_rgb, dop_sp = stokes_dop(S, mask, True), stokes_dop(Ssp, mask, True)
    s0_sp_rel = abs(float(Ssp[mask][:, 0].mean())
                    - float(S[mask][:, 0].mean())) \
        / float(S[mask][:, 0].mean())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        reset_counts(ci)
        secs_tr, _ = timed_call(torch, lambda: lrt.render_stokes(
            st, spp=CORNELL_SPP, seed=SEED))
    st_trace = primal_trace(prof, secs_tr, ci.LAUNCHES - ci.SHADOW_LAUNCHES)
    lanes = CORNELL_RES * CORNELL_RES * CORNELL_SPP
    t_sp, t_rgb = sum(sp_s) / 2, sum(st_s) / 2
    emit("stokes_render", film=[CORNELL_RES, CORNELL_RES], spp=CORNELL_SPP,
         max_depth=CORNELL_DEPTH, card=smi, seconds=st_s[0],
         seconds_reps=st_s, paths_per_s=lanes / st_s[0],
         path_seconds=path_s, stokes_over_path=st_s[0] / path_s,
         shape=list(S.shape), finite=bool(torch.isfinite(S).all()),
         s0_mean=float(S[..., 0, :].mean()), path_mean=float(img.mean()),
         s0_rel_to_path=s0_rel, gold_pixels=int(mask.sum()),
         dop_gold=dop_gold, polarizer_theta=POLARIZER_THETA,
         polarizer_seconds=pol_s, dop_gold_behind_polarizer=dop_pol,
         spectral_seconds_reps=sp_s, spectral_over_rgb=t_sp / t_rgb,
         dolp_gold_rgb=dop_rgb, dolp_gold_spectral=dop_sp,
         spectral_s0_rel=s0_sp_rel, max_memory_allocated=st_peak,
         spectral_max_memory_allocated=sp_peak,
         launches=split_counts(st_counts),
         polarizer_launches=split_counts(pol_counts),
         spectral_launches=split_counts(sp_counts),
         trace=st_trace)
    check(tuple(S.shape) == (CORNELL_RES, CORNELL_RES, 4, 3),
          "stokes image shape")
    for name, x in (("rgb", S), ("polarizer", Sp), ("spectral", Ssp)):
        check(bool(torch.isfinite(x).all()), f"stokes {name}: not finite")
    check(s0_rel <= M10_PATH_RTOL, f"stokes S0 mean vs path: {s0_rel}")
    check(int(mask.sum()) > 0, "no pixel sees the gold block")
    check(0.0 < dop_pol <= 1.0 + 1e-6,
          f"DOP behind the polarizer {dop_pol} not in (0, 1]")
    check(abs(dop_sp - dop_rgb) < DOP_ATOL,
          f"spectral DOP {dop_sp} vs RGB {dop_rgb}")
    check(s0_sp_rel < SPEC_S0_RTOL, f"spectral S0 vs RGB: {s0_sp_rel}")
    check(st_counts[0] > 0 and st_counts[2] > 0,
          "the stokes render launched no bounce or no shadow sweep")
    del S, Sp, Ssp, st, sp, pol

    # ---- 16d. the splat radiance field at K2's size
    t0 = time.perf_counter()
    vp = lrt.load_dict(ms.splat_cloud(VP_SPLATS, SEED, (WIDTH, HEIGHT)))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(vp.n_tris == VP_SPLATS * 80 and vp.n_tris > ci.MAX_VMEM_TRIS
          and vp.n_tris <= ci.MAX_STREAM_TRIS,
          f"the splat cloud has {vp.n_tris} triangles")
    lrt.render(vp, spp=1, seed=SEED + 1)                      # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ci)
    vp_s, calls = capture_render(torch, lrt, ci, vp, VP_SPP)
    vp_counts = launch_counts(ci)
    vp_peak = torch.cuda.max_memory_allocated()
    n_rays = calls[0][1].shape[1]
    splits, per = ci.split_plan(n_rays, vp.tri_boxes.shape[0], "cuda")
    inline = sorted(c[0] for c in calls)
    # the kernels against the plain version, and the bound, on
    # VP_SUB_RAYS evenly spaced rays of the middle query
    _, rays, tris, boxes = calls[len(calls) // 2]
    step = max(1, rays.shape[1] // VP_SUB_RAYS)
    sub = rays[:, ::step][:, :VP_SUB_RAYS].contiguous()
    del calls
    res, _, _ = kernel_vs_plain(torch, ci, sub, tris, boxes, vp.n_tris,
                                reps_plain=1)
    check_agreement(res, "splat cloud rays")
    k = n_rays / sub.shape[1]
    full = roofline(res["needed_tests"] * k, res["candidate_tests"] * k,
                    query_bytes(n_rays, tris, boxes))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        reset_counts(ci)
        secs_tr, vp_img = timed_render(torch, lrt, vp, VP_SPP)
    vp_trace = primal_trace(prof, secs_tr, ci.LAUNCHES)
    # its gradient through the scan adjoint, against a primal
    prm = lrt.traverse(vp, VP_KEYS)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ci)
    g_s, (_, g, _) = timed_call(torch, lambda: lrt.render_grad(
        vp, {key: prm[key] for key in VP_KEYS}, lambda im: im.mean(),
        spp=VP_GRAD_SPP, seed=SEED))
    g_counts = launch_counts(ci)
    g_peak = torch.cuda.max_memory_allocated()
    p_s, _ = timed_render(torch, lrt, vp, VP_GRAD_SPP)
    g_fin = all(bool(torch.isfinite(g[key]).all()) for key in VP_KEYS)
    g_max = {key: float(g[key].abs().max()) for key in VP_KEYS}
    paths = WIDTH * HEIGHT * VP_SPP
    emit("volprim_render", film=[WIDTH, HEIGHT], spp=VP_SPP,
         splats=VP_SPLATS, tris=vp.n_tris, sh_degree=vp.volprims.sh_degree,
         max_depth=vp.max_depth, card=smi, build_seconds=build_s,
         seconds=vp_s, paths_per_s=paths / vp_s, iterations=vp_counts[0],
         finite=bool(torch.isfinite(vp_img).all()),
         mean=float(vp_img.mean()), max_memory_allocated=vp_peak,
         rays_per_query=n_rays, splits_per_query=splits,
         chunks_per_split=per, **split_counts(vp_counts),
         query_ms_median=inline[len(inline) // 2],
         query_ms_total=sum(inline), query_wall_share=sum(inline)
         / (vp_s * 1e3), query_bound_ms=full["bound_ms"],
         query_bound_by=full["bound_by"],
         query_share=full["bound_ms"] / inline[len(inline) // 2],
         sub_rays=int(sub.shape[1]), sub_query=res, trace=vp_trace,
         grad_spp=VP_GRAD_SPP, grad_seconds=g_s, grad_primal_seconds=p_s,
         grad_over_primal=g_s / p_s, grad_finite=g_fin, grad_abs_max=g_max,
         grad_max_memory_allocated=g_peak,
         grad_launches=split_counts(g_counts))
    check(tuple(vp_img.shape) == (HEIGHT, WIDTH, 3), "volprim image shape")
    check(bool(torch.isfinite(vp_img).all()) and float(vp_img.mean()) > 0,
          "volprim image not finite or black")
    check(vp_counts[0] > 0 and vp_counts[1] > 0,
          "the volprim render did not launch the sweep and merge kernels")
    check(g_fin and all(v > 0 for v in g_max.values()),
          "volprim render_grad: gradient not finite or zero")
    return dict(ptracer=pt_counts, stokes=st_counts, polarizer=pol_counts,
                spectral=sp_counts, volprim=vp_counts, volprim_grad=g_counts)


def _vertex_grad(lrt, sc, spp, loss_fn=None, seed=SEED, V=None):
    """render_grad of the vertices V (the scene's unless given; loss: the
    mean image unless given) -> (loss, gradient, image)."""
    V = sc.vertices if V is None else V
    loss, g, img = lrt.render_grad(sc, {"vertices": V},
                                   loss_fn or (lambda im: im.mean()),
                                   spp=spp, seed=seed)
    return loss, g["vertices"], img


def _cosine(torch, a, b):
    a, b = a.cpu().double().reshape(-1), b.cpu().double().reshape(-1)
    return (float((a * b).sum() / (a.norm() * b.norm())),
            abs(float(a.norm() / b.norm()) - 1.0), float(b.norm()))


def _boundary_lanes(torch, np, sc, proj, n):
    """The primary boundary term's samples of scene sc (uniform by length,
    one round of n, a seeded d loss / d image) -> (edges, lanes dict)."""
    rng = np.random.default_rng(SEED)
    delta = torch.as_tensor(rng.uniform(
        0, 1, (sc.film_h, sc.film_w, 3)).astype(np.float32)
        / (sc.film_h * sc.film_w * 3), device=sc.device)
    ev, ef = proj.edge_table(sc.faces, sc.n_tris)
    w = proj.silhouette_weights(sc, sc.vertices, ev, ef)[0]
    lanes = {}
    _, _, e_idx = proj._boundary_grad(sc, sc.vertices, ev, ef, delta, w,
                                      SEED + 7, n, 6, lanes=lanes)
    return e_idx.cpu(), {k: v.cpu() for k, v in lanes.items()}


def _fd_check(torch, np, lrt, ms, d, mask_args, spp, eps):
    """render_grad of the mean image along an edge-growing mask against
    central FD of the mean image (FD_SPP, FD_SEED) -> (g_x, fd, seconds
    of the render_grad)."""
    sc = lrt.load_dict(d)
    V = sc.vertices
    mask, n = ms.right_edge_mask(V.cpu().numpy(), *mask_args)
    check(n == 2, f"the FD scene's edge has {n} vertices, not 2")
    mask = torch.as_tensor(mask, device="cuda")
    t0 = time.perf_counter()
    _, g, _ = _vertex_grad(lrt, sc, spp, seed=FD_GRAD_SEED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(bool(torch.isfinite(g).all()), "FD scene: gradient not finite")

    def loss_at(dv):
        s2 = lrt.apply_params(sc, {"vertices": V + dv * mask})
        return float(lrt.render(s2, spp=FD_SPP, seed=FD_SEED).mean())

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    return float((g * mask).sum()), fd, secs


def shape_phases(torch, np, lrt, ci, smi):
    """Phases shape_small, projective_fd, shape_grad and shape_optimize ->
    the launch counts the kernels line reports."""
    from liverrenderer_tpu_torch.integrators import prb as tprb
    from liverrenderer_tpu_torch.integrators import projective as proj
    from liverrenderer_tpu_torch.scene.liver_proxy import (BUMP, SKY,
                                                           liver_proxy_dict)
    ms = _tests_module("torch_m10_scenes")
    counts = {}

    # ---- 17a. at test size, card against CPU: the vertex gradient of
    # render_grad and the primary boundary term's samples
    small = {"occluder": ms.occluder_dict(16),
             "bumped_proxy": liver_proxy_dict(16, 12, 4, 2, SEED,
                                              bump=BUMP_SMALL,
                                              sky=SKY_SMALL)}
    out = {}
    for name, d in small.items():
        reset_counts(ci)
        g_gpu = _vertex_grad(lrt, lrt.load_dict(d), SHAPE_SMALL_SPP)[1]
        counts[f"small_{name}"] = launch_counts(ci)
        g_cpu = _vertex_grad(lrt, lrt.load_dict(d, device="cpu"),
                             SHAPE_SMALL_SPP)[1]
        cos, norm_rel, gnorm = _cosine(torch, g_gpu, g_cpu)
        e_gpu, l_gpu = _boundary_lanes(torch, np, lrt.load_dict(d), proj,
                                       SHAPE_SMALL_SAMPLES)
        e_cpu, l_cpu = _boundary_lanes(torch, np,
                                       lrt.load_dict(d, device="cpu"), proj,
                                       SHAPE_SMALL_SAMPLES)
        same = (l_gpu["visible"] == l_cpu["visible"]) \
            & (l_gpu["fg_p"] == l_cpu["fg_p"]) \
            & (l_gpu["fg_m"] == l_cpu["fg_m"])
        out[name] = dict(
            grad_cosine=cos, grad_norm_rel=norm_rel, grad_norm=gnorm,
            grad_finite=bool(torch.isfinite(g_gpu).all()),
            edges_equal=bool(torch.equal(e_gpu, e_cpu)),
            lanes_same=float(same.float().mean()),
            visible_lanes=int(l_gpu["visible"].sum()),
            **split_counts(counts[f"small_{name}"]))
    emit("shape_small", spp=SHAPE_SMALL_SPP,
         boundary_samples=SHAPE_SMALL_SAMPLES,
         card=smi, **out)
    for name, v in out.items():
        check(v["grad_finite"] and v["grad_norm"] > 0,
              f"shape_small ({name}): gradient not finite or zero")
        check(v["grad_cosine"] >= GRAD_COS_MIN
              and v["grad_norm_rel"] <= GRAD_NORM_RTOL,
              f"shape_small ({name}): the card's vertex gradient disagrees "
              f"with the CPU's: {v}")
        check(v["edges_equal"], f"shape_small ({name}): sampled edges differ")
        check(v["lanes_same"] >= SHAPE_LANE_MIN,
              f"shape_small ({name}): boundary lanes differ: {v}")
        check(v["visible_lanes"] > 0, f"shape_small ({name}): no visible "
              "boundary sample")

    # ---- 17b. the JAX tests' finite-difference gates, on the card
    fd = {}
    res, spp, eps, rtol = OCC_FD
    reset_counts(ci)
    g_x, f, secs = _fd_check(torch, np, lrt, ms, ms.occluder_dict(res),
                             (0.0, 0.3), spp, eps)
    fd["occluder"] = dict(film=res, spp=spp, eps=eps, grad=g_x, fd=f,
                          rel=abs(g_x - f) / abs(f), rtol=rtol,
                          render_grad_seconds=secs)
    res, spp, eps, rtol = MIRROR_FD
    g_x, f, secs = _fd_check(torch, np, lrt, ms, ms.mirror_dict(res),
                             (2.5, 0.4), spp, eps)
    counts["fd"] = launch_counts(ci)
    fd["rough_mirror"] = dict(film=res, spp=spp, eps=eps, grad=g_x, fd=f,
                              rel=abs(g_x - f) / max(abs(f), 1e-12),
                              rtol=rtol, render_grad_seconds=secs)
    emit("projective_fd", fd_spp=FD_SPP, card=smi, **fd,
         **split_counts(counts["fd"]))
    check(fd["occluder"]["fd"] < -0.5, "projective_fd: the occluder's FD "
          f"is not below -0.5: {fd['occluder']}")
    check(abs(fd["rough_mirror"]["fd"]) > 1e-3,
          "projective_fd: the mirror's silhouette does not move the loss")
    for k, v in fd.items():
        check(v["rel"] <= v["rtol"], f"projective_fd ({k}): AD {v['grad']} "
              f"against FD {v['fd']}: beyond rtol {v['rtol']}")

    # ---- 17c. the slice's path at full width: the vertex gradient of the
    # bumped, sky-lit proxy, split into the replay adjoint and the two
    # boundary terms, in turns with the media.params gradient
    d = liver_proxy_dict(WIDTH, HEIGHT, SHAPE_SPP, SUBDIV, SEED, bump=BUMP,
                         sky=SKY)
    scene = lrt.load_dict(d)
    rounds, parts = [], {}
    # the position of n_samples in each boundary round's arguments
    n_arg = {"_boundary_grad": 7, "_indirect_boundary_grad": 6}
    orig = {k: getattr(proj, k) for k in n_arg}
    terms = {k: getattr(tprb, k) for k in ("boundary_gradient",
                                            "indirect_boundary_gradient")}

    def counted(name):
        def fn(*a, **kw):
            c0 = launch_counts(ci)
            r = orig[name](*a, **kw)
            c1 = launch_counts(ci)
            rounds.append(dict(term=name.strip("_"), samples=a[n_arg[name]],
                               launches=c1[0] - c0[0],
                               merge_launches=c1[1] - c0[1]))
            return r
        return fn

    def timed_term(name):
        def fn(*a, **kw):
            secs, r = timed_call(torch, lambda: terms[name](*a, **kw))
            parts[name] = parts.get(name, 0.0) + secs
            return r
        return fn

    def vertex_run():
        rounds.clear()
        parts.clear()
        reset_counts(ci)
        secs, (_, g, img) = timed_call(
            torch, lambda: _vertex_grad(lrt, scene, SHAPE_SPP))
        return secs, g, img, launch_counts(ci), list(rounds), dict(parts)

    def media_run():
        return timed_call(torch, lambda: lrt.render_grad(
            scene, {"media.params": scene.media.params},
            lambda im: im.mean(), spp=SHAPE_SPP, seed=SEED))[0]

    for k in orig:
        setattr(proj, k, counted(k))
    for k in terms:
        setattr(tprb, k, timed_term(k))
    try:
        vertex_run()            # warm-up (the media run walks the same code)
        torch.cuda.reset_peak_memory_stats()
        v_runs, m_runs = [], []
        for _ in range(SHAPE_GRAD_REPS):
            v_runs.append(vertex_run())
            m_runs.append(media_run())
        peak = torch.cuda.max_memory_allocated()
    finally:
        for k, f in orig.items():
            setattr(proj, k, f)
        for k, f in terms.items():
            setattr(tprb, k, f)
    secs, g, img, c, rnds, prt = min(v_runs, key=lambda r: r[0])
    counts["shape_grad"] = c
    t_media = min(m_runs)
    ev, ef = proj.edge_table(scene.faces, scene.n_tris)
    w = proj.silhouette_weights(scene, scene.vertices, ev, ef)[0]
    sil_v = torch.unique(ev[w > 0].reshape(-1))
    g_sil = g[sil_v]
    nz_sil = float((g_sil.abs().sum(-1) > 0).float().mean())
    prim_s = prt.get("boundary_gradient", 0.0)
    ind_s = prt.get("indirect_boundary_gradient", 0.0)
    emit("shape_grad", film=[WIDTH, HEIGHT], spp=SHAPE_SPP,
         max_depth=scene.max_depth, tris=scene.n_tris,
         vertices=int(scene.vertices.shape[0]), bump=list(BUMP),
         sky=list(SKY), card=smi, seconds=secs,
         seconds_reps=[r[0] for r in v_runs],
         replay_adjoint_seconds=secs - prim_s - ind_s,
         primary_boundary_seconds=prim_s,
         indirect_boundary_seconds=ind_s,
         media_params_seconds=t_media,
         media_params_seconds_reps=m_runs,
         vertices_over_media=secs / t_media,
         boundary_rounds=rnds, max_memory_allocated=peak,
         grad_finite=bool(torch.isfinite(g).all()),
         grad_abs_max=float(g.abs().max()),
         silhouette_vertices=int(sil_v.numel()),
         silhouette_nonzero_share=nz_sil,
         image_mean=float(img.mean()), **split_counts(c))
    check(bool(torch.isfinite(g).all()), "shape_grad: gradient not finite")
    check(c[0] > 0 and c[1] > 0, f"shape_grad: sweep and merge launches "
          f"{c[:2]}")
    check(sil_v.numel() > 0 and float(g_sil.abs().max()) > 0
          and nz_sil >= 0.99, "shape_grad: the gradient is zero on "
          f"silhouette vertices ({nz_sil:.3f} of them non-zero, gate 0.99)")
    check(len(rnds) == 4 and all(r["launches"] > 0 for r in rnds),
          f"shape_grad: boundary rounds without sweeps: {rnds}")

    # ---- 17d. shape optimisation: LargeSteps + Adam toward the proxy
    # scaled about its centroid
    V0 = scene.vertices
    c0 = V0.mean(0, keepdim=True)
    V_t = c0 + SHAPE_SCALE * (V0 - c0)
    target = lrt.render(lrt.apply_params(scene, {"vertices": V_t}),
                        spp=SHAPE_SPP, seed=SHAPE_LOSS_SEED + 1)

    def loss_fn(im):
        return ((im - target) ** 2).mean()

    def eval_loss(V):
        img = lrt.render(lrt.apply_params(scene, {"vertices": V}),
                         spp=SHAPE_SPP, seed=SHAPE_LOSS_SEED)
        return float(loss_fn(img))

    ls = lrt.LargeSteps(int(V0.shape[0]), scene.faces.cpu().numpy(),
                        lambda_=SHAPE_LAMBDA)
    u = ls.to_differential(V0).detach().requires_grad_()
    opt = torch.optim.Adam([u], lr=SHAPE_LR)
    loss0, dist0 = eval_loss(V0), float((V0 - V_t).norm(dim=-1).mean())
    reset_counts(ci)
    step_s, losses = [], []
    for k in range(SHAPE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        V = ls.from_differential(u)
        loss, gv, _ = _vertex_grad(lrt, scene, SHAPE_SPP, loss_fn,
                                   seed=SEED + 1 + k, V=V.detach())
        V.backward(gv)
        opt.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts["shape_optimize"] = launch_counts(ci)
    check(counts["shape_optimize"][0] > 0 and counts["shape_optimize"][1]
          > 0, "shape_optimize did not launch the sweep and merge kernels")
    V1 = ls.from_differential(u).detach()
    loss1, dist1 = eval_loss(V1), float((V1 - V_t).norm(dim=-1).mean())
    emit("shape_optimize", film=[WIDTH, HEIGHT], spp=SHAPE_SPP,
         steps=SHAPE_STEPS, lr=SHAPE_LR, lambda_=SHAPE_LAMBDA,
         target_scale=SHAPE_SCALE, card=smi, seconds_per_step=step_s,
         step_losses=losses, loss_before=loss0, loss_after=loss1,
         vertex_distance_before=dist0, vertex_distance_after=dist1,
         cg_iterations=ls.iterations,
         cg_backward_iterations=ls.backward_iterations,
         **split_counts(counts["shape_optimize"]))
    check(loss1 < loss0, f"shape_optimize: the loss did not fall "
          f"({loss0} -> {loss1})")
    check(dist1 < dist0, f"shape_optimize: the vertices did not move "
          f"toward the target ({dist0} -> {dist1})")
    return counts


def principled_phases(torch, np, lrt, ci, smi, workdir):
    """Phases principled_small and principled_render -> the launch counts
    the kernels line reports."""
    from torch.profiler import ProfilerActivity, profile
    from liverrenderer_tpu_torch.bsdf.measured import write_tensor_file
    from liverrenderer_tpu_torch.scene.cornell import cornell_box
    ms = _tests_module("torch_m10_scenes")
    counts = {}

    # ---- 18a. at test size, card against CPU
    res, spp = PRINCIPLED_SMALL
    mfile = os.path.join(workdir, "synthetic.bsdf")
    write_tensor_file(mfile, ms.synthetic_measured(seed=SEED))
    scenes = {"principled": ms.bsdf_plane_dict(
        ms.PRINCIPLED["clearcoat_sheen"], res),
        "principled_anisotropic": ms.bsdf_plane_dict(
            ms.PRINCIPLED["anisotropic"], res),
        "principled_spec_trans_below": ms.bsdf_plane_dict(
            ms.PRINCIPLED["spec_trans"], res, from_below=True),
        "principled_spec_trans_above": ms.bsdf_plane_dict(
            ms.PRINCIPLED["spec_trans"], res),
        "principledthin": ms.bsdf_plane_dict(ms.PRINCIPLED["thin"], res,
                                             from_below=True),
        "measured": ms.measured_plate_dict(mfile, res)}
    out = {}
    reset_counts(ci)
    for k, d in scenes.items():
        frac, mean_rel, mean, exact = image_vs_cpu(np, lrt, d, spp)
        out[k] = dict(pixel_frac=frac, mean_rel=mean_rel, mean=mean,
                      pixel_exact=exact)
    counts["small"] = launch_counts(ci)
    emit("principled_small", film=[res, res], spp=spp, **out,
         **split_counts(counts["small"]))
    for k, v in out.items():
        check(v["pixel_frac"] >= PIX_FRAC_MIN
              and v["mean_rel"] <= MEAN_RTOL and v["mean"] > 0,
              f"principled_small ({k}): the card disagrees with the CPU: "
              f"{v}")

    # ---- 18b. BASELINE's Cornell box with principled blocks, in turns
    # with the diffuse box
    d_diff = _cornell_dict(cornell_box, CORNELL_RES, "gaussian")
    d_pr = ms.principled_cornell(
        lambda: _cornell_dict(cornell_box, CORNELL_RES, "gaussian"))
    pr, diff = lrt.load_dict(d_pr), lrt.load_dict(d_diff)
    for sc in (pr, diff):
        lrt.render(sc, spp=1, seed=SEED + 1)                   # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ci)
    t_pr, img = timed_render(torch, lrt, pr, CORNELL_SPP)
    counts["render"] = launch_counts(ci)
    peak = torch.cuda.max_memory_allocated()
    t_diff = [timed_render(torch, lrt, diff, CORNELL_SPP)[0]]
    t_diff.append(timed_render(torch, lrt, diff, CORNELL_SPP)[0])
    t_pr = [t_pr, timed_render(torch, lrt, pr, CORNELL_SPP)[0]]
    traces = {}
    for k, sc in (("principled", pr), ("diffuse", diff)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            secs_tr, _ = timed_render(torch, lrt, sc, CORNELL_SPP)
        traces[k] = primal_trace(prof, secs_tr, sc.max_depth)
    paths = CORNELL_RES * CORNELL_RES * CORNELL_SPP
    fin = bool(torch.isfinite(img).all())
    emit("principled_render", film=[CORNELL_RES, CORNELL_RES],
         spp=CORNELL_SPP, max_depth=pr.max_depth, card=smi,
         seconds=t_pr[0], seconds_reps=t_pr, paths_per_s=paths / t_pr[0],
         diffuse_seconds_reps=t_diff,
         principled_over_diffuse=sorted(t_pr)[0] / sorted(t_diff)[0],
         finite=fin, mean=float(img.mean()), max_memory_allocated=peak,
         launches_per_bounce=counts["render"][0] / pr.max_depth,
         trace=traces, **split_counts(counts["render"]))
    check(fin and tuple(img.shape) == (CORNELL_RES, CORNELL_RES, 3),
          "principled_render: image not finite or of the wrong shape")
    check(0.01 < float(img.mean()) < 10.0,
          f"principled_render: mean {float(img.mean())} out of range")
    check(counts["render"][0] > 0, "principled_render did not launch the "
          "sweep kernel")
    return counts


def _instanced_grad_vs_cpu(torch, lrt, d, spp):
    """bsdfs.params of the mean image on the card and on the CPU, over
    the entries both find finite (a diffuse row's entries are nan in both
    packages where a rough plastic is present: tests/test_torch_instancing
    .py) -> (cosine, relative difference of the norms, CPU norm, the nan
    patterns equal)."""
    g = []
    for dev in ("cpu", "cuda"):
        sc = lrt.load_dict(d, device=dev)
        prm = lrt.traverse(sc, ["bsdfs.params"])
        _, gr, _ = lrt.render_grad(sc, {"bsdfs.params": prm["bsdfs.params"]},
                                   lambda im: im.mean(), spp=spp, seed=SEED)
        g.append(gr["bsdfs.params"].cpu().double())
    same = bool(torch.equal(torch.isnan(g[0]), torch.isnan(g[1])))
    fin = torch.isfinite(g[0]) & torch.isfinite(g[1])
    b, a = g[0][fin], g[1][fin]
    return (float((a * b).sum() / (a.norm() * b.norm())),
            abs(float(a.norm() / b.norm()) - 1.0), float(b.norm()), same)


def _profiled_launches(torch, fn):
    """Host kernel launches and seconds of one call of fn, profiled for
    CUDA activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        secs, out = timed_call(torch, fn)
    launches = sum(1 for e in raw_events(prof) if e[0] in LAUNCH_NAMES)
    return launches, secs, out


def _camera_rays(torch, sc, n, gen):
    """n rays of the scene's camera through uniform film positions."""
    from liverrenderer_tpu_torch.sensor.perspective import sample_ray
    pos = torch.rand((n, 2), generator=gen, device="cuda") \
        * torch.tensor([sc.film_w, sc.film_h], device="cuda")
    return sample_ray(sc, pos)


def m10b_phases(torch, np, lrt, ci, treplay, smi, workdir):
    """Phases m10b_small, sunsky_render, texture_render, instanced_render,
    sdf_render and hair_render -> the launch counts the kernels line
    reports, and the hair tuft's K2 query times."""
    from liverrenderer_tpu_torch.accel import intersect as tint
    from liverrenderer_tpu_torch.scene.cornell import cornell_box
    from liverrenderer_tpu_torch.scene.liver_proxy import (BUMP, SKY,
                                                           liver_proxy_dict)
    ms = _tests_module("torch_m10_scenes")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    counts = {}

    def cornell(rfilter="gaussian"):
        return _cornell_dict(cornell_box, CORNELL_RES, rfilter)

    # ---- 19a. one scene per step at test size, card against CPU
    spp = M10B_SMALL_SPP
    tuft_small = os.path.join(workdir, "tuft_small.txt")
    ms.write_hair_tuft(tuft_small, 24, SEED, n_ctrl=6)
    rough_cap = {"type": "roughplastic", "alpha": 0.3,
                 "diffuse_reflectance": {"type": "rgb",
                                         "value": [0.2, 0.6, 0.3]}}
    small = {
        "sunsky_proxy": ms.sunsky_proxy(liver_proxy_dict(
            16, 12, 4, 2, SEED, bump=BUMP_SMALL), hour=SUNSKY_HOUR),
        "mesh_attribute": ms.attr_quad_dict(16),
        "volume": ms.volume_wall_dict(16),
        "instances": ms.instancing_dict(4, "point", (24, 18),
                                        cap_bsdf=rough_cap),
        "sdf": ms.sdf_dict(ms.sphere_sdf(32), 16, light="point"),
        "hair_tuft": ms.hair_tuft_dict(tuft_small, 16, spp, 4)}
    out = {}
    reset_counts(ci)
    for k, d in small.items():
        frac, mean_rel, mean, exact = image_vs_cpu(np, lrt, d, spp)
        out[k] = dict(pixel_frac=frac, mean_rel=mean_rel, mean=mean,
                      pixel_exact=exact)
    counts["small"] = launch_counts(ci)
    cos_s, nrel_s, gn_s, gfin_s = grad_vs_cpu(lrt, small["sunsky_proxy"],
                                              4)
    cos_i, nrel_i, gn_i, nan_i = _instanced_grad_vs_cpu(
        torch, lrt, small["instances"], spp)
    # the instance pass and the SDF march per lane, card against CPU
    lanes = {}
    for k in ("instances", "sdf"):
        scs = [lrt.load_dict(small[k], device=dev) for dev in ("cpu",
                                                               "cuda")]
        ray = _camera_rays(torch, scs[1], 1 << 14, gen)
        res = []
        for sc in scs:
            r = type(ray)(o=ray.o.to(sc.device), d=ray.d.to(sc.device),
                          maxt=ray.maxt.to(sc.device))
            t, prim, _, _, sph = tint.ray_intersect_preliminary(sc, r)
            res.append((t.cpu(), prim.cpu(), sph.cpu()))
        (tc, pc, sc_), (tg, pg, sg) = res
        hit = (pc >= 0) | (sc_ >= 0)
        same = (pg == pc) & (sg == sc_) & hit
        lanes[k] = dict(
            hits=int(hit.sum()),
            same_hit=float((((pg >= 0) | (sg >= 0)) == hit).float().mean()),
            same_prim=float(((pg == pc) & (sg == sc_)).float().mean()),
            max_rel_dt=float(((tg - tc).abs() / tc.abs())[same].max())
            if same.any() else 0.0)
    emit("m10b_small", spp=spp, **out, sunsky_grad_cosine=cos_s,
         sunsky_grad_norm_rel=nrel_s, sunsky_grad_norm=gn_s,
         instanced_grad_cosine=cos_i, instanced_grad_norm_rel=nrel_i,
         instanced_grad_norm=gn_i, instanced_grad_nan_alike=nan_i,
         lanes=lanes, **split_counts(counts["small"]))
    for k, v in out.items():
        check(v["pixel_frac"] >= PIX_FRAC_MIN and v["mean_rel"] <= MEAN_RTOL
              and v["mean"] > 0,
              f"m10b_small ({k}): the card disagrees with the CPU: {v}")
    check(gfin_s and gn_s > 0, "m10b_small: sunsky gradient not finite or 0")
    for k, c, n in (("sunsky", cos_s, nrel_s), ("instanced", cos_i, nrel_i)):
        check(c >= GRAD_COS_MIN and n <= GRAD_NORM_RTOL,
              f"m10b_small: the card's {k} gradient disagrees with the CPU's")
    check(nan_i and gn_i > 0, "m10b_small: instanced gradient")
    for k, v in lanes.items():
        check(v["hits"] > 0 and v["same_hit"] >= M10B_LANE_MIN
              and v["same_prim"] >= PRIM_AGREE_MIN
              and v["max_rel_dt"] <= T_RTOL,
              f"m10b_small: the {k} query disagrees with the CPU: {v}")
    check(counts["small"][0] > 0, "m10b_small launched no sweep")

    # ---- 19b. the main path under a sunsky, against the synthetic sky
    sun = lrt.load_dict(ms.sunsky_proxy(liver_proxy_dict(
        WIDTH, HEIGHT, CMP_SPP, SUBDIV, SEED, bump=BUMP), hour=SUNSKY_HOUR))
    env = lrt.load_dict(liver_proxy_dict(WIDTH, HEIGHT, CMP_SPP, SUBDIV, SEED,
                                         bump=BUMP, sky=SKY))
    check(sun.emitters.env_index >= 0 and sun.has_heightmap,
          "sunsky proxy: no envmap or no bump map")
    for sc in (sun, env):
        lrt.render(sc, spp=1, seed=SEED + 1)                   # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ci)
    t_sun, img = timed_render(torch, lrt, sun, CMP_SPP)
    counts["sunsky"] = launch_counts(ci)
    peak = torch.cuda.max_memory_allocated()
    t_env, _ = timed_render(torch, lrt, env, CMP_SPP)
    g_s, g, _, g_counts = grad_run(torch, lrt, ci, treplay, sun, GRAD_SPP)
    counts["sunsky_grad"] = (
        g_counts["fwd_launches"] + g_counts["replay_launches"],
        g_counts["fwd_merge_launches"] + g_counts["replay_merge_launches"],
        0, 0)
    paths = WIDTH * HEIGHT * CMP_SPP
    fin = bool(torch.isfinite(img).all())
    emit("sunsky_render", film=[WIDTH, HEIGHT], spp=CMP_SPP,
         max_depth=sun.max_depth, hour=SUNSKY_HOUR, card=smi,
         seconds=t_sun, paths_per_s=paths / t_sun, envmap_seconds=t_env,
         sunsky_over_envmap=t_sun / t_env, finite=fin,
         mean=float(img.mean()), max_memory_allocated=peak,
         grad_spp=GRAD_SPP, grad_seconds=g_s,
         grad_paths_per_s=WIDTH * HEIGHT * GRAD_SPP / g_s,
         grad_finite=bool(torch.isfinite(g).all()),
         grad_sigma_t=[float(x) for x in g[0, 0:3]], **g_counts,
         **split_counts(counts["sunsky"]))
    check(fin and tuple(img.shape) == (HEIGHT, WIDTH, 3),
          "sunsky_render: image not finite or of the wrong shape")
    check(0.05 < float(img.mean()) < 50.0,
          f"sunsky_render: mean {float(img.mean())} out of range")
    check(counts["sunsky"][0] > 0 and counts["sunsky"][1] > 0,
          "sunsky_render did not launch the sweep and merge kernels")
    check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
          "sunsky render_grad: gradient not finite or zero")
    del sun, env, img

    # ---- 19c. mesh-attribute and volume textures on the Cornell box
    tex = lrt.load_dict(ms.textured_cornell(cornell, seed=SEED))
    plain = lrt.load_dict(cornell())
    for sc in (tex, plain):
        lrt.render(sc, spp=1, seed=SEED + 1)                   # warm-up
    reset_counts(ci)
    t_tex, img = timed_render(torch, lrt, tex, CORNELL_SPP)
    counts["texture"] = launch_counts(ci)
    t_plain, _ = timed_render(torch, lrt, plain, CORNELL_SPP)
    t_tex = [t_tex, timed_render(torch, lrt, tex, CORNELL_SPP)[0]]
    t_plain = [t_plain, timed_render(torch, lrt, plain, CORNELL_SPP)[0]]
    fin = bool(torch.isfinite(img).all())
    emit("texture_render", film=[CORNELL_RES, CORNELL_RES], spp=CORNELL_SPP,
         max_depth=tex.max_depth, card=smi, seconds_reps=t_tex,
         plain_seconds_reps=t_plain,
         textured_over_plain=min(t_tex) / min(t_plain),
         paths_per_s=CORNELL_RES ** 2 * CORNELL_SPP / min(t_tex),
         has_vertex_attr=tex.has_vertex_attr, finite=fin,
         mean=float(img.mean()), **split_counts(counts["texture"]))
    check(fin and tex.has_vertex_attr, "texture_render: image or scene")
    check(0.01 < float(img.mean()) < 10.0, "texture_render: mean")
    check(counts["texture"][0] > 0, "texture_render launched no sweep")
    del tex, plain, img

    # ---- 19d. instancing: 100 instances against the flattened twin, and
    # the liver proxy's group
    d = ms.instancing_dict(INST_N, "constant", (CORNELL_RES, CORNELL_RES),
                           max_depth=CORNELL_DEPTH)
    inst = lrt.load_dict(d)
    flat = lrt.load_dict(d, flatten_instances=True)
    check(inst.n_instances == INST_N and flat.n_instances == 0,
          "instanced_render: scenes")
    inst_res = {}
    imgs = {}
    for name, sc in (("instanced", inst), ("flattened", flat)):
        lrt.render(sc, spp=1, seed=SEED + 1)                   # warm-up
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ci)
        tint.INST_SYNCS = tint.INST_PAIRS = 0
        secs, imgs[name] = timed_render(torch, lrt, sc, INST_SPP)
        counts[name] = launch_counts(ci)
        inst_res[name] = dict(
            seconds=secs, peak=torch.cuda.max_memory_allocated(),
            queries=counts[name][0], syncs=tint.INST_SYNCS,
            pairs=tint.INST_PAIRS, tris=sc.n_tris,
            geometry_bytes=sum(x.numel() * x.element_size() for x in (
                sc.tri_buf, sc.tri_si, sc.vertices, sc.inst_tris,
                sc.inst_si, sc.inst_xf)))
    # one query of the instance pass on 65,536 camera rays: launches,
    # host syncs and seconds
    ray = _camera_rays(torch, inst, 1 << 16, gen)
    t0 = torch.where(torch.isfinite(ray.maxt), ray.maxt, float("inf"))
    n0 = tint.INST_SYNCS
    q_launch, q_s, _ = _profiled_launches(torch, lambda: tint._instances(
        inst, ray, t0, torch.full_like(t0, -1, dtype=torch.int64),
        torch.zeros_like(t0), torch.zeros_like(t0)))
    q_syncs = tint.INST_SYNCS - n0
    diff = (imgs["instanced"] - imgs["flattened"]).abs()
    # the liver proxy's group: its flattened twin in K2's regime
    d_l = ms.instancing_dict(LIVER_INST, "constant",
                             (LIVER_INST_RES, LIVER_INST_RES),
                             max_depth=CORNELL_DEPTH,
                             group=ms.liver_group(SUBDIV, SEED))
    li, lf = lrt.load_dict(d_l), lrt.load_dict(d_l, flatten_instances=True)
    check(lf.n_tris > ci.MAX_VMEM_TRIS and li.n_tris == 2,
          f"liver group: the flattened twin has {lf.n_tris} triangles")
    liver = {}
    for name, sc in (("instanced", li), ("flattened", lf)):
        lrt.render(sc, spp=1, seed=SEED + 1)                   # warm-up
        reset_counts(ci)
        tint.INST_SYNCS = tint.INST_PAIRS = 0
        secs, im = timed_render(torch, lrt, sc, LIVER_INST_SPP)
        counts[f"liver_{name}"] = launch_counts(ci)
        liver[name] = dict(seconds=secs, queries=counts[f"liver_{name}"][0],
                           syncs=tint.INST_SYNCS, pairs=tint.INST_PAIRS,
                           tris=sc.n_tris, mean=float(im.mean()),
                           finite=bool(torch.isfinite(im).all()))
    emit("instanced_render", film=[CORNELL_RES, CORNELL_RES], spp=INST_SPP,
         max_depth=CORNELL_DEPTH, instances=INST_N, card=smi,
         group_rows=inst.n_inst_tris, **{k: v for k, v in
                                         inst_res.items()},
         instanced_over_flattened=inst_res["instanced"]["seconds"]
         / inst_res["flattened"]["seconds"],
         pass_rays=int(ray.o.shape[0]), pass_launches=q_launch,
         pass_syncs=q_syncs, pass_seconds=q_s,
         image_mean_abs_diff=float(diff.mean()),
         image_max_abs_diff=float(diff.max()),
         liver_group=dict(instances=LIVER_INST, film=[LIVER_INST_RES] * 2,
                          spp=LIVER_INST_SPP, group_rows=li.n_inst_tris,
                          instanced_over_flattened=liver["instanced"][
                              "seconds"] / liver["flattened"]["seconds"],
                          **liver),
         **{f"{k}_launches": split_counts(counts[k]) for k in
            ("instanced", "flattened", "liver_instanced",
             "liver_flattened")})
    for name, v in list(inst_res.items()) + list(liver.items()):
        check(v["queries"] > 0, f"instanced_render ({name}) launched no "
              "sweep")
    check(all(v["finite"] for v in liver.values()), "liver group images")
    check(bool(torch.isfinite(imgs["instanced"]).all())
          and float(diff.mean()) < 2e-3,
          f"instanced vs flattened: mean |diff| {float(diff.mean())}")
    check(counts["liver_flattened"][1] > 0,
          "the liver group's flattened twin did not run the merge (K2)")
    del inst, flat, li, lf, imgs

    # ---- 19e. an SDF on the Cornell box
    sdf = lrt.load_dict(ms.sdf_cornell(cornell, SDF_RES, SEED))
    check(sdf.n_sdfs == 1, "sdf_render: no SDF")
    lrt.render(sdf, spp=1, seed=SEED + 1)                      # warm-up
    reset_counts(ci)
    tint.SDF_STEPS_RUN = 0
    t_sdf, img = timed_render(torch, lrt, sdf, SDF_SPP)
    counts["sdf"] = launch_counts(ci)
    steps = tint.SDF_STEPS_RUN
    t_plain, _ = timed_render(torch, lrt, lrt.load_dict(cornell()), SDF_SPP)
    ray = _camera_rays(torch, sdf, 1 << 16, gen)
    n0 = tint.SDF_STEPS_RUN
    q_launch, q_s, (_, k) = _profiled_launches(torch, lambda: tint._sdfs(
        sdf, ray, torch.full_like(ray.maxt, float("inf"))))
    fin = bool(torch.isfinite(img).all())
    emit("sdf_render", film=[CORNELL_RES, CORNELL_RES], spp=SDF_SPP,
         grid=[SDF_RES] * 3, max_depth=sdf.max_depth, card=smi,
         seconds=t_sdf, plain_seconds=t_plain, sdf_over_plain=t_sdf / t_plain,
         march_steps_run=steps, march_steps_per_query=steps
         / max(counts["sdf"][0], 1), finite=fin, mean=float(img.mean()),
         march_rays=int(ray.o.shape[0]), march_launches=q_launch,
         march_seconds=q_s, march_steps=tint.SDF_STEPS_RUN - n0,
         march_hits=int((k >= 0).sum()), **split_counts(counts["sdf"]))
    check(fin and 0.01 < float(img.mean()) < 10.0, "sdf_render: image")
    check(counts["sdf"][0] > 0, "sdf_render launched no sweep")
    check(int((k >= 0).sum()) > 0, "sdf_render: the march hit nothing")
    del sdf, img

    # ---- 19f. a hair tuft in K2's regime
    tuft = os.path.join(workdir, "tuft.txt")
    ms.write_hair_tuft(tuft, HAIR_STRANDS, SEED)
    d = ms.hair_tuft_dict(tuft, CORNELL_RES, HAIR_SPP, CORNELL_DEPTH)
    d["sensor"]["film"]["rfilter"] = {"type": "gaussian"}
    hair = lrt.load_dict(d)
    check(ci.MAX_VMEM_TRIS < hair.n_tris <= ci.MAX_STREAM_TRIS,
          f"hair tuft: {hair.n_tris} triangles, not in K2's regime")
    lrt.render(hair, spp=1, seed=SEED + 1)                     # warm-up
    reset_counts(ci)
    t_h, calls = capture_render(torch, lrt, ci, hair, HAIR_SPP)
    counts["hair"] = launch_counts(ci)
    n_rays = calls[0][1].shape[1]
    inline = sorted(c[0] for c in calls)
    _, rays, tris, boxes = calls[len(calls) // 2]
    step = max(1, rays.shape[1] // HAIR_SUB_RAYS)
    sub = rays[:, ::step][:, :HAIR_SUB_RAYS].contiguous()
    del calls
    res, _, _ = kernel_vs_plain(torch, ci, sub, tris, boxes, hair.n_tris,
                                reps_plain=1)
    check_agreement(res, "hair tuft rays")
    kk = n_rays / sub.shape[1]
    full = roofline(res["needed_tests"] * kk, res["candidate_tests"] * kk,
                    query_bytes(n_rays, tris, boxes))
    med = inline[len(inline) // 2]
    emit("hair_render", film=[CORNELL_RES, CORNELL_RES], spp=HAIR_SPP,
         max_depth=CORNELL_DEPTH, strands=HAIR_STRANDS, tris=hair.n_tris,
         card=smi, seconds=t_h,
         paths_per_s=CORNELL_RES ** 2 * HAIR_SPP / t_h,
         rays_per_query=n_rays, query_ms_median=med,
         query_ms_total=sum(inline), query_wall_share=sum(inline)
         / (t_h * 1e3), query_bound_ms=full["bound_ms"],
         query_bound_by=full["bound_by"], query_share=full["bound_ms"] / med,
         sub_rays=int(sub.shape[1]), sub_query=res,
         **split_counts(counts["hair"]))
    check(counts["hair"][0] > 0 and counts["hair"][1] > 0,
          "hair_render did not launch the sweep and merge kernels")
    return counts, dict(ms=med, bound_ms=full["bound_ms"],
                        share=full["bound_ms"] / med, tris=hair.n_tris,
                        sweep_ms=res["sweep_ms"], plain_ms=res["plain_ms"])


def _apps_cornell(res):
    """apps_small's scene: the Cornell box, path depth APPS_DEPTH, a box
    filter, the camera turned off the box's diagonals."""
    from liverrenderer_tpu_torch.scene.cornell import cornell_box
    from liverrenderer_tpu_torch.scene.transform import Transform
    d = cornell_box()
    d["integrator"] = {"type": "path", "max_depth": APPS_DEPTH}
    d["sensor"]["film"] = {"type": "hdrfilm", "width": res, "height": res,
                           "rfilter": {"type": "box"}}
    d["sensor"]["to_world"] = d["sensor"]["to_world"].matrix \
        @ Transform().rotate(*APPS_TURN).matrix
    return d


def _blit_levels(np, s):
    """The 8-bit colour levels of a blit_ansi string, in order."""
    import re
    return np.array([int(x) for x in re.findall(r"\d+", s)], np.int64)


def _app_run(np, tint, scene, keys, display=False):
    """run_interactive on scripted keys -> (host frames, camera positions,
    final accumulation, frames rendered, stats)."""
    frames, cams, stats = [], [], {}
    acc, n = tint.run_interactive(
        scene, spp=1, keys=keys, display=display, stats=stats,
        frame_callback=lambda f, a, c: (frames.append(np.array(a)),
                                        cams.append(c.pos.copy())))
    return frames, cams, acc, n, stats


@contextlib.contextmanager
def _log_at_warn():
    """The port's log at WARN for a block (the frames' phase reports and
    the loop's HUD lines), restored after it."""
    from liverrenderer_tpu_torch import log as tlog
    level = tlog._level
    tlog.set_log_level(tlog.WARN)
    try:
        yield
    finally:
        tlog.set_log_level(level)


def apps_phases(torch, np, lrt, ci, smi, bumped, ref_img):
    """Phases apps_small, viewer_render and interactive_render (the
    progressive viewer and the interactive loop) -> the launch counts the
    kernels line reports.  bumped: the main path's scene on the card;
    ref_img: its 64 spp render (bump_env_render's)."""
    from liverrenderer_tpu_torch import interactive as tint
    from liverrenderer_tpu_torch import log as tlog
    from liverrenderer_tpu_torch import viewer as tviewer
    from liverrenderer_tpu_torch.scene.liver_proxy import (BUMP, SKY,
                                                           liver_proxy_dict)
    # ---- apps_small: the viewer's modes and the scripted loop, card vs CPU
    d = _apps_cornell(APPS_RES)
    modes = (("ema", dict(n_frames=4, spp=2, ema_alpha=0.3)),
             ("accum", dict(n_frames=3, spp=2, camera_orbit_deg=40.0)),
             ("denoise", dict(n_frames=2, spp=2)))
    runs = {}
    for dev in ("cpu", "cuda"):
        sc = lrt.load_dict(d, device=dev)
        out = {}
        for mode, kw in modes:
            fr = []
            last = tviewer.run_viewer(sc, mode=mode, frame_callback=lambda
                                      i, im: fr.append(np.array(im)), **kw)
            check(last.device.type == dev,
                  f"apps_small: {mode} frame left the scene's device")
            out[mode] = fr
        out["interactive"] = _app_run(np, tint, sc, APP_KEYS)
        runs[dev] = out
    agree = {}
    for mode, _ in modes:
        pairs = [arrays_agree(np, a, b) for a, b in
                 zip(runs["cuda"][mode], runs["cpu"][mode])]
        agree[mode] = dict(frames=len(pairs),
                           pixel_frac=min(p[0] for p in pairs),
                           mean_rel=max(p[1] for p in pairs))
    gf, gc, gacc, gn, gst = runs["cuda"]["interactive"]
    cf, cc, cacc, cn, _ = runs["cpu"]["interactive"]
    pairs = [arrays_agree(np, a, b) for a, b in zip(gf, cf)]
    agree["interactive"] = dict(frames=gn, pixel_frac=min(p[0] for p in pairs),
                                mean_rel=max(p[1] for p in pairs))
    blit_g, blit_c = tint.blit_ansi(gacc), tint.blit_ansi(cacc)
    lv_g, lv_c = _blit_levels(np, blit_g), _blit_levels(np, blit_c)
    blit_diff = int(np.abs(lv_g - lv_c).max()) if lv_g.shape == lv_c.shape \
        else -1
    cams_equal = all(np.array_equal(a, b) for a, b in zip(gc, cc))
    emit("apps_small", film=[APPS_RES, APPS_RES], max_depth=APPS_DEPTH,
         keys=APP_KEYS, agree=agree, frames=gn, restarts=gst["restarts"],
         blit_equal=blit_g == blit_c, blit_max_level_diff=blit_diff,
         blit_chars=len(blit_g), cameras_equal=cams_equal,
         final_position=[float(x) for x in gc[-1]])
    for mode, a in agree.items():
        check(a["pixel_frac"] >= PIX_FRAC_MIN and a["mean_rel"] <= MEAN_RTOL,
              f"apps_small: the card's {mode} frames disagree with the CPU's")
    check(gn == cn == APP_FRAMES and gst["restarts"] == APP_RESTARTS,
          f"apps_small: {gn} frames, {gst['restarts']} restarts")
    check(cams_equal, "apps_small: the cameras differ between card and CPU")
    # the blit quantises each channel to 8 bits: a card pixel an ulp off
    # the CPU's may round to the next level, never further
    check(0 <= blit_diff <= 1, "apps_small: the blitted frames differ")

    # ---- viewer_render: the main path at full width
    ref = ref_img.cpu().numpy()
    tlog.reset_phases()
    errs = []
    torch.cuda.synchronize()
    reset_counts(ci)
    t0 = time.perf_counter()
    last = tviewer.run_viewer(
        bumped, n_frames=VIEWER_FRAMES, spp=1, mode="ema",
        frame_callback=lambda i, im: errs.append(
            float(np.abs(im - ref).mean())))
    torch.cuda.synchronize()
    ema_s = time.perf_counter() - t0
    ema_counts = launch_counts(ci)
    ema_stages = dict(tlog._phase_totals)
    ema_finite = bool(torch.isfinite(last).all())
    tlog.reset_phases()
    reset_counts(ci)
    t0 = time.perf_counter()
    dn = tviewer.run_viewer(bumped, n_frames=VIEWER_DENOISE_FRAMES, spp=1,
                            mode="denoise")
    torch.cuda.synchronize()
    dn_s = time.perf_counter() - t0
    dn_counts = launch_counts(ci)
    dn_stages = dict(tlog._phase_totals)
    dn_finite = bool(torch.isfinite(dn).all())
    emit("viewer_render", film=[WIDTH, HEIGHT], spp_per_frame=1,
         max_depth=bumped.max_depth, card=smi, ema_frames=VIEWER_FRAMES,
         ema_seconds=ema_s, ema_seconds_per_frame=ema_s / VIEWER_FRAMES,
         ema_stages_s=ema_stages, ema_error_vs_64spp=errs,
         denoise_frames=VIEWER_DENOISE_FRAMES, denoise_seconds=dn_s,
         denoise_seconds_per_frame=dn_s / VIEWER_DENOISE_FRAMES,
         denoise_stages_s=dn_stages,
         ema_launches=ema_counts[0], ema_merge_launches=ema_counts[1],
         ema_launches_per_frame=ema_counts[0] / VIEWER_FRAMES,
         ema_merge_launches_per_frame=ema_counts[1] / VIEWER_FRAMES,
         denoise_launches=dn_counts[0], denoise_merge_launches=dn_counts[1],
         denoise_launches_per_frame=dn_counts[0] / VIEWER_DENOISE_FRAMES,
         denoise_merge_launches_per_frame=dn_counts[1]
         / VIEWER_DENOISE_FRAMES)
    check(ema_finite and dn_finite, "viewer_render: non-finite frame")
    check(len(errs) == VIEWER_FRAMES and errs[-1] < errs[0],
          "viewer_render: the EMA frames did not approach the 64 spp render")
    for name, c in (("ema", ema_counts), ("denoise", dn_counts)):
        check(c[0] > 0 and c[1] > 0,
              f"viewer_render: the {name} frames did not launch the sweep "
              "and merge kernels")

    # ---- interactive_render: the scripted loop with the blit
    films, inter_counts = {}, {}
    for w, h in INTERACTIVE_FILMS:
        sc = bumped if (w, h) == (WIDTH, HEIGHT) else lrt.load_dict(
            liver_proxy_dict(w, h, SPP, SUBDIV, SEED, bump=BUMP, sky=SKY))
        torch.cuda.synchronize()
        reset_counts(ci)
        t0 = time.perf_counter()
        frames, _, acc, n, st = _app_run(np, tint, sc, APP_KEYS,
                                         display=True)
        secs = time.perf_counter() - t0
        c = launch_counts(ci)
        inter_counts[f"{w}x{h}"] = c
        films[f"{w}x{h}"] = dict(
            seconds=secs, frames=n, restarts=st["restarts"],
            render_ms_per_frame=st["render_s"] / st["renders"] * 1e3,
            copy_ms_per_frame=st["copy_s"] / st["renders"] * 1e3,
            blit_ms_per_frame=st["blit_s"] / st["blits"] * 1e3,
            launches=c[0], merge_launches=c[1],
            finite=bool(torch.isfinite(acc).all()))
        check(n == APP_FRAMES and st["restarts"] == APP_RESTARTS
              and st["blits"] == APP_FRAMES,
              f"interactive_render {w}x{h}: {n} frames, {st['restarts']} "
              "restarts")
        check(films[f"{w}x{h}"]["finite"],
              f"interactive_render {w}x{h}: non-finite frame")
        check(c[0] > 0, f"interactive_render {w}x{h}: no sweep launch")
    emit("interactive_render", keys=APP_KEYS, max_depth=bumped.max_depth,
         card=smi, films=films)
    return {"viewer_ema": ema_counts, "viewer_denoise": dn_counts,
            **{f"interactive_{k}": c for k, c in inter_counts.items()}}


def _obj_text(v, f, n, uv) -> str:
    """A mesh as OBJ text: vertices, uvs and normals, 1-based v/vt/vn
    corners (each float written as its shortest repr, so it parses back
    to the same float32)."""
    out = ["v %r %r %r\n" % tuple(r) for r in v.tolist()]
    out += ["vt %r %r\n" % tuple(r) for r in uv.tolist()]
    out += ["vn %r %r %r\n" % tuple(r) for r in n.tolist()]
    out += ["f %d/%d/%d %d/%d/%d %d/%d/%d\n" % (a, a, a, b, b, b, c, c, c)
            for a, b, c in (f + 1).tolist()]
    return "".join(out)


def _twin_phases(torch, np, lrt, ci, smi, workdir, tag, ratio, small, full,
                 twin):
    """Phases <tag>_small and <tag>_render: bench.py's workload path from
    XML whose textures are files (write_proxy_files' keywords: `small` at
    test size, `full` at full size), card against CPU at test size, and at
    full size in turns with its twin (`twin`: the same pixels from other
    files, the height map's codes at BUMP); `ratio` names the file
    render's time over the twin's -> (the file render's launch counts,
    the twin's, the file render's image)."""
    from liverrenderer_tpu_torch.scene.liver_proxy import BUMP
    xf = _tests_module("torch_xml_files")
    path, _ = xf.write_proxy_files(os.path.join(workdir, "small"), 16, 12,
                                   4, 2, SEED, **small)
    frac, mean_rel, mean, exact = image_vs_cpu(np, lrt, path, 4)
    emit(f"{tag}_small", film=[16, 12], spp=4, pixel_frac=frac,
         pixel_exact=exact, mean_rel=mean_rel, mean=mean)
    check(frac >= PIX_FRAC_MIN and mean_rel <= MEAN_RTOL,
          f"{tag}_small: the card's render disagrees with the CPU's")
    xml, sizes = xf.write_proxy_files(
        os.path.join(workdir, tag), WIDTH, HEIGHT, CMP_SPP, SUBDIV, SEED,
        **full)
    twin_xml, twin_sizes = xf.write_proxy_files(
        os.path.join(workdir, "twin"), WIDTH, HEIGHT, CMP_SPP, SUBDIV, SEED,
        bump_res=BUMP[0], **twin)
    loads, scenes = {}, {}
    for which, p in ((tag, xml), ("twin", twin_xml)):
        loads[which], scenes[which] = timed_load(
            torch, lambda: lrt.load_file(p))
    secs = {tag: [], "twin": []}
    counts, imgs = {}, {}
    for which in (tag, "twin", "twin", tag):
        reset_counts(ci)
        t, img = timed_render(torch, lrt, scenes[which], CMP_SPP)
        counts.setdefault(which, launch_counts(ci))
        imgs.setdefault(which, img)
        secs[which].append(t)
    img, twin_img = imgs[tag], imgs["twin"]
    twin_rel = abs(float(img.mean()) - float(twin_img.mean())) \
        / float(twin_img.mean())
    med = statistics.median(secs[tag])
    emit(f"{tag}_render", film=[WIDTH, HEIGHT], spp=CMP_SPP, card=smi,
         bytes=sizes, twin_bytes=twin_sizes, load_file_seconds=loads,
         render_seconds=secs,
         **{ratio: med / statistics.median(secs["twin"])},
         paths_per_s=WIDTH * HEIGHT * CMP_SPP / med,
         finite=bool(torch.isfinite(img).all()), mean=float(img.mean()),
         twin_mean=float(twin_img.mean()), mean_rel_vs_twin=twin_rel,
         bit_identical_to_twin=bool(torch.equal(img, twin_img)),
         launches=counts[tag][0], merge_launches=counts[tag][1],
         twin_launches=counts["twin"][0],
         twin_merge_launches=counts["twin"][1])
    check(scenes[tag].device.type == "cuda" and scenes[tag].has_heightmap
          and scenes[tag].emitters.env_index >= 0,
          f"{tag}_render: load_file did not build the bumped, sky-lit proxy "
          "on the card")
    check(bool(torch.isfinite(img).all()) and 0.05 < float(img.mean()) < 5.0
          and twin_rel <= M9_TWIN_RTOL,
          f"{tag}_render: image not finite, its mean out of range or far "
          "from its twin's")
    check(counts[tag][0] > 0 and counts[tag][1] > 0,
          f"{tag}_render: the render launched no sweep or merge kernel")
    return counts[tag], counts["twin"], img


def m9_phases(torch, np, lrt, ci, smi, workdir):
    """Phases m9_decode, m9_obj, m9_small, m9_render and m9_phases (the
    rest of the loader): the committed DWAA sky and JPEG height map
    decoded on the card's host against their lossless twins and the plain
    loops; the C++ OBJ parse against its plain version; bench.py's
    workload path from those files, card against CPU at test size, and at
    full size in turns with its PNG + PIZ twin -> {name: launch counts}."""
    from liverrenderer_tpu_torch.io import exr as texr
    from liverrenderer_tpu_torch.io import jpeg as tjpeg
    from liverrenderer_tpu_torch.io.png import write_png
    from liverrenderer_tpu_torch.scene import meshio
    from liverrenderer_tpu_torch.scene.liver_proxy import (BUMP, height_map,
                                                           liver_mesh)
    t_start = time.perf_counter()
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data")
    dwa = os.path.join(data, "torch_sky_dwaa.exr")
    piz = os.path.join(data, "torch_sky_piz.exr")
    jpg = os.path.join(data, "torch_height.jpg")
    png = os.path.join(workdir, "height.png")
    codes = np.round(height_map(BUMP[0], SEED) * 255.0).astype(np.uint8)
    write_png(png, codes)

    # ---- 22a. the decoders on the card's host, in turns with their twins
    t0 = time.perf_counter()
    tjpeg.library()
    jpeg_build_s = time.perf_counter() - t0
    readers = {"dwa": lambda: texr.read_exr_any(dwa),
               "piz": lambda: texr.read_exr_any(piz),
               "jpeg": lambda: lrt.read_image(jpg, False),
               "png": lambda: lrt.read_image(png, False)}
    dec = {k: [] for k in readers}
    out = {}
    for _ in range(M9_REPS):
        for kind, fn in readers.items():
            t0 = time.perf_counter()
            out[kind] = fn()
            dec[kind].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in dec.items()}
    rel = np.abs(out["dwa"] - out["piz"]) \
        / np.maximum(np.abs(out["piz"]), 1e-6)
    with open(jpg, "rb") as fh:
        jpeg_bytes = fh.read()
    jcodes = tjpeg.read_jpeg(jpeg_bytes)
    jerr = np.abs(jcodes[..., 0].astype(np.int64) - codes)
    # the plain loops in the C++ ones' place: the DWA sky's AC Huffman
    # stream, and the JPEG entropy decode of a crop of the height map
    native = texr._huf_decode_native
    texr._huf_decode_native = texr._huf_decode_plain
    try:
        t0 = time.perf_counter()
        dwa_plain = texr.read_exr_any(dwa)
        dwa_plain_s = time.perf_counter() - t0
    finally:
        texr._huf_decode_native = native
    crop = tjpeg.encode_jpeg(jcodes[:64, :96, 0])
    t0 = time.perf_counter()
    crop_plain = tjpeg.read_jpeg(crop, tjpeg._scan_plain)
    crop_plain_s = time.perf_counter() - t0
    plain_equal = {"dwa": bool(np.array_equal(dwa_plain, out["dwa"])),
                   "jpeg": bool(np.array_equal(crop_plain,
                                               tjpeg.read_jpeg(crop)))}
    emit("m9_decode", files={"dwa": "tests/data/torch_sky_dwaa.exr",
                             "piz": "tests/data/torch_sky_piz.exr",
                             "jpeg": "tests/data/torch_height.jpg"},
         bytes={"dwa": os.path.getsize(dwa), "piz": os.path.getsize(piz),
                "jpeg": len(jpeg_bytes), "png": os.path.getsize(png)},
         reps=M9_REPS, decode_seconds=med, decode_seconds_reps=dec,
         dwa_over_piz=med["dwa"] / med["piz"],
         jpeg_over_png=med["jpeg"] / med["png"],
         jpeg_build_seconds=jpeg_build_s,
         dwa_vs_piz_max_rel=float(rel.max()),
         dwa_vs_piz_mean_rel=float(rel.mean()),
         dwa_bound=[DWA_SKY_MAX_REL, DWA_SKY_MEAN_REL],
         jpeg_vs_png_max_abs=int(jerr.max()),
         jpeg_vs_png_mean_abs=float(jerr.mean()),
         dwa_plain_huffman_seconds=dwa_plain_s,
         jpeg_plain_crop_seconds=crop_plain_s, plain_equal=plain_equal)
    check(out["dwa"].shape == (512, 1024, 3)
          and bool(np.isfinite(out["dwa"]).all())
          and rel.max() <= DWA_SKY_MAX_REL
          and rel.mean() <= DWA_SKY_MEAN_REL,
          "m9_decode: the DWA sky is not the PIZ sky within its lossy bound")
    check(jcodes.shape == (1024, 1024, 3) and jerr.max() <= JPEG_HEIGHT_MAX
          and jerr.mean() <= JPEG_HEIGHT_MEAN,
          "m9_decode: the JPEG height map is not its PNG within its bound")
    check(all(plain_equal.values()), "m9_decode: a plain decode loop "
          f"disagrees with its C++ version: {plain_equal}")

    # ---- 22b. the C++ OBJ parse against its plain version
    v, f, n, uv = liver_mesh(OBJ_SUBDIV, SEED)
    obj = os.path.join(workdir, "liver.obj")
    t0 = time.perf_counter()
    with open(obj, "w") as fh:
        fh.write(_obj_text(v, f, n, uv))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    meshio.obj_library()
    obj_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_native = meshio.load_mesh(obj)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_plain = meshio._load_obj(obj)
    plain_s = time.perf_counter() - t0
    equal = all(getattr(m_native, k).dtype == getattr(m_plain, k).dtype
                and np.array_equal(getattr(m_native, k), getattr(m_plain, k))
                for k in ("vertices", "faces", "normals", "uvs"))
    emit("m9_obj", subdiv=OBJ_SUBDIV, tris=int(len(m_native.faces)),
         vertices=int(len(m_native.vertices)),
         bytes=os.path.getsize(obj), write_seconds=write_s,
         build_seconds=obj_build_s, native_seconds=native_s,
         plain_seconds=plain_s, plain_over_native=plain_s / native_s,
         bit_identical=equal)
    check(equal and len(m_native.faces) >= 300_000, "m9_obj: the C++ OBJ "
          "parse differs from its plain version")

    # ---- 22c, 22d. the main path from a JPEG height map and the DWAA sky
    # at test size: the height map at BUMP_SMALL (at 16x12 the 1,024^2
    # map's bump frame jumps between texels, and an ulp of hit uv flips
    # paths: card = CPU on 94-96 % of pixels, PNG or JPEG alike), JPEG-coded
    # by the port's encoder (PIL's bytes); at full size, in turns with its
    # PNG + PIZ twin
    jpg_small = os.path.join(workdir, "height_small.jpg")
    with open(jpg_small, "wb") as fh:
        fh.write(tjpeg.encode_jpeg(np.round(
            height_map(BUMP_SMALL[0], SEED) * 255.0).astype(np.uint8)))
    counts, twin_counts, _ = _twin_phases(
        torch, np, lrt, ci, smi, workdir, "m9", "m9_over_png_piz",
        dict(sky_file=dwa, height_file=jpg_small),
        dict(sky_file=dwa, height_file=jpg), dict(sky_file=piz))
    emit("m9_phases", seconds=time.perf_counter() - t_start)
    return {"m9_render": counts, "m9_twin": twin_counts}


def m9b_phases(torch, np, lrt, ci, smi, workdir):
    """Phases m9b_decode, m9b_small, m9b_render, m9b_write and m9b_phases
    (the raster formats the JAX package opens through Pillow): the
    committed LZW TIFF height map and GIF floor decoded on the card's
    host in turns with the PNG height map, and through the plain LZW
    loops; bench.py's workload path from XML with a TIFF height map and a
    GIF-textured floor, card against CPU at test size, and at full size
    in turns with its PNG twin; write_image to .tif and .qoi read back ->
    {name: launch counts}."""
    from liverrenderer_tpu_torch.io import gif as tgif
    from liverrenderer_tpu_torch.io import legacy, lzw
    from liverrenderer_tpu_torch.io import tiff as ttiff
    from liverrenderer_tpu_torch.io.image import dither_8bit, encode_8bit
    from liverrenderer_tpu_torch.io.png import write_png
    from liverrenderer_tpu_torch.scene.liver_proxy import BUMP, height_map
    rf = _tests_module("torch_raster_files")
    t_start = time.perf_counter()
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data")
    tif = os.path.join(data, "torch_height.tif")
    gif = os.path.join(data, "torch_floor.gif")
    png = os.path.join(workdir, "height.png")
    codes = np.round(height_map(BUMP[0], SEED) * 255.0).astype(np.uint8)
    write_png(png, codes)

    # ---- 23a. the decoders on the card's host, in turns with the PNG
    t0 = time.perf_counter()
    lzw.library()
    build_s = time.perf_counter() - t0
    readers = {"tiff": lambda: lrt.read_image(tif, False),
               "gif": lambda: lrt.read_image(gif),
               "png": lambda: lrt.read_image(png, False)}
    dec = {k: [] for k in readers}
    out = {}
    for _ in range(M9_REPS):
        for kind, fn in readers.items():
            t0 = time.perf_counter()
            out[kind] = fn()
            dec[kind].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in dec.items()}
    with open(tif, "rb") as fh:
        tif_bytes = fh.read()
    with open(gif, "rb") as fh:
        gif_bytes = fh.read()
    native = {"tiff": ttiff.read_tiff(tif_bytes),
              "gif": tgif.read_gif(gif_bytes)}
    loops = (lzw.lzw_tiff, lzw.lzw_gif)
    lzw.lzw_tiff, lzw.lzw_gif = lzw._lzw_tiff_plain, lzw._lzw_gif_plain
    try:
        t0 = time.perf_counter()
        plain_tiff = ttiff.read_tiff(tif_bytes)
        plain_tiff_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain_gif = tgif.read_gif(gif_bytes)
        plain_gif_s = time.perf_counter() - t0
    finally:
        lzw.lzw_tiff, lzw.lzw_gif = loops
    plain_equal = {"tiff": bool(np.array_equal(plain_tiff, native["tiff"])),
                   "gif": bool(np.array_equal(plain_gif, native["gif"]))}
    tiff_exact = bool(np.array_equal(native["tiff"][..., 0], codes)
                      and np.array_equal(out["tiff"], out["png"]))
    emit("m9b_decode", files={"tiff": "tests/data/torch_height.tif",
                              "gif": "tests/data/torch_floor.gif"},
         bytes={"tiff": len(tif_bytes), "gif": len(gif_bytes),
                "png": os.path.getsize(png)},
         reps=M9_REPS, decode_seconds=med, decode_seconds_reps=dec,
         tiff_over_png_decode=med["tiff"] / med["png"],
         lzw_build_seconds=build_s, plain_tiff_seconds=plain_tiff_s,
         plain_gif_seconds=plain_gif_s, plain_equal=plain_equal,
         tiff_equals_png_codes=tiff_exact,
         gif_shape=list(out["gif"].shape))
    check(tiff_exact, "m9b_decode: the TIFF height map is not its 8-bit "
          "codes")
    check(out["gif"].shape == (64, 64, 3)
          and bool(np.isfinite(out["gif"]).all()),
          "m9b_decode: the GIF floor did not decode to 64 x 64 RGB")
    check(all(plain_equal.values()), "m9b_decode: a plain LZW loop "
          f"disagrees with its C++ version: {plain_equal}")

    # ---- 23b, 23c. the main path from a TIFF height map and a GIF floor
    # at test size: the 32^2 height map (see m9_small), LZW with predictor
    # 2 by the test writer (no Pillow on this machine); at full size, in
    # turns with its PNG twin (the same height codes and floor pixels as
    # PNG files)
    tif_small = os.path.join(workdir, "height_small.tif")
    with open(tif_small, "wb") as fh:
        fh.write(rf.write_tiff(np.round(height_map(BUMP_SMALL[0], SEED)
                                        * 255.0).astype(np.uint8), 1,
                               compression=5, predictor=2,
                               rows_per_strip=8))
    floor_png = os.path.join(workdir, "floor.png")
    write_png(floor_png, native["gif"])
    counts, twin_counts, img = _twin_phases(
        torch, np, lrt, ci, smi, workdir, "m9b", "tiff_over_png",
        dict(bump_res=BUMP_SMALL[0], sky=SKY_SMALL, height_file=tif_small,
             floor_file=gif),
        dict(height_file=tif, floor_file=gif), dict(floor_file=floor_png))

    # ---- 23d. write_image to .tif and .qoi, read back: the dithered
    # 8-bit pixels write_image computes
    host = img.cpu().numpy()
    px = dither_8bit(host)
    writes = {}
    for ext in (".tif", ".qoi"):
        path = os.path.join(workdir, "render" + ext)
        t0 = time.perf_counter()
        lrt.write_image(path, host)
        w_s = time.perf_counter() - t0
        with open(path, "rb") as fh:
            body = fh.read()
        t0 = time.perf_counter()
        back = ttiff.read_tiff(body) if ext == ".tif" else \
            legacy.open_qoi(body)()
        r_s = time.perf_counter() - t0
        writes[ext] = {"bytes": len(body), "write_seconds": w_s,
                       "read_seconds": r_s,
                       "equal": bool(np.array_equal(back, px)),
                       "encoder_equal": body == encode_8bit(
                           px, "TIFF" if ext == ".tif" else "QOI")}
    emit("m9b_write", film=[WIDTH, HEIGHT], files=writes)
    check(all(v["equal"] and v["encoder_equal"] for v in writes.values()),
          f"m9b_write: a written file does not read back: {writes}")
    emit("m9b_phases", seconds=time.perf_counter() - t_start)
    return {"m9b_render": counts, "m9b_twin": twin_counts}


# the WebP height map's distance from the PNG's 8-bit codes (max and mean
# over the red channel, in codes), measured on the CPU against Pillow's
# decode (tests/test_torch_m9c_slice.py: max 8, mean 0.6917)
M9C_HEIGHT_MAX, M9C_HEIGHT_MEAN = 8, 0.70


def m9c_phases(torch, np, lrt, ci, smi, workdir):
    """Phases m9c_decode, m9c_small, m9c_render, m9c_write and m9c_phases
    (WebP and the BCn family): the committed WebP and DDS files decoded on
    the card's host in turns with the PNG height map, and through the
    plain loops; bench.py's workload path from XML with a lossy WebP
    height map and a BC7-textured floor, card against CPU at test size,
    and at full size in turns with its PNG twin; write_image to .dds read
    back -> {name: launch counts}."""
    from liverrenderer_tpu_torch.io import bcn, dds, vp8l, webp
    from liverrenderer_tpu_torch.io.image import (dither_8bit, encode_8bit,
                                                  read_8bit)
    from liverrenderer_tpu_torch.io.png import write_png
    from liverrenderer_tpu_torch.scene.liver_proxy import BUMP, height_map
    t_start = time.perf_counter()
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data")
    files = {k: os.path.join(data, v) for k, v in (
        ("webp", "torch_height.webp"), ("webp32", "torch_height32.webp"),
        ("crop", "torch_height_crop.webp"), ("alpha", "torch_alpha64.webp"),
        ("anim", "torch_anim.webp"), ("dds", "torch_floor_bc7.dds"),
        ("floor_png", "torch_floor_bc7.png"))}
    png = os.path.join(workdir, "height.png")
    codes = np.round(height_map(BUMP[0], SEED) * 255.0).astype(np.uint8)
    write_png(png, codes)

    # ---- 24a. the decoders on the card's host, in turns with the PNG
    t0 = time.perf_counter()
    vp8l.library()
    bcn.library()
    build_s = time.perf_counter() - t0
    readers = {k: (lambda p=files[k]: lrt.read_image(p, False))
               for k in ("webp", "dds", "alpha", "anim")}
    readers["png"] = lambda: lrt.read_image(png, False)
    dec = {k: [] for k in readers}
    for _ in range(M9_REPS):
        for kind, fn in readers.items():
            t0 = time.perf_counter()
            fn()
            dec[kind].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in dec.items()}
    height = read_8bit(files["webp"])[..., 0].astype(np.int64)
    diff = np.abs(height - codes)
    floor = read_8bit(files["dds"])
    floor_exact = bool(np.array_equal(floor, read_8bit(files["floor_png"])))
    plain_s, plain_equal = {}, {}
    for kind in ("alpha", "anim", "crop"):
        with open(files[kind], "rb") as fh:
            body = fh.read()
        cw, ch, frame = webp.demux(body)
        fast = webp.first_frame(body, cw, ch, frame)
        t0 = time.perf_counter()
        slow = webp.first_frame(body, cw, ch, frame, plain=True)
        plain_s[kind] = time.perf_counter() - t0
        plain_equal[kind] = bool(np.array_equal(fast, slow))
    with open(files["dds"], "rb") as fh:
        blocks = fh.read()[148:]
    t0 = time.perf_counter()
    slow = bcn.decode(blocks[:16 * 64 * 4], 256, 16, 7, "BC7", plain=True)
    plain_s["bc7_rows16"] = time.perf_counter() - t0
    plain_equal["bc7_rows16"] = bool(np.array_equal(
        bcn.decode(blocks, 256, 256, 7, "BC7")[:16], slow))
    sizes = {k: os.path.getsize(v) for k, v in files.items()}
    sizes["png"] = os.path.getsize(png)
    emit("m9c_decode", files={k: os.path.relpath(v, os.path.dirname(data))
                              for k, v in files.items()},
         bytes=sizes, reps=M9_REPS, decode_seconds=med,
         decode_seconds_reps=dec,
         webp_over_png_decode=med["webp"] / med["png"],
         dds_over_png_decode=med["dds"] / med["png"],
         build_seconds=build_s, plain_seconds=plain_s,
         plain_equal=plain_equal, height_max_codes=int(diff.max()),
         height_mean_codes=float(diff.mean()),
         height_gates=[M9C_HEIGHT_MAX, M9C_HEIGHT_MEAN],
         floor_equals_png=floor_exact, floor_shape=list(floor.shape))
    check(diff.max() <= M9C_HEIGHT_MAX and diff.mean() <= M9C_HEIGHT_MEAN,
          "m9c_decode: the WebP height map is past its bound of the codes")
    check(floor_exact and floor.shape == (256, 256, 3),
          "m9c_decode: the BC7 floor is not its committed pixels")
    check(all(plain_equal.values()), "m9c_decode: a plain loop disagrees "
          f"with its C++ version: {plain_equal}")

    # ---- 24b, 24c. the main path from a WebP height map and a DDS floor
    # at test size: the committed 32^2 map (see m9_small); at full size, in
    # turns with its PNG twin (the PNG height codes and the floor's decoded
    # pixels as PNG)
    counts, twin_counts, img = _twin_phases(
        torch, np, lrt, ci, smi, workdir, "m9c", "webp_dds_over_png",
        dict(bump_res=BUMP_SMALL[0], sky=SKY_SMALL,
             height_file=files["webp32"], floor_file=files["dds"]),
        dict(height_file=files["webp"], floor_file=files["dds"]),
        dict(floor_file=files["floor_png"]))

    # ---- 24d. write_image to .dds, read back: the dithered 8-bit pixels
    host = img.cpu().numpy()
    px = dither_8bit(host)
    path = os.path.join(workdir, "render.dds")
    t0 = time.perf_counter()
    lrt.write_image(path, host)
    w_s = time.perf_counter() - t0
    with open(path, "rb") as fh:
        body = fh.read()
    t0 = time.perf_counter()
    back = dds.open_dds(body)()
    r_s = time.perf_counter() - t0
    writes = {".dds": {"bytes": len(body), "write_seconds": w_s,
                       "read_seconds": r_s,
                       "equal": bool(np.array_equal(back, px)),
                       "encoder_equal": body == encode_8bit(px, "DDS")}}
    emit("m9c_write", film=[WIDTH, HEIGHT], files=writes)
    check(all(v["equal"] and v["encoder_equal"] for v in writes.values()),
          f"m9c_write: the written file does not read back: {writes}")
    emit("m9c_phases", seconds=time.perf_counter() - t_start)
    return {"m9c_render": counts, "m9c_twin": twin_counts}


# the arithmetic-coded height map's distance from the PNG's 8-bit codes
# (max and mean over the red channel, in codes), measured on the CPU
# against Pillow's decode (tests/test_torch_jpeg_kinds.py: max 2, mean
# 0.1829)
M9D_HEIGHT_MAX, M9D_HEIGHT_MEAN = 2, 0.19


def m9d_phases(torch, np, lrt, ci, smi, workdir):
    """Phases m9d_decode, m9d_small, m9d_render and m9d_phases (the JPEG
    kinds and JPEG-in-TIFF): the committed arithmetic-coded height map,
    CMYK JPEG and YCbCr JPEG-in-TIFF floor decoded on the card's host in
    turns with the PNG height map, the C++ arithmetic loop against its
    plain version on a crop; bench.py's workload path from XML with the
    arithmetic height map and the TIFF floor, card against CPU at test
    size, and at full size in turns with its PNG twin -> {name: launch
    counts}."""
    from liverrenderer_tpu_torch.io import jpeg, jpeg_arith
    from liverrenderer_tpu_torch.io.image import read_8bit
    from liverrenderer_tpu_torch.io.png import write_png
    from liverrenderer_tpu_torch.scene.liver_proxy import BUMP, height_map
    t_start = time.perf_counter()
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data")
    files = {k: os.path.join(data, v) for k, v in (
        ("arith", "torch_height_arith.jpg"),
        ("arith32", "torch_height32_arith.jpg"),
        ("crop", "torch_height_arith_crop.jpg"),
        ("cmyk", "torch_cmyk.jpg"), ("cmyk_png", "torch_cmyk.png"),
        ("tiff", "torch_floor_ycc.tif"), ("tiff_png", "torch_floor_ycc.png"))}
    png = os.path.join(workdir, "height.png")
    codes = np.round(height_map(BUMP[0], SEED) * 255.0).astype(np.uint8)
    write_png(png, codes)

    # ---- 25a. the decoders on the card's host, in turns with the PNG
    t0 = time.perf_counter()
    jpeg_arith.library()
    jpeg.library()
    build_s = time.perf_counter() - t0
    readers = {k: (lambda p=files[k]: lrt.read_image(p, False))
               for k in ("arith", "cmyk", "tiff")}
    readers["png"] = lambda: lrt.read_image(png, False)
    dec = {k: [] for k in readers}
    for _ in range(M9_REPS):
        for kind, fn in readers.items():
            t0 = time.perf_counter()
            fn()
            dec[kind].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in dec.items()}
    height = read_8bit(files["arith"])[..., 0].astype(np.int64)
    diff = np.abs(height - codes)
    twins = {k: bool(np.array_equal(read_8bit(files[k]),
                                    read_8bit(files[k + "_png"])))
             for k in ("cmyk", "tiff")}
    plain_s, plain_equal = {}, {}
    for kind in ("crop", "arith32"):
        with open(files[kind], "rb") as fh:
            body = fh.read()
        coefs = {}
        for which, fn in (("cpp", jpeg_arith._scan_native),
                          ("plain", jpeg_arith._scan_plain)):
            st = jpeg._new_state()
            t0 = time.perf_counter()
            jpeg._parse(body, st, None, fn)
            if which == "plain":
                plain_s[kind] = time.perf_counter() - t0
            coefs[which] = st["coefs"]
        plain_equal[kind] = all(bool(np.array_equal(a, b)) for a, b in
                                zip(coefs["cpp"], coefs["plain"]))
    sizes = {k: os.path.getsize(v) for k, v in files.items()}
    sizes["png"] = os.path.getsize(png)
    emit("m9d_decode", files={k: os.path.relpath(v, os.path.dirname(data))
                              for k, v in files.items()},
         bytes=sizes, reps=M9_REPS, decode_seconds=med,
         decode_seconds_reps=dec,
         arith_over_png_decode=med["arith"] / med["png"],
         tiff_over_png_decode=med["tiff"] / med["png"],
         build_seconds=build_s, plain_seconds=plain_s,
         plain_equal=plain_equal, height_max_codes=int(diff.max()),
         height_mean_codes=float(diff.mean()),
         height_gates=[M9D_HEIGHT_MAX, M9D_HEIGHT_MEAN],
         equals_png_twin=twins)
    check(diff.max() <= M9D_HEIGHT_MAX and diff.mean() <= M9D_HEIGHT_MEAN,
          "m9d_decode: the arithmetic height map is past its bound of the "
          "codes")
    check(all(twins.values()), "m9d_decode: the CMYK JPEG or the TIFF "
          f"floor is not its PNG twin's pixels: {twins}")
    check(all(plain_equal.values()), "m9d_decode: the plain arithmetic "
          f"loop disagrees with its C++ version: {plain_equal}")

    # ---- 25b, 25c. the main path from an arithmetic-coded height map and
    # a JPEG-in-TIFF floor at test size: the committed 32^2 map (see
    # m9_small); at full size, in turns with its PNG twin (the PNG height
    # codes and the floor's decoded pixels as PNG)
    counts, twin_counts, _ = _twin_phases(
        torch, np, lrt, ci, smi, workdir, "m9d", "arith_tiff_over_png",
        dict(bump_res=BUMP_SMALL[0], sky=SKY_SMALL,
             height_file=files["arith32"], floor_file=files["tiff"]),
        dict(height_file=files["arith"], floor_file=files["tiff"]),
        dict(floor_file=files["tiff_png"]))
    emit("m9d_phases", seconds=time.perf_counter() - t_start)
    return {"m9d_render": counts, "m9d_twin": twin_counts}


def m9e_phases(torch, np, lrt, ci, smi, workdir):
    """Phases m9e_decode, m9e_small, m9e_render and m9e_phases (the rest
    of TIFF): the committed ZSTD and LZMA height maps (predictor 2, BUMP's
    codes, libtiff's strips) and the Group 4 fax floor decoded on the
    card's host in turns with the PNG height map, each held to the codes
    or to its PNG twin, the C++ fax and Zstandard loops against their plain
    versions on a strip; bench.py's workload path from XML with the ZSTD
    height map and the G4 floor, card against CPU at test size, and at
    full size in turns with its PNG twin -> {name: launch counts}."""
    from liverrenderer_tpu_torch.io import tiff_fax, zstd
    from liverrenderer_tpu_torch.io.image import read_8bit
    from liverrenderer_tpu_torch.io.png import write_png
    from liverrenderer_tpu_torch.scene.liver_proxy import BUMP, height_map
    t_start = time.perf_counter()
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data")
    files = {k: os.path.join(data, v) for k, v in (
        ("zstd", "torch_height_zstd.tif"),
        ("zstd32", "torch_height32_zstd.tif"),
        ("lzma", "torch_height_lzma.tif"),
        ("g4", "torch_floor_g4.tif"), ("g4_png", "torch_floor_g4.png"))}
    png = os.path.join(workdir, "height.png")
    codes = np.round(height_map(BUMP[0], SEED) * 255.0).astype(np.uint8)
    write_png(png, codes)

    # ---- 26a. the decoders on the card's host, in turns with the PNG
    t0 = time.perf_counter()
    tiff_fax.library()
    zstd.library()
    build_s = time.perf_counter() - t0
    readers = {k: (lambda p=files[k]: lrt.read_image(p, False))
               for k in ("zstd", "lzma", "g4")}
    readers["png"] = lambda: lrt.read_image(png, False)
    dec = {k: [] for k in readers}
    for _ in range(M9_REPS):
        for kind, fn in readers.items():
            t0 = time.perf_counter()
            fn()
            dec[kind].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in dec.items()}
    exact = {k: bool(np.array_equal(read_8bit(files[k])[..., 0], codes))
             for k in ("zstd", "lzma")}
    exact["g4"] = bool(np.array_equal(read_8bit(files["g4"]),
                                      read_8bit(files["g4_png"])))
    # the plain loops against the C++ ones on a strip of each file
    strips = {k: _tiff_strip(files[k]) for k in ("zstd", "g4")}
    plain_s, zs = {}, {}
    for which, fn in (("cpp", zstd.decode), ("plain", zstd._decode_plain)):
        t0 = time.perf_counter()
        zs[which] = fn(strips["zstd"], 64 * BUMP[0])
        if which == "plain":
            plain_s["zstd"] = time.perf_counter() - t0
    plain_equal = {"zstd": zs["cpp"] is not None and zs["cpp"] == zs["plain"]
                   and len(zs["cpp"]) == 64 * BUMP[0]}
    fax = {}
    for which, fn in (("cpp", tiff_fax.decode),
                      ("plain", tiff_fax._decode_plain)):
        runs = np.zeros(2 * tiff_fax.nruns(256, tiff_fax.G4), np.uint32)
        strip = np.zeros(32 * 256, np.uint8)
        t0 = time.perf_counter()
        status = fn(strips["g4"], tiff_fax.G4, 256, 256, 32, False, False,
                    runs, strip, np.zeros(1, np.int32))
        if which == "plain":
            plain_s["g4"] = time.perf_counter() - t0
        fax[which] = (status, strip.tobytes(), runs.tobytes())
    plain_equal["g4"] = fax["cpp"] == fax["plain"] and fax["cpp"][0] == 1
    sizes = {k: os.path.getsize(v) for k, v in files.items()}
    sizes["png"] = os.path.getsize(png)
    emit("m9e_decode", files={k: os.path.relpath(v, os.path.dirname(data))
                              for k, v in files.items()},
         bytes=sizes, reps=M9_REPS, decode_seconds=med,
         decode_seconds_reps=dec,
         zstd_over_png_decode=med["zstd"] / med["png"],
         lzma_over_png_decode=med["lzma"] / med["png"],
         build_seconds=build_s, plain_seconds=plain_s,
         plain_equal=plain_equal, equals_codes_or_twin=exact)
    check(all(exact.values()), "m9e_decode: a height map is not the codes "
          f"or the G4 floor not its PNG twin's pixels: {exact}")
    check(all(plain_equal.values()), "m9e_decode: a plain loop disagrees "
          f"with its C++ version: {plain_equal}")

    # ---- 26b, 26c. the main path from a ZSTD height map and a G4 floor at
    # test size (the committed 32^2 map, as m9_small); at full size, in
    # turns with its PNG twin (the PNG height codes and the floor's pixels
    # as PNG)
    counts, twin_counts, _ = _twin_phases(
        torch, np, lrt, ci, smi, workdir, "m9e", "zstd_g4_over_png",
        dict(bump_res=BUMP_SMALL[0], sky=SKY_SMALL,
             height_file=files["zstd32"], floor_file=files["g4"]),
        dict(height_file=files["zstd"], floor_file=files["g4"]),
        dict(floor_file=files["g4_png"]))
    emit("m9e_phases", seconds=time.perf_counter() - t_start)
    return {"m9e_render": counts, "m9e_twin": twin_counts}


def _tiff_strip(path):
    """The first strip of a little-endian TIFF's first IFD."""
    with open(path, "rb") as fh:
        d = fh.read()
    ifd = struct.unpack_from("<I", d, 4)[0]
    tags = {}
    for i in range(struct.unpack_from("<H", d, ifd)[0]):
        tag, typ, cnt, val = struct.unpack_from("<HHII", d, ifd + 2 + 12 * i)
        tags[tag] = struct.unpack_from("<I", d, val)[0] if cnt > 1 else val
    return d[tags[273]:tags[273] + tags[279]]


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _vec_agree(a, b):
    """(cosine, relative difference of the norms) of two tensors."""
    a, b = a.detach().cpu().double().reshape(-1), \
        b.detach().cpu().double().reshape(-1)
    return (float((a * b).sum() / (a.norm() * b.norm())),
            abs(float(a.norm() / b.norm()) - 1.0))


_SHARD_WORKER = r"""
import json, pickle, sys, time
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[4])
import liverrenderer_tpu_torch as lrt
from liverrenderer_tpu_torch.accel import cuda_intersect as ci
from liverrenderer_tpu_torch.parallel import mesh as tmesh
rank, port, out, _, scene_pkl = sys.argv[1:6]
rank = int(rank)
SEED, SHARDED_SPP, SCALING_SPP, N = map(int, sys.argv[6:])
DEV = "cuda:0"
ci.build_kernel()
# two ranks on one card: NCCL refuses them, gloo all-reduces CUDA tensors
tmesh.init_distributed(f"127.0.0.1:{port}", num_processes=N,
                       process_id=rank, device=DEV, backend="gloo")
mesh = tmesh.make_mesh(device=DEV)
assert (mesh.rank, mesh.size) == (rank, N) and mesh.group is not None
with open(scene_pkl, "rb") as f:
    sc = lrt.load_dict(pickle.load(f), device=DEV)

def timed(fn):
    torch.cuda.synchronize()
    ci.LAUNCHES = ci.MERGE_LAUNCHES = 0
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res, (ci.LAUNCHES, ci.MERGE_LAUNCHES)

t_r, acc, c_r = timed(lambda: tmesh.render_regen_sharded(
    sc, mesh, spp=SHARDED_SPP, seed=SEED))
box = {}
def grad():
    box["out"] = tmesh.render_grad_replay_sharded(
        sc, mesh, {"media.params": sc.media.params}, lambda im: im.mean(),
        spp=SHARDED_SPP, seed=SEED)
t_g, stats, c_g = timed(lambda: tmesh.collective_stats(grad))
loss, g, img = box["out"]
scaling = tmesh.measure_scaling(sc, spp=SCALING_SPP, reps=1,
                                renderer="regen")
torch.save({"acc": acc.cpu(), "grad": g["media.params"].cpu(),
            "loss": float(loss), "image": img.cpu()}, out)
print("SHARD_RESULT " + json.dumps(dict(
    rank=rank, render_seconds=t_r, render_launches=c_r, grad_seconds=t_g,
    grad_launches=c_g, grad_collectives=stats, scaling=scaling)), flush=True)
dist.destroy_process_group()
"""


def sharded_phases(torch, np, lrt, ci, smi, workdir, small_d, main_d,
                   bumped):
    """Phases sharded_small (a world of one over NCCL on the card) and
    sharded_render (two ranks on the card over gloo, the main path) -> the
    launch counts the kernels line reports.  small_d: the main path's
    scene dict at test size; main_d: at full size, and bumped: the scene
    load_dict built from it on the card."""
    import pickle
    import torch.distributed as dist
    from liverrenderer_tpu_torch import film as tfilm
    from liverrenderer_tpu_torch.integrators import regen as tregen
    from liverrenderer_tpu_torch.integrators.common import render_pass
    from liverrenderer_tpu_torch.parallel import mesh as tmesh

    # ---- sharded_small: NCCL as a world of one, against the unsharded
    # functions on the card
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = tmesh.make_mesh(device="cuda")
        check(mesh.group is not None and mesh.size == 1
              and dist.get_backend() == "nccl",
              "sharded_small: not an NCCL world of one")
        sc = lrt.load_dict(small_d)
        spp = SHARDED_SMALL_SPP
        key = "media.params"
        stats, res = {}, {}
        reset_counts(ci)

        def run(name, fn):
            box = {}
            stats[name] = tmesh.collective_stats(
                lambda: box.update(out=fn()))
            return box["out"]

        plain = tfilm.develop(render_pass(sc, SEED, spp, 0)).cpu().numpy()
        got = run("render_sharded", lambda: tmesh.render_sharded(
            sc, mesh, spp=spp, seed=SEED)).cpu().numpy()
        res["render_sharded"] = arrays_agree(np, got, plain)[:2]
        for il in (True, False):
            got = run(f"render_tiled_{'interleaved' if il else 'contiguous'}",
                      lambda: tmesh.render_tiled(sc, mesh, spp=spp, seed=SEED,
                                                 interleave=il))
            res[f"render_tiled_{'interleaved' if il else 'contiguous'}"] = \
                arrays_agree(np, got.cpu().numpy(), plain)[:2]
        acc = run("render_regen_sharded", lambda: tmesh.render_regen_sharded(
            sc, mesh, spp=spp, seed=SEED))
        ref = tregen.render_regen(sc, SEED, spp)
        res["render_regen_sharded"] = arrays_agree(
            np, acc.cpu().numpy(), ref.cpu().numpy())[:2]
        loss, g, _ = run("render_grad_replay_sharded",
                         lambda: tmesh.render_grad_replay_sharded(
                             sc, mesh, {key: sc.media.params},
                             lambda im: im.mean(), spp=spp, seed=SEED))
        _, g_ref, _ = lrt.render_grad(sc, {key: sc.media.params},
                                      lambda im: im.mean(), spp=spp,
                                      seed=SEED)
        grad_agree = _vec_agree(g[key], g_ref[key])
        # one SGD step (lr 1) of a loss linear in the image, against the
        # scan adjoint's gradient of the same fixed pass
        p0 = sc.media.params.detach().clone()
        leaf = p0.clone().requires_grad_()
        step = tmesh.make_train_step(sc, mesh, lambda im, t: (im - t).mean(),
                                     torch.optim.SGD([leaf], lr=1.0),
                                     spp=spp)
        run("make_train_step",
            lambda: step({key: leaf}, None,
                         torch.zeros(sc.film_h, sc.film_w, 3,
                                     device="cuda"), SEED))
        _, g_scan, _ = lrt.render_grad(sc, {key: p0}, lambda im: im.mean(),
                                       spp=spp, seed=SEED, replay=False)
        step_agree = _vec_agree(p0 - leaf.detach(), g_scan[key])
        counts = launch_counts(ci)
    finally:
        dist.destroy_process_group()
    film_bytes = sc.film_w * sc.film_h * 4 * 4
    param_bytes = p0.numel() * 4
    st = stats["make_train_step"].get("all-reduce", {"ops": 0, "bytes": 0})
    emit("sharded_small", film=[sc.film_w, sc.film_h], spp=spp,
         backend="nccl", world=1, agree=res, grad_cosine=grad_agree[0],
         grad_norm_rel=grad_agree[1], sgd_step_cosine=step_agree[0],
         sgd_step_norm_rel=step_agree[1], collectives=stats,
         film_bytes=film_bytes, param_bytes=param_bytes,
         launches=counts[0], merge_launches=counts[1])
    for name, (frac, mean_rel) in res.items():
        check(frac >= PIX_FRAC_MIN and mean_rel <= MEAN_RTOL,
              f"sharded_small: {name} disagrees with the unsharded render")
    check(grad_agree[0] >= GRAD_COS_MIN and grad_agree[1] <= GRAD_NORM_RTOL,
          "sharded_small: the sharded gradient disagrees with render_grad")
    check(step_agree[0] >= GRAD_COS_MIN and step_agree[1] <= GRAD_NORM_RTOL,
          "sharded_small: the SGD step disagrees with the scan adjoint")
    check(st["ops"] >= 2 and st["bytes"] >= film_bytes + param_bytes,
          f"sharded_small: the train step's collectives {stats}")
    check(counts[0] > 0, "sharded_small: no sweep launch")

    # ---- sharded_render: two ranks on the card over gloo, the main path
    torch.cuda.synchronize()
    reset_counts(ci)
    one = tmesh.make_mesh(1, device="cuda")
    t0 = time.perf_counter()
    acc1 = tmesh.render_regen_sharded(bumped, one, spp=SHARDED_SPP,
                                      seed=SEED)
    torch.cuda.synchronize()
    t_render1 = time.perf_counter() - t0
    c_render1 = launch_counts(ci)
    reset_counts(ci)
    t0 = time.perf_counter()
    loss1, g1, _ = tmesh.render_grad_replay_sharded(
        bumped, one, {"media.params": bumped.media.params},
        lambda im: im.mean(), spp=SHARDED_SPP, seed=SEED)
    torch.cuda.synchronize()
    t_grad1 = time.perf_counter() - t0
    c_grad1 = launch_counts(ci)

    script = os.path.join(workdir, "shard_worker.py")
    with open(script, "w") as f:
        f.write(_SHARD_WORKER)
    scene_pkl = os.path.join(workdir, "scene.pkl")
    with open(scene_pkl, "wb") as f:
        pickle.dump(main_d, f)
    repo = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="4")
    outs = [os.path.join(workdir, f"rank{r}.pt")
            for r in range(SHARDED_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(port), outs[r], repo,
         scene_pkl, *map(str, (SEED, SHARDED_SPP, SCALING_SPP,
                               SHARDED_RANKS))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=workdir) for r in range(SHARDED_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SHARDED_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"sharded_render: rank {r} failed "
              f"(exit {p.returncode}):\n{log[-3000:]}")
    ranks = [json.loads(next(ln for ln in log.splitlines()
                             if ln.startswith("SHARD_RESULT "))[13:])
             for log in logs]
    got = [torch.load(o) for o in outs]
    img1 = tfilm.develop(acc1).cpu().numpy()
    img_agree = [arrays_agree(np, tfilm.develop(x["acc"]).numpy(), img1)[:2]
                 for x in got]
    g_agree = [_vec_agree(x["grad"], g1["media.params"]) for x in got]
    loss_rel = [abs(x["loss"] - float(loss1)) / abs(float(loss1))
                for x in got]
    emit("sharded_render", film=[WIDTH, HEIGHT], spp=SHARDED_SPP,
         max_depth=bumped.max_depth, backend="gloo", ranks=SHARDED_RANKS,
         device="cuda:0 (both ranks)", card=smi, wall_seconds=wall,
         single_rank=dict(render_seconds=t_render1,
                          render_launches=c_render1[:2],
                          grad_seconds=t_grad1, grad_launches=c_grad1[:2]),
         per_rank=ranks, image_agree=img_agree, grad_agree=g_agree,
         loss_rel=loss_rel,
         scaling_note="both ranks share one card and its host: "
         "efficiency_proxy reads host overlap, not scaling")
    for r, ((frac, mean_rel), (cos, norm_rel)) in enumerate(
            zip(img_agree, g_agree)):
        check(frac >= PIX_FRAC_MIN and mean_rel <= MEAN_RTOL,
              f"sharded_render: rank {r}'s image disagrees with one rank's")
        check(cos >= GRAD_COS_MIN and norm_rel <= GRAD_NORM_RTOL,
              f"sharded_render: rank {r}'s gradient disagrees with one "
              "rank's")
    for x in ranks:
        check(x["render_launches"][0] > 0 and x["grad_launches"][0] > 0,
              f"sharded_render: rank {x['rank']} launched no sweep")
        check(x["grad_collectives"]["all-reduce"]["ops"] == 2,
              f"sharded_render: collectives {x['grad_collectives']}")
    sweeps = c_render1[0] + c_grad1[0] + sum(
        x["render_launches"][0] + x["grad_launches"][0] for x in ranks)
    merges = c_render1[1] + c_grad1[1] + sum(
        x["render_launches"][1] + x["grad_launches"][1] for x in ranks)
    return {"sharded_small": counts,
            "sharded_render": (sweeps, merges, 0, 0)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import numpy as np
        import liverrenderer_tpu_torch as lrt
        from liverrenderer_tpu_torch.accel import cuda_intersect as ci
        from liverrenderer_tpu_torch.integrators import prb_replay as treplay
        from liverrenderer_tpu_torch.scene.liver_proxy import \
            liver_proxy_dict
        _tests_module()
        _tests_module("torch_xml_files")
        _tests_module("torch_sss_inputs")
        _tests_module("torch_sensor_scenes")
        _tests_module("torch_pipeline_inputs")
    except (ImportError, FileNotFoundError) as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, peak_fp32_tflops=PEAK_FP32 / 1e12,
         peak_hbm_tb_s=PEAK_BYTES / 1e12,
         peak_source="NVIDIA H100 SXM data sheet, dense, at 700 W")

    # ---- 2. build
    ci.build_kernel()
    ptxas = [ln.strip() for ln in ci.BUILD_INFO["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(ci.BUILD_INFO["seconds"], 3), ptxas=ptxas)

    # ---- 3. kernels against their plain version
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    scene = lrt.load_dict(liver_proxy_dict(WIDTH, HEIGHT, SPP, SUBDIV, SEED))
    check(scene.device.type == "cuda", "load_dict did not build on the card")
    check(scene.n_tris == 5120, f"proxy has {scene.n_tris} triangles")
    rays = proxy_rays(torch, scene, 32768, 32768, gen)
    res_a, _, _ = kernel_vs_plain(torch, ci, rays, scene.tri_buf,
                                  scene.tri_boxes, scene.n_tris,
                                  reps_plain=5)
    emit("kernel_vs_plain", regime="K1 liver proxy", tris=scene.n_tris,
         card=smi, **res_a)
    check_agreement(res_a, "liver proxy")

    rays_b, tris_b, boxes_b, T = k2_inputs(np, torch, ci)
    res_b, _, _ = kernel_vs_plain(torch, ci, rays_b, tris_b, boxes_b, T,
                                  reps_plain=3)
    emit("kernel_vs_plain", regime="K2 ~100k triangles", tris=T,
         tpad=int(tris_b.shape[0]), card=smi, **res_b)
    check_agreement(res_b, "100k triangles")
    check(res_b["hits"] > rays_b.shape[1] // 4,
          f"100k cloud: only {res_b['hits']} hits")

    rays_c, tris_c, boxes_c, expected = tie_regime_inputs(torch, ci)
    res_c, pk, pr = kernel_vs_plain(torch, ci, rays_c, tris_c, boxes_c,
                                    TIE_T, reps_plain=3)
    res_c["winners_as_rule"] = float((pk == expected).float().mean())
    emit("kernel_vs_plain", regime="ties", tris=TIE_T, card=smi, **res_c)
    check_agreement(res_c, "ties")
    check(res_c["splits"] > 1, "ties: the chunk range was not split")
    check(bool(torch.equal(pr, expected)), "ties: plain version off the rule")
    check(bool(torch.equal(pk, expected)), "ties: kernel off the tie rule")

    # ---- 3b. the merge alone, on the K1 regime's per-split partials
    splits, per = res_a["splits"], res_a["chunks_per_split"]
    check(splits > 1, "K1 regime: the chunk range was not split")
    parts = [ci.intersect_closest_reference(
        rays, scene.tri_buf[c * 128:(c + per) * 128],
        scene.tri_boxes[c:c + per])
        for c in range(0, scene.tri_boxes.shape[0], per)]
    t_part = torch.stack([x[0] for x in parts]).contiguous()
    p_part = torch.stack([x[1] for x in parts]).contiguous()
    tm, pm = ci.merge_partials(t_part, p_part)
    tr, pr = ci.merge_partials_reference(t_part, p_part)
    torch.cuda.synchronize()
    fin = torch.isfinite(tr)
    merge = dict(
        splits=splits, n_rays=int(t_part.shape[1]),
        equal=bool(torch.equal(tm, tr) and torch.equal(pm, pr)),
        max_abs_err=float((tm - tr)[fin].abs().max()) if fin.any() else 0.0,
        ms=cuda_ms(lambda: ci.merge_partials(t_part, p_part), 7, 10),
        plain_ms=cuda_ms(lambda: ci.merge_partials_reference(t_part, p_part),
                         7, 10),
        # two PyTorch calls compute the merge: min over the splits with its
        # index, then a gather of the prims (their tie rule may differ, so
        # this times them only)
        library_ms=cuda_ms(lambda: merge_library(torch, t_part, p_part), 7,
                           10),
        # t of every split read, the winner's prim read, t and prim written
        bytes=4 * t_part.numel() + 12 * t_part.shape[1])
    merge["bound_ms"] = merge["bytes"] / PEAK_BYTES * 1e3
    emit("merge_vs_plain", card=smi, **merge)
    check(merge["equal"], "merge kernel differs from its plain version")

    # ---- 4a. the render through the kernels against the CPU render
    small = liver_proxy_dict(16, 12, 4, 2, SEED)
    img_cpu = lrt.render(lrt.load_dict(small, device="cpu"), spp=4,
                         seed=SEED).numpy()
    img_gpu = lrt.render(lrt.load_dict(small), spp=4,
                         seed=SEED).cpu().numpy()
    close = np.abs(img_gpu - img_cpu) <= PIX_ATOL + PIX_RTOL \
        * np.abs(img_cpu)
    frac = float(close.all(-1).mean())
    mean_rel = float(abs(img_gpu.mean() - img_cpu.mean())
                     / abs(img_cpu.mean()))
    emit("render_small", film=[16, 12], spp=4, tris=320, pixel_frac=frac,
         mean_rel=mean_rel, mean=float(img_gpu.mean()))
    check(frac >= PIX_FRAC_MIN and mean_rel <= MEAN_RTOL,
          "GPU render disagrees with the CPU render")

    # ---- 4b. the main path at full width
    torch.cuda.synchronize()
    reset_counts(ci)
    t0 = time.perf_counter()
    img = lrt.render(scene, spp=SPP, seed=SEED)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches, merge_launches = ci.LAUNCHES, ci.MERGE_LAUNCHES
    check(ci.SHADOW_LAUNCHES == 0, "the liver render made shadow queries")
    finite = bool(torch.isfinite(img).all())
    paths = WIDTH * HEIGHT * SPP
    emit("render", film=[WIDTH, HEIGHT], spp=SPP, max_depth=scene.max_depth,
         tris=scene.n_tris, wavefront=1 << 16, seconds=round(secs, 3),
         paths_per_s=paths / secs, finite=finite,
         shape=list(img.shape), mean=float(img.mean()),
         corner=[float(x) for x in img[0, 0]], launches=launches,
         merge_launches=merge_launches)
    check(tuple(img.shape) == (HEIGHT, WIDTH, 3), "image shape")
    check(finite, "image has non-finite values")
    check(launches > 0, "the render did not launch the sweep kernel")
    check(merge_launches > 0, "the render did not launch the merge kernel")
    # the corner sees the constant white environment directly
    check(bool(torch.allclose(img[0, 0], torch.ones(3, device="cuda"))),
          "corner pixel is not the environment")
    check(0.05 < float(img.mean()) < 1.0, "image mean out of range")

    # ---- 4c. the kernels on the main path's own rays
    secs_k, calls = capture_render(torch, lrt, ci, scene, KERNEL_SPP)
    inline_ms = sum(c[0] for c in calls)
    check(len(calls) > 0, "render_kernel: no intersect_closest call")

    def replay():
        for _, r, t, bx in calls:
            ci.intersect_closest(r, t, bx)

    replay_ms = cuda_ms(replay, reps=3, inner=1) / len(calls)
    agree = dict(n_rays=0, hits=0, hit_same=0, both=0, prim_same=0,
                 max_rel_dt=0.0, short_kernel=0, short_plain=0, needed=0,
                 candidates=0, dense=0)
    for _, r, t, bx in calls:
        tk, pk = ci.intersect_closest(r, t, bx)
        tr, pr = ci.intersect_closest_reference(r, t, bx)
        c = compare_hits(tk, pk, tr, pr)
        agree["n_rays"] += c["n_rays"]
        agree["hits"] += c["hits"]
        agree["hit_same"] += int(((pk >= 0) == (pr >= 0)).sum())
        both = int(((pk >= 0) & (pr >= 0)).sum())
        agree["both"] += both
        agree["prim_same"] += int(((pk == pr) & (pr >= 0)).sum())
        agree["max_rel_dt"] = max(agree["max_rel_dt"], c["max_rel_dt"])
        agree["short_kernel"] += int(((pk >= 0) & (tk < SHORT_T)).sum())
        agree["short_plain"] += int(((pr >= 0) & (tr < SHORT_T)).sum())
        need, cand = needed_work(torch, r, t, bx, scene.n_tris, tr)
        agree["needed"] += need
        agree["candidates"] += cand
        agree["dense"] += r.shape[1] * scene.n_tris
    hit_agree = agree["hit_same"] / agree["n_rays"]
    prim_agree = agree["prim_same"] / max(agree["both"], 1)
    b_need = roofline(agree["needed"], agree["candidates"], 0)[
        "bound_needed_ms"] / len(calls)
    b_dense = agree["dense"] * FLOP_PER_TEST / PEAK_FP32 * 1e3 / len(calls)
    emit("render_kernel", film=[WIDTH, HEIGHT], spp=KERNEL_SPP,
         max_depth=scene.max_depth, card=smi, seconds=secs_k,
         launches=len(calls), kernel_ms_total=inline_ms,
         ms_per_launch=inline_ms / len(calls),
         wall_share=inline_ms / (secs_k * 1e3),
         replay_ms_per_launch=replay_ms,
         bound_dense_ms=b_dense, bound_needed_ms=b_need,
         needed_tests_per_launch=agree["needed"] / len(calls),
         candidate_tests_per_launch=agree["candidates"] / len(calls),
         share=b_need / replay_ms, n_rays=agree["n_rays"],
         hits=agree["hits"], hit_agree=hit_agree, prim_agree=prim_agree,
         max_rel_dt=agree["max_rel_dt"], short_hits_kernel=agree[
             "short_kernel"], short_hits_plain=agree["short_plain"])
    check_agreement(dict(hit_agree=hit_agree, prim_agree=prim_agree,
                         max_rel_dt=agree["max_rel_dt"]), "render rays")

    # ---- 5a. gradients through the kernels against the CPU gradient
    sc_cpu = lrt.load_dict(small, device="cpu")
    g_cpu = lrt.render_grad(
        sc_cpu, {"media.params": sc_cpu.media.params}, lambda im: im.mean(),
        spp=4, seed=SEED)[1]["media.params"]
    _, g_gpu, _, counts = grad_run(torch, lrt, ci, treplay,
                                   lrt.load_dict(small), 4)
    a, b = g_gpu.cpu().double(), g_cpu.double()
    cos = float((a * b).sum() / (a.norm() * b.norm()))
    norm_rel = abs(float(a.norm() / b.norm()) - 1.0)
    emit("grad_small", film=[16, 12], spp=4, tris=320, cosine=cos,
         norm_rel=norm_rel, max_abs_diff=float((a - b).abs().max()),
         grad_norm=float(b.norm()), **counts)
    check(bool(torch.isfinite(a).all()) and float(b.norm()) > 0,
          "grad_small: gradient not finite or zero")
    check(cos >= GRAD_COS_MIN and norm_rel <= GRAD_NORM_RTOL,
          "GPU gradient disagrees with the CPU gradient")
    check(counts["replay_launches"] > 0,
          "grad_small: the replay walk did not launch the sweep kernel")

    # ---- 5b. the gradient path at full width (bench.py's render_grad):
    # a warm-up and one timed run, held to each other (a median of 3 after
    # the warm-up before PR 17's cuts for the script's time)
    runs = [grad_run(torch, lrt, ci, treplay, scene, GRAD_SPP)]  # warm-up
    torch.cuda.reset_peak_memory_stats()
    runs.append(grad_run(torch, lrt, ci, treplay, scene, GRAD_SPP))
    peak = torch.cuda.max_memory_allocated()
    grad_counts = runs[0][3]
    check(all(r[3] == grad_counts for r in runs),
          f"launch counts differ between reps: {[r[3] for r in runs]}")
    g = runs[0][1]
    check(all(bool(torch.equal(r[1], g)) or
              float((r[1] - g).abs().max()) <= 1e-4 * float(g.abs().max())
              for r in runs), "gradient differs between reps")
    primal = [timed_render(torch, lrt, scene, GRAD_SPP)[0]]
    t_grad = runs[1][0]
    t_primal = primal[0]
    grad_paths = WIDTH * HEIGHT * GRAD_SPP
    finite_g = bool(torch.isfinite(g).all())
    emit("render_grad", film=[WIDTH, HEIGHT], spp=GRAD_SPP,
         max_depth=scene.max_depth, tris=scene.n_tris, card=smi,
         seconds=t_grad, seconds_reps=[r[0] for r in runs],
         fwd_bwd_paths_per_s=grad_paths / t_grad,
         primal_seconds=t_primal, primal_seconds_reps=primal,
         primal_paths_per_s=grad_paths / t_primal,
         fwd_bwd_over_primal=t_grad / t_primal,
         grad_finite=finite_g, grad_abs_max=float(g.abs().max()),
         grad_nonzero=int((g != 0).sum()),
         image_mean=float(runs[0][2].mean()),
         max_memory_allocated=peak, **grad_counts)
    check(finite_g and float(g.abs().max()) > 0,
          "render_grad: gradient not finite or zero")
    for k in ("fwd_launches", "fwd_merge_launches", "replay_launches",
              "replay_merge_launches"):
        check(grad_counts[k] > 0, f"render_grad: {k} is 0")

    # ---- 5c. where the gradient's time goes
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        secs_t, _, _, counts_t = grad_run(torch, lrt, ci, treplay, scene,
                                          TRACE_SPP)
    # one sweep launch per bounce: the launch counts are the iterations
    emit("render_grad_trace", film=[WIDTH, HEIGHT], spp=TRACE_SPP,
         card=smi, **trace_summary(prof, secs_t,
                                   (counts_t["fwd_launches"],
                                    counts_t["replay_launches"])))

    # ---- 6. next-event estimation: the fog Cornell box and the walk
    nee = nee_phases(torch, np, lrt, ci, treplay, smi, scene, gen)
    fog_counts, fog_grad_counts = nee["fog_counts"], nee["fog_grad_counts"]
    sh, sh_liver = nee["shadow"], nee["liver_shadow"]

    # ---- 7. bump mapping and the envmap: bench.py's workload path
    bump = bump_env_phases(torch, np, lrt, ci, treplay, smi, scene)
    bump_counts, bump_grad = bump["counts"], bump["grad_counts"]

    # ---- 8. the surface path family: BASELINE's Cornell box
    cb = cornell_phases(torch, np, lrt, ci, treplay, smi)
    cb_grads = cb["grads"]
    cb_launches = cb["fixed"][0] + cb["regen"][0] + sum(
        g["fwd_launches"] + g["replay_launches"] for g in cb_grads.values())
    cb_merge = cb["fixed"][1] + cb["regen"][1] + sum(
        g["fwd_merge_launches"] + g["replay_merge_launches"]
        for g in cb_grads.values())

    # ---- 9. the scene loader: bench.py's workload path from files;
    # ---- 10. the other lights, the pattern samplers and the filters
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        xml = xml_phases(torch, np, lrt, ci, treplay, smi, workdir)
        emitter_sampler_phases(torch, np, lrt, smi, workdir)
    xml_counts, xml_grad = xml["counts"], xml["grad_counts"]

    # ---- 11. the stock media: grids, extended phases, volpathmis, and the
    # lockstep BVH past 2^21 triangles
    med = media_phases(torch, np, lrt, ci, treplay, smi)

    # ---- 12. subsurface scattering: the vaescatter liver proxy, the
    # dipole, their gradient and the event's queries
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sss_") as workdir:
        sss = sss_phases(torch, np, lrt, ci, treplay, smi, workdir)

    # ---- 13. the command-line renderer with the PIZ sky, RenderControl,
    # the other sensors
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as workdir:
        cli = cli_phases(torch, np, lrt, ci, smi, workdir)

    # ---- 14. the fork's liver pipeline: the driver, evaluate with its
    # denoise probe, the denoiser, the inverse-rendering loop, LargeSteps
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pipe_") as workdir:
        pipe = pipeline_phases(torch, np, lrt, ci, smi, workdir)
    pipe_sweeps = sum(c[0] for c in pipe.values())
    pipe_merges = sum(c[1] for c in pipe.values())

    # ---- 15. the spectral variant: the main path, its gradient and the
    # binned spectral film
    spc = spectral_phases(torch, np, lrt, ci, treplay, smi)
    spc_grad = spc["grad_counts"]

    # ---- 16. the light tracer, polarized transport (RGB and spectral)
    # and the splat radiance field at K2's size
    m10 = m10_phases(torch, np, lrt, ci, smi)
    m10_sweeps = sum(c[0] for c in m10.values())
    m10_merges = sum(c[1] for c in m10.values())

    # ---- 17. shape gradients: the vertices key, the boundary terms and
    # their guiding, LargeSteps;  18. the principled, principledthin and
    # measured BSDFs
    shape = shape_phases(torch, np, lrt, ci, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bsdf_") as workdir:
        prin = principled_phases(torch, np, lrt, ci, smi, workdir)
    s15 = {**{f"shape_{k}": c for k, c in shape.items()},
           **{f"principled_{k}": c for k, c in prin.items()}}
    s15_sweeps = sum(c[0] for c in s15.values())
    s15_merges = sum(c[1] for c in s15.values())

    # ---- 19. the rest of M10: the sunsky, mesh-attribute and volume
    # textures, instancing, SDF grids, curves with the hair BSDF
    with tempfile.TemporaryDirectory(prefix="chip_smoke_m10b_") as workdir:
        m10b, hair_k2 = m10b_phases(torch, np, lrt, ci, treplay, smi,
                                    workdir)
    m10b_sweeps = sum(c[0] for c in m10b.values())
    m10b_merges = sum(c[1] for c in m10b.values())

    # ---- 20. the apps: the progressive viewer and the interactive loop;
    # ---- 21. multi-GPU: the sharded renders, gradient and training step
    from liverrenderer_tpu_torch.scene.liver_proxy import BUMP, SKY
    with _log_at_warn():
        apps = apps_phases(torch, np, lrt, ci, smi, bump["scene"],
                           bump["image"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as workdir:
        shard = sharded_phases(
            torch, np, lrt, ci, smi, workdir,
            liver_proxy_dict(16, 12, SHARDED_SMALL_SPP, 2, SEED,
                             bump=BUMP_SMALL, sky=SKY_SMALL),
            liver_proxy_dict(WIDTH, HEIGHT, SPP, SUBDIV, SEED, bump=BUMP,
                             sky=SKY), bump["scene"])
    del bump["scene"], bump["image"]
    s17 = {**apps, **shard}
    s17_sweeps = sum(c[0] for c in s17.values())
    s17_merges = sum(c[1] for c in s17.values())

    # ---- 22. the rest of the loader (M9): the DWAA sky and the JPEG
    # height map on the main path, the C++ OBJ reader
    with tempfile.TemporaryDirectory(prefix="chip_smoke_m9_") as workdir:
        m9 = m9_phases(torch, np, lrt, ci, smi, workdir)
    m9_sweeps = sum(c[0] for c in m9.values())
    m9_merges = sum(c[1] for c in m9.values())

    # ---- 23. the raster formats Pillow opens: TIFF and GIF on the main
    # path, the TIFF and QOI writers
    with tempfile.TemporaryDirectory(prefix="chip_smoke_m9b_") as workdir:
        m9b = m9b_phases(torch, np, lrt, ci, smi, workdir)
    m9_sweeps += sum(c[0] for c in m9b.values())
    m9_merges += sum(c[1] for c in m9b.values())

    # ---- 24. WebP and the BCn family (DDS): the lossy WebP height map and
    # a BC7 floor on the main path, the DDS writer
    with tempfile.TemporaryDirectory(prefix="chip_smoke_m9c_") as workdir:
        m9c = m9c_phases(torch, np, lrt, ci, smi, workdir)
    m9_sweeps += sum(c[0] for c in m9c.values())
    m9_merges += sum(c[1] for c in m9c.values())

    # ---- 25. the JPEG kinds and JPEG-in-TIFF: an arithmetic-coded height
    # map and a YCbCr JPEG-in-TIFF floor on the main path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_m9d_") as workdir:
        m9d = m9d_phases(torch, np, lrt, ci, smi, workdir)
    m9_sweeps += sum(c[0] for c in m9d.values())
    m9_merges += sum(c[1] for c in m9d.values())

    # ---- 26. the rest of TIFF: a ZSTD height map and a Group 4 fax floor
    # on the main path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_m9e_") as workdir:
        m9e = m9e_phases(torch, np, lrt, ci, smi, workdir)
    m9_sweeps += sum(c[0] for c in m9e.values())
    m9_merges += sum(c[1] for c in m9e.values())
    emit("total", seconds=time.perf_counter() - _T0)

    # ---- 12. kernels
    src = "liverrenderer_tpu_torch/csrc/intersect.cu"
    print(json.dumps({"kernels": [
        # ms: the sweep kernel alone (K1 shape); sweep_merge_ms: the whole
        # query, which the merge row's kernel completes; plain_ms: the plain
        # version of the whole query
        dict(name="intersect_sweep", route="cuda", source=src,
             replaces="liverrenderer_tpu/accel/pallas_intersect.py:101",
             also_replaces="liverrenderer_tpu/accel/pallas_intersect.py:152",
             tpu_kernels=["K1 _intersect_kernel",
                          "K2 _intersect_stream_kernel"],
             launches=launches + grad_counts["fwd_launches"]
             + grad_counts["replay_launches"] + fog_counts[0]
             + fog_grad_counts["fwd_launches"]
             + fog_grad_counts["replay_launches"] + bump_counts[0]
             + bump_grad["fwd_launches"] + bump_grad["replay_launches"]
             + cb_launches + xml_counts[0] + xml_grad["fwd_launches"]
             + xml_grad["replay_launches"] + med["grid_counts"][0]
             + med["grid_grad"]["fwd_launches"]
             + med["grid_grad"]["replay_launches"] + med["mis_counts"][0]
             + med["vp_counts"][0] + sss["counts"][0]
             + sss["plain_counts"][0] + sss["dipole_counts"][0]
             + sss["grad_counts"]["fwd_launches"] + cli["counts"][0]
             + cli["control"][0] + cli["plain"][0] + cli["thinlens"][0]
             + pipe_sweeps + spc["counts"][0] + spc_grad["fwd_launches"]
             + spc_grad["replay_launches"] + spc["film"][0]
             + spc["box"][0] + m10_sweeps + s15_sweeps + m10b_sweeps
             + s17_sweeps + m9_sweeps,
             render_launches=launches,
             render_grad_launches=grad_counts,
             fog_render_launches=split_counts(fog_counts),
             fog_render_grad_launches=fog_grad_counts,
             bump_env_render_launches=bump_counts[0],
             bump_env_render_grad_launches=bump_grad,
             cornell_render_launches=split_counts(cb["fixed"]),
             cornell_regen_render_launches=split_counts(cb["regen"]),
             cornell_render_grad_launches={
                 k: {c: v[c] for c in v if c.endswith("launches")}
                 for k, v in cb_grads.items()},
             xml_render_launches=xml_counts[0],
             xml_render_grad_launches=xml_grad,
             grid_render_launches=split_counts(med["grid_counts"]),
             grid_render_grad_launches=med["grid_grad"],
             volpathmis_render_launches=split_counts(med["mis_counts"]),
             volpath_chroma_render_launches=split_counts(med["vp_counts"]),
             sss_render_launches=split_counts(sss["counts"]),
             sss_plain_render_launches=split_counts(sss["plain_counts"]),
             dipole_render_launches=split_counts(sss["dipole_counts"]),
             sss_render_grad_launches=sss["grad_counts"],
             cli_render_launches=split_counts(cli["counts"]),
             render_control_launches=split_counts(cli["control"]),
             render_control_plain_launches=split_counts(cli["plain"]),
             thinlens_render_launches=split_counts(cli["thinlens"]),
             pipeline_render_launches=split_counts(pipe["pipeline"]),
             evaluate_render_launches=split_counts(pipe["evaluate"]),
             evaluate_sss_launches=split_counts(pipe["evaluate_sss"]),
             inverse_render_launches=split_counts(pipe["inverse"]),
             spectral_render_launches=spc["counts"][0],
             spectral_render_grad_launches=spc_grad,
             specfilm_launches=split_counts(spc["film"]),
             spectral_cornell_render_launches=split_counts(spc["box"]),
             m10_launches={k: split_counts(c) for k, c in m10.items()},
             shape_principled_launches={k: split_counts(c)
                                        for k, c in s15.items()},
             m10b_launches={k: split_counts(c) for k, c in m10b.items()},
             apps_sharded_launches={k: split_counts(c)
                                    for k, c in s17.items()},
             m9_launches={k: split_counts(c) for k, c in m9.items()},
             m9b_launches={k: split_counts(c) for k, c in m9b.items()},
             m9c_launches={k: split_counts(c) for k, c in m9c.items()},
             m9d_launches={k: split_counts(c) for k, c in m9d.items()},
             m9e_launches={k: split_counts(c) for k, c in m9e.items()},
             hair_k2_ms=hair_k2["ms"], hair_k2_bound_ms=hair_k2["bound_ms"],
             hair_k2_share=hair_k2["share"], hair_k2_tris=hair_k2["tris"],
             hair_k2_sweep_ms=hair_k2["sweep_ms"],
             hair_k2_plain_ms=hair_k2["plain_ms"],
             sss_event_ms={g: v["ms"] for g, v in sss["kernel"].items()},
             sss_event_bound_ms={g: v["bound_ms"]
                                 for g, v in sss["kernel"].items()},
             sss_event_hit_agree={g: v["hit_agree"]
                                  for g, v in sss["kernel"].items()},
             wide_ms=cb["wide"]["camera"]["ms"],
             wide_plain_ms=cb["wide"]["camera"]["plain_ms"],
             wide_bound_ms=cb["wide"]["camera"]["bound_ms"],
             wide_bound_by=cb["wide"]["camera"]["bound_by"],
             wide_share=cb["wide"]["camera"]["share"],
             wide_shadow_ms=cb["wide"]["shadow"]["ms"],
             wide_shadow_bound_ms=cb["wide"]["shadow"]["bound_ms"],
             wide_shadow_share=cb["wide"]["shadow"]["share"],
             shadow_ms=sh["replay_ms_per_launch"],
             shadow_plain_ms=sh["plain_ms_per_launch"],
             shadow_bound_ms=sh["bound_ms"], shadow_bound_by=sh["bound_by"],
             shadow_hit_agree=sh["hit_agree"],
             liver_shadow_ms=sh_liver["replay_ms_per_launch"],
             liver_shadow_hit_agree=sh_liver["hit_agree"],
             max_abs_err=res_a["max_abs_dt"],
             ms=res_a["sweep_ms"], plain_ms=res_a["plain_ms"],
             bound_ms=res_a["sweep_bound_ms"],
             bound_by=res_a["sweep_bound_by"], library_ms=None,
             share=res_a["sweep_share"], sweep_merge_ms=res_a["ms"],
             hit_agree=res_a["hit_agree"], prim_agree=res_a["prim_agree"],
             k2_max_abs_err=res_b["max_abs_dt"], k2_ms=res_b["sweep_ms"],
             k2_sweep_merge_ms=res_b["ms"], k2_plain_ms=res_b["plain_ms"],
             k2_bound_ms=res_b["sweep_bound_ms"],
             k2_share=res_b["sweep_share"], k2_hit_agree=res_b["hit_agree"],
             k2_prim_agree=res_b["prim_agree"], ties_ms=res_c["sweep_ms"],
             ties_winners_as_rule=res_c["winners_as_rule"]),
        dict(name="intersect_merge", route="cuda", source=src,
             replaces="liverrenderer_tpu/accel/pallas_intersect.py:152",
             tpu_kernels=["K2 _intersect_stream_kernel (accumulation "
                          "across its sequential grid axis)"],
             launches=merge_launches + grad_counts["fwd_merge_launches"]
             + grad_counts["replay_merge_launches"] + fog_counts[1]
             + fog_grad_counts["fwd_merge_launches"]
             + fog_grad_counts["replay_merge_launches"] + bump_counts[1]
             + bump_grad["fwd_merge_launches"]
             + bump_grad["replay_merge_launches"] + cb_merge
             + xml_counts[1] + xml_grad["fwd_merge_launches"]
             + xml_grad["replay_merge_launches"] + med["grid_counts"][1]
             + med["grid_grad"]["fwd_merge_launches"]
             + med["grid_grad"]["replay_merge_launches"]
             + med["mis_counts"][1] + med["vp_counts"][1]
             + sss["counts"][1] + sss["plain_counts"][1]
             + sss["dipole_counts"][1]
             + sss["grad_counts"]["fwd_merge_launches"]
             + cli["counts"][1] + cli["control"][1] + cli["plain"][1]
             + cli["thinlens"][1] + pipe_merges + spc["counts"][1]
             + spc_grad["fwd_merge_launches"]
             + spc_grad["replay_merge_launches"] + spc["film"][1]
             + spc["box"][1] + m10_merges + s15_merges + m10b_merges
             + s17_merges + m9_merges,
             render_launches=merge_launches,
             bump_env_render_launches=bump_counts[1],
             xml_render_launches=xml_counts[1],
             sss_render_launches=sss["counts"][1],
             cli_render_launches=cli["counts"][1],
             thinlens_render_launches=cli["thinlens"][1],
             pipeline_render_launches=pipe["pipeline"][1],
             evaluate_render_launches=pipe["evaluate"][1],
             evaluate_sss_launches=pipe["evaluate_sss"][1],
             inverse_render_launches=pipe["inverse"][1],
             spectral_render_launches=spc["counts"][1],
             volprim_render_launches=m10["volprim"][1],
             volprim_render_grad_launches=m10["volprim_grad"][1],
             shape_grad_launches=shape["shape_grad"][1],
             shape_optimize_launches=shape["shape_optimize"][1],
             m10b_launches={k: c[1] for k, c in m10b.items()},
             apps_sharded_launches={k: c[1] for k, c in s17.items()},
             m9_launches={k: c[1] for k, c in m9.items()},
             m9b_launches={k: c[1] for k, c in m9b.items()},
             m9c_launches={k: c[1] for k, c in m9c.items()},
             m9d_launches={k: c[1] for k, c in m9d.items()},
             m9e_launches={k: c[1] for k, c in m9e.items()},
             # the fog box's 36 triangles fill one chunk: one split, no
             # merge; the liver proxy's shadow rays run it
             fog_render_launches=fog_counts[1],
             max_abs_err=merge["max_abs_err"],
             ms=merge["ms"], plain_ms=merge["plain_ms"],
             bound_ms=merge["bound_ms"], bound_by="bytes",
             library_ms=merge["library_ms"],
             library_call="torch.min(t, dim=0) + torch.gather of the prims "
             "(time only: its tie rule may differ)")]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
