#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card and check them.

Run from the root of a checkout:  python3 chip_smoke.py [--profile]

The main paths are the headline problem of the repository, single-channel
2-D ConvBPDN on a 512x512 image with 64 filters of 8x8, lmbda = 0.05
(``bench.py``'s problem), solved three ways:

- by ADMM to relative residual 1e-3, through
  ``sporco_tpu_torch.models.cbpdn.ConvBPDN`` on the fused driver and its
  hand-written CUDA kernel ``csc_iter``;
- by FISTA at ``bench.py``'s PGM configuration (L = 100, 250 iterations,
  no stopping tolerance), through ``sporco_tpu_torch.models.pgm.ConvBPDN``
  on the fused packed problem and its hand-written CUDA kernel
  ``pgm_iter``;
- on the generic FFT path (``fused=False``): ADMM to 1e-3 and FISTA at
  L = 100, masked and not, whose 2-D transforms run the hand-written CUDA
  kernels ``rfft2_planar``/``irfft2_planar``;
- and its variants on the fused driver: gradient-regularised CSC
  (``ConvBPDNGradReg``, the last filter an impulse whose map carries the
  smooth part, as ``examples/csc_gradreg.py``) through the fused
  driver's ``body``, its per-bin x-step on the FFT kernels and the
  hand-written CUDA kernel ``admm_tail``; the elastic net
  (``ConvElasticNet``) through ``csc_iter``; and ``l1`` with a spatially
  varying ``L1Weight`` through ``body`` with the tail as torch ops;
- and colour CSC on a 512x512x3 image (three channels of the headline's
  smoothed noise): a colour dictionary of 64 filters of 8x8x3 (the
  shape of the dictionary pack's ``RGB:8x8x3x64``), whose fused solves
  run ``csc_iter``/``pgm_iter`` at 768 taps after the rank-3 x-step's
  glue, and the headline dictionary on the colour image (``dimK=0``),
  whose fused solves fold the three channels into the batch (12288
  packed rows);
- masked CSC by Additive Mask Simulation through the accelerator API
  (``accel.cbpdnmsk``, ``accel.cbpdngrdmsk``): the fused driver's ``body``
  with the AMS form of ``admm_tail``, and the generic path;
- the opt-in "mixed" matmul precision of the fused drivers, whose
  kernels then compute their forward product R1 as one bf16 product;
- and convolutional dictionary learning at ``bench.py``'s
  ``_bench_cdlcns`` size (BASELINE configuration 5: 40 images of
  128x128, 32 filters of 8x8, lmbda = 0.1): the consensus loop
  ``sporco_tpu_torch.parallel.consensus.ConvBPDNDictLearn_Consensus``,
  whose kernel stage runs ``csc_iter`` without its forward pair
  (``emit_fwd=False``) at (pos, C, T) = (10240, 2048, 256) once an outer
  iteration and whose transforms run ``rfft2_planar``/``irfft2_planar``
  at 128x128, and ``ConvBPDNDictLearn`` on the fused ADMM x-step, and
  on the fused FISTA x-step with the FISTA dictionary update;
- and BASELINE configurations 1-3 at their full size (``bench.py``'s
  ``_bench_bpdn``, ``_bench_bpdn_batch``, ``_bench_tvl2`` and
  ``_bench_rpca``): the dense BPDN models of ``models/bpdn.py`` on a
  512x512 dictionary (K = 1 and 256 signals), whose x-step is two
  products with a Gram eigendecomposition made once; the four TV models,
  denoising at 256x256 and deconvolution at 512x512
  (``examples/tv_deconv.py``'s problem), whose deconvolution x-step runs
  its 2-D transforms of X on ``rfft2_planar``/``irfft2_planar``; Robust
  PCA at 512x512 with the randomized and the full SVD; and the generic
  ``DictLearn`` alternation over port models on the card;
- and masked, online and patch dictionary learning: the two-block CSC
  models ``ConvBPDNMaskDcpl`` (the masked headline), ``ConvL1L1Grd``
  (``examples/csc_impulse_denoise.py``'s configuration on the headline
  image with salt-and-pepper noise) and ``ConvMinL1InL2Ball``
  (``examples/csc_minl1.py``'s on the headline image with Gaussian
  noise), whose transforms run ``rfft2_planar``/``irfft2_planar``;
  ``ConvBPDNMaskDictLearn`` at the consensus geometry with the masked
  dictionary updates of ``models/ccmodmd.py`` and the FISTA pair (its
  masked x-step on ``pgm_iter``); online CDL over five 512x512 samples,
  whose plain x-step runs the fused driver and ``csc_iter``; and the
  dense FISTA models and the learners on vectors (``BPDNDictLearn``,
  ``WeightedBPDNDictLearn``) on every 8x8 patch of a 256x256 image;
- and the rest of the CSC models, each on its example's problem at
  512x512 with the headline's filters: ``ConvBPDNJoint`` on a colour
  image, ``ConvBPDNProjL1`` on ``S = D * X0``, ``MultiDictConvBPDN`` over
  the headline and its 3x3-blurred view (two 64-filter dictionaries, a
  colour dictionary with C = 2 on the fused driver and ``csc_iter``),
  ``ConvBPDNInhib`` with 8 groups of 8 filters, the three CSC-TV models,
  the four product-dictionary models on a colour image (``B`` the PCA
  of its pixels or the channel DCT), ``PPP``, ``PPPConsensus`` and
  ``PPPPGM`` on ``tv_example``'s blurred square with a Tikhonov prior
  written with ``ops.fft`` (and ``host_prior`` once) and ``SplineL1``
  through outliers: every 2-D float32 transform of theirs runs
  ``rfft2_planar``/``irfft2_planar``.

Phases, each printing one JSON line on stdout:

1. ``device``: the card's name and power limit, torch and CUDA versions,
   and ``accel.device_name()`` and ``accel.memory_info()``;
2. ``build``: the kernels' nvcc builds, one process per source, all
   started together (seconds, ptxas report); for ``csc_iter`` and
   ``pgm_iter`` their SASS by kernel (``cuobjdump``): it fails if ptxas
   reports a stack frame or spill, or if the forward pass has no HGMMA;
3. ``kernel``: ``csc_iter`` against its plain PyTorch version on the card
   at the headline geometry over the flag grid (with each output's error
   against a float64 run beside it), two launches bit for bit alike, the
   adjoint's A bit for bit cuBLAS's, kernel and plain version timed, the
   kernel also by pass (``torch.profiler``);
4. ``parity``: 10 ADMM iterations of the headline problem on the card
   against the port on the CPU (plain version), stats row by row;
5. ``solve``: the ADMM headline solve through ``ConvBPDN.solve()`` at FFT
   precision "high" (``bench.py``'s, the glue on ``torch.fft``); the
   ``csc_iter`` launch count must equal the iterations run;
6. ``pgm_kernel``: ``pgm_iter`` likewise, over its flag grid;
7. ``pgm_parity``: 10 FISTA iterations on the card against the CPU,
   unmasked and with about 30% of the pixels masked out;
8. ``pgm_solve``: the FISTA solve at precision "high"; the ``pgm_iter``
   launch count must equal the iterations run;
9. ``fft_kernel``: ``rfft2_planar``/``irfft2_planar`` against their plain
   versions and ``torch.fft`` at the x-step's 64 planes of 512x512, at
   one plane, and at ragged shapes covering each branch (the inverse
   also on a non-Hermitian spectrum); kernel, plain version and cuFFT
   timed at 64 planes and at one (``vs_library``: kernel ms over cuFFT
   ms), and so is the dispatch ``ops.fft.irfftn`` on a complex64
   spectrum (``irfft2_spectrum``, which must equal the planar call bit
   for bit at every shape); at 64 planes the device time of each
   kernel's row and column pass and their shares, and the kernels the
   dispatch runs, from ``torch.profiler``;
10. ``generic_parity``: 10 iterations of ``ConvBPDN(fused=False)`` on the
    card against the CPU (the FFT kernels' plain versions);
11. ``generic_solve``: ``ConvBPDN(fused=False)`` to 1e-3, its objective
    against the fused solve's, one ``rfft2_planar`` per iteration and
    two in the setup, one ``irfft2_planar`` per iteration; then the
    fused solve at the default precision "highest", whose glue runs the
    FFT kernels on one plane;
12. ``pgm_generic_solve``: ``pgm.ConvBPDN(fused=False)`` at L = 100 for
    250 iterations, unmasked and masked, with the launches its calls per
    iteration predict;
12a. ``cond_node``: the device loop's IF node (``csrc/cond_node.cu``
    through ``device_loop.when``) captured in a graph runs its body where
    its flag holds at replay and skips it where not; nested nodes stop at
    the first false flag; a flat chain of 50 runs as many bodies as its
    flags allow, and the time of a skipped node; its WHILE node (through
    ``device_loop.while_``) runs its body 0, 1, 7 and 1000 times for the
    limit set before each replay, nests in an IF node and holds one, and
    the µs of a pass;
12b. ``bt_solve``: ``pgm.ConvBPDN(fused=False)`` with the standard and
    the robust line search on the headline, 24 iterations from L = 1, on
    the graph route (the search a WHILE node: no flag read, ``ceil(k /
    8) + 1`` host reads) against the same problem declared eager (one
    host read a trial), and the standard one at ``bt_maxiter`` 200 on the
    graph route: every row equal to the bit, ``IterBTrack`` among them,
    and the FFT launches equal; ms an iteration of each, the first
    solve's capture seconds and its graph pool's memory;
13. ``tail_kernel``: ``admm_tail`` against its plain version on the card
    at the headline layout (4096 x 4096) and at ragged ones (37 x 4100,
    4096 x 192) over its flag grid; kernel and plain version timed;
14. ``gradreg_parity``: 10 iterations of the gradreg problem on the card
    against the CPU;
15. ``gradreg_layout``: the same at packed layouts outside the JAX
    package's TPU block rule for its tail (128x128 with 63 filters,
    C = 4032; 200x200 with 8 filters, 625 packed rows): one
    ``admm_tail`` per iteration all the same;
16. ``gradreg_solve``: the gradreg problem to 1e-3 (or 500 iterations)
    on the fused driver: one ``admm_tail`` per iteration, one
    ``rfft2_planar``/``irfft2_planar`` pair on 64 planes per iteration
    and three forward transforms in the setup; its objective against the
    generic solve's (``fused=False``);
17. ``elastic_solve``: the elastic net (mu = 0.05) fused, one
    ``csc_iter`` per iteration and no ``admm_tail``, against the generic
    solve;
18. ``wl1_spatial_solve``: ``l1`` with a random positive spatial weight
    field on the fused ``body`` (torch-op tail: no ``csc_iter``, no
    ``admm_tail``), against the generic solve;
19. ``clr_kernel``: ``csc_iter`` and ``pgm_iter`` as in ``kernel`` at the
    colour geometries, (pos, C, T) = (4096, 4096, 768) with the colour
    dictionary's weights and (12288, 4096, 256) with the headline's, and
    ``csc_iter`` at (4096, 4096, 512) with MultiDictConvBPDN's weights
    (the headline's filters and their 3x3-blurred copies, Cd = 2); the
    adjoint probe first, which sets the rule for ``csc_iter``'s Un (the
    plain version at 1e-5 while A is cuBLAS's bit for bit, else float64,
    :func:`check_csc_iter`);
20. ``clr_parity``: 10 iterations on the card against the CPU of the
    colour dictionary on fused ADMM and fused FISTA (unmasked and with a
    per-channel mask) and of the folded grey dictionary on fused ADMM;
21. ``clr_solve``: the colour dictionary to 1e-3, l1 and the elastic
    net, fused (one ``csc_iter`` per iteration, the glue's transforms on
    three planes) against generic;
22. ``clr_pgm_solve``: the colour dictionary by FISTA, 250 iterations,
    fused (one ``pgm_iter`` per iteration) against generic;
23. ``cfold_solve``: the folded problem, ADMM to 1e-3 and FISTA at 250
    iterations, each fused against generic;
24. ``cns_kernel``: ``csc_iter`` with ``emit_fwd=False`` at (10240, 2048,
    256), the initial dictionary's weights, under ``clr_kernel``'s rules
    (the adjoint probe, then the 1e-5 gate or Un against float64); its
    profile must show ``iter_main`` and ``sums_kernel`` and no
    ``iter_fwd``; timed beside the full form; the FFT kernels at 128x128
    over 1280 and 40 planes against their plain versions, float64 and
    ``torch.fft``;
25. ``cns_parity``: 5 outer iterations of the kernel stage and of the
    DFT-domain stage on the card against the CPU (D, Z, objective);
26. ``cns_solve``: 50 outer iterations of each stage (kernel, spatial
    with a per-filter ``L1Weight``, DFT-domain, masked with 80% of the
    pixels kept): ms an outer iteration, the objective falls, unit-norm
    filters, launches as the stage makes them, the unmasked stages'
    objectives within 1e-3;
27. ``cdl_solve``: ``ConvBPDNDictLearn`` (float32, ADMM x-step, consensus
    CCMOD) for 20 outer iterations: one full ``csc_iter`` each;

then masked CSC by Additive Mask Simulation on the headline image with
a quarter of its pixels missing (the mask from
``numpy.random.default_rng(0)``; 64 filters and the impulse map, packed
state 4096x4160), the opt-in "mixed" precision and the FISTA dictionary
update:

28. ``ams_tail_kernel``: the AMS form of ``admm_tail`` against its plain
    version at 4096x4160 with the headline mask and at ragged layouts,
    over nonneg and us (PYn and PUn bit for bit); kernel, plain version
    and the kernel's plain form timed on the same arrays;
29. ``ams_parity``: 10 iterations of the masked problem on the fused
    driver (``cbpdnmsk``'s ConvBPDN and ``cbpdngrdmsk``'s ConvBPDNGradReg,
    mu = 0.05) on the card against the CPU;
30. ``ams_solve``: both to 1e-3, fused (one AMS ``admm_tail`` an
    iteration) and ``fused=False``, objectives within 1e-3; then
    ``accel.cbpdnmsk``/``accel.cbpdngrdmsk`` each way, which must give
    the models' coefficients and launches;
31. ``mixed_kernel``: ``csc_iter``/``pgm_iter`` with R1 as one bf16
    product at the headline geometry against their plain versions, R1
    against the float64 product of its bf16-rounded operands, every
    other output the "high" launch's bits; mixed and high timed in turns;
32. ``mixed_solve``: fused ADMM to 1e-3 and fused FISTA (250 iterations)
    under "mixed", against the "high" solves; 10 iterations on the card
    against the CPU;
33. ``cdl_pgm_solve``: ``ConvBPDNDictLearn(xmethod="pgm", dmethod="pgm")``
    at ``cdl_solve``'s size, 20 outer iterations (one ``pgm_iter`` each),
    and 3 on the card against the CPU;

then BASELINE configurations 1-3 and the generic dictionary learning:

34. ``bpdn_parity``: each BPDN model (``BPDN``, ``BPDNJoint``,
    ``ElasticNet``, ``BPDNProjL1``, ``MinL1InL2Ball``) on the 512x512
    problem and ``BPDN`` on its 256 signals, 10 iterations in float64,
    card against CPU (rows to 1e-6, X and Y to 1e-8 of their scale);
35. ``bpdn_solve``: each in float32 to 1e-3: iterations, objective, ms an
    iteration (three solves), X's recovery error against x0 (``BPDN`` and
    ``BPDNProjL1`` below 1e-2, converged), the final objective within
    ``DENSE_OBJ_AGREE`` of the CPU's solve (``BPDNProjL1``'s, which goes
    to 0, within ``PROJL1_DFID_AGREE`` of ||S||^2), no kernel launched;
36. ``tv_parity``: the four TV models, 10 iterations card against CPU in
    float64 and in float32;
37. ``tv_solve``: each in float32 at its size: iterations, objective, ms
    an iteration (three solves), PSNR above the input's, the final
    objective within ``TV_OBJ_AGREE`` of the CPU's; the deconvolutions
    ``rfft2_planar`` k + 4 and ``irfft2_planar`` 3k (TVL2) or 2k (TVL1)
    times, the denoisers no kernel;
38. ``rpca_parity``: Robust PCA, 10 iterations in float64 card against
    CPU, the randomized SVD with the same sketch on both sides and the
    full SVD;
39. ``rpca_solve``: both in float32 to 1e-3: the low-rank and the sparse
    part recovered within 1e-2, ms an iteration (three solves), the
    iterations within one of the CPU's and each final objective within
    ``RPCA_OBJ_AGREE`` of it (the randomized with the same sketch; the
    complex phase below shares this routine), ``jac_round``'s launches (counted
    on the device) its sweeps times its rounds a sweep;
    both Robust PCA phases on the graph route, the iteration captured
    under ``global_capture()`` (any synchronisation inside it
    would fail the capture), exactly ``ceil(k / 8) + 1`` host reads
    (``exact_reads``) and the Jacobi SVD's sweeps counted on the device;
39a. ``svd_qr``: the x-step's decompositions at its shapes in float32
    and float64: the Jacobi SVD (``ops/svd.py``, ``csrc/jacobi_svd.cu``)
    of 512x512 and 26x512, then of 4x20000 float64 and 30000x8 float32
    (rows in a cluster's shared memory), 76800x100 float32 (a video's
    pixels by frames, rows in global memory) and 2048x2048 float32,
    against ``torch.linalg.svd`` within ``SVD_TOL`` L eps (singular
    values, product, orthonormality, the prox's thresholded product) and
    against its own plain version but at 512x512 float64 and 2048x2048;
    its captured form (global mode) replays bit for bit its eager form,
    its ``jac_round`` launches counted on the device are its sweeps times
    its rounds, NaN in gives NaN out with no synchronisation;
    ``torch.linalg.qr`` of 512x26 captured under global mode, its replay
    bit for bit the eager call, NaN in gives NaN out; each one's ms
    beside ``torch.linalg``'s, the Jacobi SVD's with its cluster size C,
    block width w, blocks a round, launches a sweep and sweeps;
39b. ``rpca_complex``: complex Robust PCA.  The complex form of the
    Jacobi SVD (``jac_round<w, SH, true>``, in clusters as the real form)
    of complex64 512x512, 26x512 and 256x192, as ``svd_qr`` checks each
    (against ``torch.linalg.svd``, its plain version on the card but at
    256x192, replay, NaN, launches) and times it, with its cluster size
    C, route and blocks a round;
    then complex64 Robust PCA (``rpca_problem`` made complex) with the
    randomized (rank 16) and the full SVD to 1e-3 on the graph route
    (exactly ``ceil(k / 8) + 1`` host reads, ``jac_round`` launches the
    sweeps times the rounds), against the same solves on the CPU: the
    iterations within one, the objective within
    ``RPCA_COMPLEX_OBJ_AGREE``;
40. ``dictlrn_handover``: the generic ``DictLearn`` over ``ConvBPDN`` and
    the consensus ``ConvCnstrMOD`` at the headline size, 3 outer
    iterations of 5 inner ones on the card (its hand-overs pass card
    tensors): 15 ``csc_iter``, filters in the unit ball, against the
    CPU within 2e-4;

then masked, online and patch dictionary learning:

41. ``maskdcpl_parity``: ``ConvBPDNMaskDcpl``, ``ConvL1L1Grd`` and
    ``ConvMinL1InL2Ball`` on a MASKDCPL_PARITY_N crop,
    MASKDCPL_PARITY_ITERS iterations in float64 card against CPU (rows
    1e-6; X, DX, Y0 and Y1 1e-8 of their scale);
42. ``maskdcpl_solve``: each in float32 to 1e-3 (500 iterations at
    most): iterations, objective, ms an iteration (three solves),
    ``rfft2_planar`` 3k + 1 and ``irfft2_planar`` 3k (``ConvL1L1Grd`` 4k
    + 2 and 4k), no other kernel;
43. ``mdl_parity``: ``ConvBPDNMaskDictLearn`` at the consensus geometry
    (the masked stage's mask), xmethod/dmethod admm/cns, admm/ism,
    admm/cg and pgm/pgm, MDL_PARITY_ITERS outer iterations in float64
    card against CPU (every column 1e-6, D and Z 1e-8);
44. ``mdl_solve``: each pair 50 outer iterations in float32: ms an outer
    iteration, filters in the unit ball within 1e-5, the x-step
    objective lower at the end than at the start (admm/cns and pgm/pgm,
    whose objective rises again in the JAX package too: its least value),
    the launches of ``mdl_launches`` (pgm/pgm one ``pgm_iter`` an outer
    iteration); the admm/cg d-step on the graph route: every sub-solve
    of k ADMM iterations ``ceil(k / 8) + 1`` host reads, its CG a WHILE
    node that reads nothing (the CG iterations from the loop's device
    counter); then admm/cg with the d-step declared eager, rows and D
    equal to the graph route's to the bit;
44a. ``ccmod_cg_solve``: ``ConvCnstrMOD(method="cg")`` at the consensus
    geometry (40 signals of 128x128, 32 filters, coefficients drawn from
    a seed) in float32 on the graph route against the same problem
    declared eager: rows and D equal to the bit, the same FFT launches
    and CG iterations; ms an iteration of each;
45. ``online_solve``: ``OnlineConvBPDNDictLearn`` and its masked form over
    five 512x512 samples (``headline_problem`` seeds 0-4, the masked
    form with ``ams_problem``'s mask) at lmbda 0.05, 50 x-step
    iterations a sample: ms a sample, the plain x-step on the fused
    driver with ``csc_iter`` once an x-step iteration, the FFT kernels
    as the x-steps and the d-step make them, eta decreasing, unit-norm
    filters; then 2 samples of 3 x-step iterations in float64, card
    against CPU (every column 1e-6, D and Z 1e-8);
46. ``dense_dl_parity``: the dense FISTA ``BPDN`` (K = 1 and 256) and
    ``WeightedBPDN`` at L 1.01 ||D||^2, ``cmod.CnstrMOD`` and
    ``pgm.CnstrMOD`` on BASELINE configuration 1's problem, 10
    iterations, and ``BPDNDictLearn`` and ``WeightedBPDNDictLearn`` on
    the patch problem (64 x 62001, 128 atoms), 5 outer iterations, in
    float64 card against CPU;
47. ``dense_dl_solve``: the same in float32: the models to 1e-3
    (iterations, objective, ms an iteration over three solves), the
    learners 50 outer iterations (ms an outer iteration, atoms of unit
    norm within 1e-5); no kernel launched;

then the rest of the CSC models, a pair of phases for each family of
``REST_FAMILIES`` (``csc_variants``, ``inhib``, ``csctv``, ``pdcsc``,
``ppp``, ``spline``; the problems of ``rest_problems``):

48-59. ``<family>_parity``: each model of the family, REST_PARITY_ITERS
    iterations in float64 on a REST_PARITY_N crop of its problem, card
    against CPU (rows 1e-6, every array 1e-8 of its scale);
    ``csc_variants_parity`` also MultiDictConvBPDN in float32 on the
    fused driver at 512x512, 10 iterations through ``csc_iter`` against
    the CPU's plain version (``clr_parity``'s tolerances);
    ``<family>_solve``: each in float32 at 512x512 to its example's
    tolerance or fixed count (iterations, objective, ms an iteration,
    and that of two more solves of REST_REPEAT_ITERS iterations), the
    launches ``rest_problems`` predicts from the code,
    and the quality gate where the example has one (PSNR above the
    input's for ConvBPDNJoint, the l1 fidelity product models and the
    Plug-and-Play models; Y in the l1 ball for ConvBPDNProjL1; the views'
    and the product models' reconstruction error; inhibition's
    reconstruction error and fewer active coefficients than ConvBPDN's;
    the spline's fit through outliers; none for the TV models, whose
    example has none); ``ppp_solve`` also runs PPP with a numpy prior
    through ``host_prior``, within 1e-4 of the device prior's X.

Then the parallel paths (``parallel/`` on ``torch.distributed``) in a
world of one rank over NCCL, initialised in this process on
``tcp://127.0.0.1`` and destroyed after (no fallback to gloo or the
CPU):

60. ``par_parity``: ParConvBPDN (16 filter groups) in float64 on the
    REST_PARITY_N crop of the headline, card against CPU; then its
    ``mesh=`` form (the group sums through NCCL) against ``mesh=None``
    on the card, float32, 10 iterations at 512x512 (rows 1e-5); each on
    the card a captured device loop of ``ceil(k / 8) + 1`` host reads;
61. ``par_solve``: ParConvBPDN to 1e-3 on the headline and on
    ``examples/csc_parallel.py``'s image masked through 30% of its pixels
    (the data pack's 64 filters):
    iterations, objective, ms an iteration, ``rfft2_planar`` 2k + 1 and
    ``irfft2_planar`` 2k, ``ceil(k / 8) + 1`` host reads, the
    reconstruction error below 0.8, the masked reconstruction's PSNR
    above the masked input's;
62. ``cns_sharded``: ``launch.consensus_cdl`` on the mesh against the
    unsharded loop at the consensus geometry, 10 outer iterations (D
    within 1e-5 of its scale, the same launches: ``csc_iter`` once an
    outer iteration), then ms an outer iteration of each over 50;
63. ``spatial``: ``cbpdn_nsharded`` on the headline against
    ``ConvBPDN(fused=False)`` and ``tvl2deconv_nsharded`` against
    ``TVL2Deconv`` (iterations within one, the first 10 rows at the
    parity tolerances or X within 2e-4), ms an iteration of each, each
    sharded solve a captured device loop (its collectives in the graph)
    of ``ceil(k / 8) + 1`` host reads;
64. ``grid_search``: ``launch.grid_search`` finds (0.3, 0) with value 0.

Each solve sets every kernel's launch count to 0 just before it and
reads the counts just after.  Then a ``total`` line with the seconds the
run took, the ``{"kernels": [...]}`` line (the inverse's ``ms`` is that
of ``irfftn`` on a complex64 spectrum, the call the solves make;
``planar_ms`` the planar entry's; ``csc_iter``/``pgm_iter`` also carry
their numbers at the colour geometries and their launches in the colour
solves, ``csc_iter`` its ``emit_fwd=False`` form at the consensus
geometry and its launches in the consensus and dictionary learning
solves, the FFT kernels their numbers at 128x128 and their launches in
the TV deconvolution solves, and, of this slice, ``csc_iter`` its
launches in the online solve, ``pgm_iter`` in the masked FISTA learner,
the FFT kernels in the two-block, masked learner and online solves, and
of the last slice ``csc_iter`` its launches in MultiDictConvBPDN's solve
and the FFT kernels in every model's solve (``csc_rest_launches``), of
the parallel slice ``csc_iter`` and the FFT kernels their launches in
the sharded consensus (``sharded_consensus_launches``) and the FFT
kernels in ParConvBPDN's solves (``parcbpdn_launches``), and of the
last slice the FFT kernels' launches in the line-search FISTA solves
(``bt_launches``); the
AMS form of
``admm_tail`` and the "mixed" forms of ``csc_iter``/``pgm_iter`` are
entries of their own, with their launches in the fused masked and mixed
solves; last ``jac_round``, the Jacobi SVD's kernel, which has no TPU
counterpart, at one SVD of 512x512 float32, with its launches in the
Robust PCA solves, counted on the device, and its time at every
``svd_qr`` shape, and its complex form, ``jac_round (complex form)``, at
one SVD of 512x512 complex64 with its launches in the complex solves
and its time at every ``rpca_complex`` shape), the ``nvidia-smi`` name
and power limit line, and last
``{"ok": true, "device": {...}}``.
The fused ADMM and FISTA solves run their loop on the card
(``sporco_tpu_torch/ops/device_loop.py``): one iteration captured as a
CUDA graph and replayed in blocks of 8, one host read a block; each
fused solve phase (``solve``, ``pgm_solve``, the fused side of
``generic_solve``, ``gradreg_solve``, ``elastic_solve``,
``wl1_spatial_solve``, ``clr_solve``, ``clr_pgm_solve``, ``cfold_solve``,
``ams_solve``, ``mixed_solve``) reports its ``host_reads`` and fails if
the loop was not captured or made more than ``ceil(k / 8) + 2`` reads
for k iterations; the ``--profile`` phases report them beside the idle
share.  The generic ADMM and PGM drivers run the same loop: the generic
solve phases (``generic_solve``, ``pgm_generic_solve``, ``bpdn_solve``,
``tv_solve``, ``rpca_solve``, ``maskdcpl_solve`` and every
``<family>_solve``, ``PPP`` among them) report ``host_reads`` and the
``route`` and fail past ``ceil(k / 8) + 2`` reads, or where a problem
that declares the graph route did not run as a graph (``host_prior``
alone declares the eager route);
``cdl_solve``, ``mdl_solve`` and ``dense_dl_solve`` report ms an outer
iteration.
Any failure exits non-zero without the ``ok`` line; so does a run past the
time budget, or a machine without a CUDA device.
``--profile`` adds phases that run the fused ADMM, fused FISTA, generic
ADMM, fused gradreg and fused masked (AMS) solves, the consensus loop's
kernel stage (50 outer iterations), and BPDN on 256 signals,
``TVL2Denoise``, ``TVL2Deconv`` and the randomized Robust PCA, the
``ConvBPDNMaskDcpl`` solve and one outer iteration of
``ConvBPDNMaskDictLearn`` (admm/cns and pgm/pgm), and ``ConvBPDNJoint``,
``ConvBPDNScalarTV``, ``ConvProdDictL1L1Grd`` and ``PPP`` at 512x512,
under ``torch.profiler`` and report the device's busy and idle share and its
time by kernel.
"""

import contextlib
import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from sporco_tpu_torch import accel
from sporco_tpu_torch._device import fp32_precision
from sporco_tpu_torch.models import bpdn as tbpdn
from sporco_tpu_torch.models import cbpdn as tcbpdn
from sporco_tpu_torch.models import ccmod as tccmod
from sporco_tpu_torch.models import cmod as tcmod
from sporco_tpu_torch.models import dictlrn as tdl
from sporco_tpu_torch.models import pgm as tpgm
from sporco_tpu_torch.models import rpca as trpca
from sporco_tpu_torch.models import tv as ttv
from sporco_tpu_torch.models.cbpdn import (AddMaskSim, ConvBPDN,
                                           ConvBPDNGradReg, ConvElasticNet)
from sporco_tpu_torch.ops import _nvcc
from sporco_tpu_torch.ops import csc_iter as tci
from sporco_tpu_torch.ops import csc_tail as tct
from sporco_tpu_torch.ops import device_loop
from sporco_tpu_torch.ops import fft as tsf
from sporco_tpu_torch.ops import fft2_planar as tfp
from sporco_tpu_torch.ops import fused_csc as tfc
from sporco_tpu_torch.ops import linalg as tla
from sporco_tpu_torch.ops import pgm_iter as tpi
from sporco_tpu_torch.ops import svd as tsvd
from sporco_tpu_torch.ops.fused_csc import PS, xstep_kernels
from sporco_tpu_torch.parallel import consensus as tcns
from sporco_tpu_torch.solvers import pgm as tspgm

BUDGET_S = 600          # hard limit for the whole script, build included

N, ND, M, LMBDA = 512, 8, 64, 0.05
MAX_ITER, REL_TOL = 500, 1e-3
PARITY_ITERS = 10
PGM_L, PGM_ITERS = 100.0, 250         # bench.py:_bench_pgm
MASK_MISSING = 0.3                    # share of pixels masked out
PGM_GENERIC_ITERS = 250
# (B, N0, N1) of the FFT kernel phase: the generic x-step's 64 planes,
# the fused glue's one plane, then each row-pass branch (direct DFT for
# N1 = 30, FFT for every power of two from 2 to 2048) and each column
# pass (N0 = 128, 256, 512) with a power-of-two N1 of at least 8
FFT_SHAPES = [(M, N, N), (1, N, N), (3, 128, 30), (2, 256, 64),
              (1, 512, 2048), (2, 128, 2), (3, 128, 256), (2, 256, 512),
              (2, 128, 4), (1, 256, 8), (2, 128, 16), (1, 512, 32),
              (2, 256, 128), (1, 128, 1024)]
# batch of calls per CUDA-event timing of the FFT kernels, their plain
# versions and torch.fft: a transform of 64 planes takes about as long as
# its wrapper's host time
FFT_BATCH = 10
# (R, C) of the tail kernel phase: the headline packed layout, then a C
# off a multiple of 4 with a ragged R, and a C off a multiple of 128
TAIL_SHAPES = [((N // PS) ** 2, PS * PS * M), (37, 4100),
               ((N // PS) ** 2, 192)]
GRAD_MU = 10.0          # gradient penalty of the gradreg problem
# (image side, filters) of the gradreg layout phase: C = 64 * 63 off a
# multiple of 128 (FFT kernels on), then 625 packed rows off a multiple
# of 8 (an image side the FFT kernels do not take: torch.fft)
GRAD_LAYOUTS = [(128, 63), (200, 8)]
ELASTIC_MU = 0.05       # l2 penalty of the elastic net

# Kernel against plain version on the card: A = G2 @ Wa is fp32 FFMA in
# both, summed over k = 256 in order (bit for bit alike); R1/R2 sum over
# k = 4096 on the tensor cores as split products against cuBLAS's fp32
# sums, about 1e-6 relative; 1e-5 of each output's largest magnitude.
KERNEL_RTOL = 1e-5
# Card (kernel) against CPU (plain version) over 10 iterations: the
# tolerances of the CPU test of the port against the JAX package.
PARITY = {"X": 2e-4, "ObjFun": 1e-4, "DFid": 1e-4, "RegL1": 1e-4,
          "Rho": 1e-4, "PrimalRsdl": 1e-3, "DualRsdl": 1e-3,
          "RegGrad": 1e-3}
PGM_PARITY = {"X": 2e-4, "ObjFun": 1e-4, "DFid": 1e-4, "RegL1": 1e-4,
              "Rsdl": 1e-4}
# The FFT kernels against float64 references on unit-normal data, the
# JAX package's tolerances (tests/ops/test_pallas_fft.py:36-41): forward
# 1e-6 of the spectrum's largest magnitude, inverse 3e-5 absolute; the
# kernel against its plain version and cuFFT (both fp32) within twice.
FFT_TOL = {"forward": 1e-6, "inverse": 3e-5}
# The generic solve against the fused solve of the same problem, both to
# relative residual 1e-3: final objectives within that tolerance.
OBJ_AGREE = 1e-3

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# bf16 tensor-core products per fp32 product in the split products of
# csrc/csc_tiles.cuh (the six of order <= 2 of three-term splits)
SPLIT_PASSES = 6
PEAK_HBM_BYTES = 3.35e12
# FP64 on the tensor cores (the data sheet's FP64 Tensor Core rate; the
# Jacobi SVD's kernels work in double)
PEAK_FP64_FLOPS = 67e12
# float operations per state element in each kernel's epilogue, beside
# the 2*k of each product: csc_iter's update of Y and U and six sums;
# pgm_iter's step, prox, momentum and two sums
EPI_FLOPS = 29
PGM_EPI_FLOPS = 15
# float operations per element of admm_tail: the rescale, relaxation,
# threshold, sign, dual update, the two differences (14) and the six sums'
# products and adds (12)
TAIL_FLOPS = 26

PHASE = {"name": "start"}
# the fused solves' device loop must run as a captured CUDA graph (the
# CPU rehearsal, tools/chip_smoke_cpu.py, runs it eagerly)
LOOP_GRAPH = True


def emit(obj):
    print(json.dumps(obj), flush=True)


def _over_budget(signum, frame):
    print(f"chip_smoke: time budget of {BUDGET_S} s exceeded in phase "
          f"{PHASE['name']!r}", file=sys.stderr, flush=True)
    os._exit(3)


def headline_problem(seed=0, n=None):
    """The problem of ``bench.py``'s ``_headline_problem`` (at n x n, N
    by default)."""
    from scipy.ndimage import gaussian_filter
    n = n or N
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((ND, ND, M)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    S = gaussian_filter(rng.standard_normal((n, n)), 8.0) * 5.0
    S += 0.1 * rng.standard_normal((n, n))
    return D, S.astype(np.float32), LMBDA


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def device_scalars(dev, *vals):
    """The flag live (1) and ``vals`` as 0-d float32 tensors on the card,
    made once: a kernel timed with them is launched as the fused loop
    launches it (its scalar block stacked on the card), not through the
    eager route's copy of numbers from pinned memory."""
    return [torch.tensor(float(np.float32(v)), device=dev)
            for v in (1.0,) + vals]


def cuda_ms(fn, reps=20, warmup=3, batch=1):
    """Median time of ``fn()`` on the card in ms, from CUDA events around
    ``batch`` calls in a row (``batch > 1`` for a kernel shorter than its
    wrapper's host time, which would otherwise be timed too)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return float(np.median(times))


def _bound_ms(flops, floats):
    """Least time on an H100 SXM for ``flops`` fp32 operations and
    ``floats`` float32 values moved (each input read once, each output
    written once): the larger of the operations over 67 TFLOP/s and the
    bytes over 3.35 TB/s, with which of the two bounds it."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = 4 * floats / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _split_bounds(pos, C, T, epi_flops, floats, nfwd=2, mixed=False):
    """The bounds of csc_iter/pgm_iter, with ``nfwd`` forward products
    beside the adjoint (0 for csc_iter's ``emit_fwd=False``).
    ``bound_ms``: every product as an fp32-faithful split on the tensor
    cores (SPLIT_PASSES bf16 products each at 989 TFLOP/s) and the
    epilogue in fp32, against the bytes.  ``bound_as_built_ms``: the work
    as the kernel does it (the adjoint G2 @ Wa in fp32 FFMA, the forward
    pair split on the tensor cores; the forward needs the adjoint's
    output, so the two add).  ``bound_fp32_ms``: all in fp32 FFMA (the
    bound of PRs 4-10).  ``mixed``: the first forward product (R1) as
    one bf16 product, the others as before."""
    prod = 2 * pos * T * C
    t_epi = epi_flops * pos * C / PEAK_FP32_FLOPS * 1e3
    t_bytes = 4 * floats / PEAK_HBM_BYTES * 1e3
    fwd_passes = SPLIT_PASSES * nfwd - (SPLIT_PASSES - 1) * bool(
        mixed and nfwd)
    t_tensor = ((SPLIT_PASSES + fwd_passes) * prod / PEAK_BF16_FLOPS * 1e3
                + t_epi)
    t_built = (prod / PEAK_FP32_FLOPS * 1e3 + t_epi
               + fwd_passes * prod / PEAK_BF16_FLOPS * 1e3)
    return {"bound_ms": max(t_tensor, t_bytes),
            "bound_by": "operations" if t_tensor >= t_bytes else "bytes",
            "bound_as_built_ms": max(t_built, t_bytes),
            "bound_fp32_ms": _bound_ms((1 + nfwd) * prod
                                       + epi_flops * pos * C, floats)[0]}


def csc_iter_bound_ms(pos, C, T, emit_px, vectors, emit_fwd=True,
                      mixed=False):
    """The bounds of one csc_iter call (see :func:`_split_bounds`); with
    ``emit_fwd`` False no Wf read, no R1/R2 written, no forward pair."""
    fwd = 1 if emit_fwd else 0
    floats = (pos * T + 2 * pos * C + (1 + fwd) * T * C    # G2 Y U Wa Wf
              + 2 * pos * C + 2 * fwd * pos * T + 6        # Yn Un R1 R2 sums
              + (pos * C if emit_px else 0) + (2 * C if vectors else 0))
    return _split_bounds(pos, C, T, EPI_FLOPS, floats, nfwd=2 * fwd,
                         mixed=mixed)


def pgm_iter_bound_ms(pos, C, T, vectors, mixed=False):
    """The bounds of one pgm_iter call (see :func:`_split_bounds`)."""
    floats = (pos * T + 2 * pos * C + 2 * T * C            # G2 Y Xprv Wa Wf
              + 2 * pos * C + 2 * pos * T + 2              # X Yn R1 RX sums
              + (2 * C if vectors else 0))
    return _split_bounds(pos, C, T, PGM_EPI_FLOPS, floats, mixed=mixed)


def tail_bound_ms(R, C, vectors, mask_floats=0):
    """Least time of one admm_tail call: PX, PY and PU read once, PYn and
    PUn written once, and ``mask_floats`` of the AMS form's packed mask
    (see :func:`_bound_ms`)."""
    floats = 5 * R * C + 6 + (2 * C if vectors else 0) + mask_floats
    return _bound_ms(TAIL_FLOPS * R * C, floats)


def fft_bound_ms(B, n0, n1):
    """Least time of one 2-D real transform of B planes (either way): the
    planes in (out) and the planar half-spectrum out (in) once, and the
    2.5 N log2 N operations of a real FFT of N = n0 n1 points."""
    flops = 2.5 * B * n0 * n1 * math.log2(n0 * n1)
    floats = B * n0 * n1 + 2 * B * n0 * (n1 // 2 + 1)
    return _bound_ms(flops, floats)


def reset_launches():
    tci.reset_launches()
    tpi.reset_launches()
    tfp.reset_launches()
    tct.reset_launches()
    tsvd.reset_launches()
    device_loop.LAST.clear()


def launches():
    """Every kernel's launches since ``reset_launches()``: the wrappers'
    counts, and ``jac_round``'s from its counter on the device (its
    launches run inside WHILE nodes)."""
    return {**tci.LAUNCHES, **tpi.LAUNCHES, **tfp.LAUNCHES, **tct.LAUNCHES,
            "jac_round": tsvd.launches()}


def loop_reads(label, k, route="graph"):
    """The last solve's device loop (``ops/device_loop.py``): on the
    graph route it ran as a CUDA graph (captured in this call, or kept
    from an earlier call of the same geometry), on the eager route (a
    problem that declares it) without one, and made at most one host
    read a block of 8 iterations and the final one, with one to spare
    (set-up), or the phase fails.  Returns the loop's record
    (``host_reads`` and the rest)."""
    last = dict(device_loop.LAST)
    limit = math.ceil(k / device_loop.UNROLL) + 2
    if not last or last["live"] != k or (LOOP_GRAPH and (
            last["graph"] != (route == "graph")
            or last["route"] != route)):
        raise AssertionError(f"{label}: the device loop's record {last} "
                             f"is not a {route} run of {k} iterations")
    if last["host_reads"] > limit:
        raise AssertionError(f"{label}: {last['host_reads']} host reads "
                             f"for {k} iterations (at most {limit})")
    return last


def generic_loop(label, b, k):
    """:func:`loop_reads` of a model ``b`` on a generic driver after a
    solve of ``k`` iterations, on the route its solve declares
    (``solvers/pgm.py`` ``pgm_route``): the host reads, the route and
    whether it ran as a captured graph."""
    m = _model(b)
    route = m.problem.route
    if hasattr(m.opts, "backtrack"):
        route = tspgm.pgm_route(m.problem, m.opts)
    last = loop_reads(label, k, route)
    return {"host_reads": last["host_reads"], "route": last["route"],
            "declared_route": route, "graph": last["graph"],
            "captured": last["captured"], "blocks": last["blocks"],
            "flag_reads": last["flag_reads"]}


def exact_reads(label, k):
    """The last device loop's host reads are one a block of 8 iterations
    and the final one, ``ceil(k / 8) + 1``, or the phase fails."""
    want = math.ceil(k / device_loop.UNROLL) + 1
    got = device_loop.LAST.get("host_reads")
    if got != want:
        raise AssertionError(f"{label}: {got} host reads for {k} "
                             f"iterations, not {want}")
    return got


def expect_launches(label, counts, **want):
    """Fail unless the launch counts are ``want`` (every other kernel
    0)."""
    full = {name: want.get(name, 0) for name in counts}
    if counts != full:
        raise AssertionError(f"{label}: launches {counts}, expected {full}")


@contextlib.contextmanager
def fft_precision(p):
    prev = tsf.get_precision()
    tsf.set_precision(p)
    try:
        yield
    finally:
        tsf.set_precision(prev)


@contextlib.contextmanager
def global_capture():
    """Every CUDA-graph capture begun within, the device loop's among
    them, under global mode: any synchronising call inside it, in any
    thread, fails the capture."""
    begin = torch.cuda.CUDAGraph.capture_begin

    def capture_begin(self, pool=None, capture_error_mode="global", **kw):
        return begin(self, pool=pool, capture_error_mode="global", **kw)
    torch.cuda.CUDAGraph.capture_begin = capture_begin
    try:
        yield
    finally:
        torch.cuda.CUDAGraph.capture_begin = begin


@contextlib.contextmanager
def planar_fft(mode):
    tsf.use_planar_fft(mode)
    try:
        yield
    finally:
        tsf.use_planar_fft("auto")


def compare_outputs(kernel, names, got, ref, where, float64_gated=()):
    """Hold a kernel's outputs against its plain version's: each within
    KERNEL_RTOL of that output's largest magnitude, except those named in
    ``float64_gated``, which the caller holds against float64.  Returns
    the relative error by output and the largest absolute error over the
    arrays (not the sums)."""
    torch.cuda.synchronize()
    errs, max_abs = {}, 0.0
    for name, k, p in zip(names, got, ref):
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"{kernel} {name} not finite at {where}")
        ae = float((k - p).abs().max())
        errs[name] = ae / max(float(p.abs().max()), 1e-30)
        if name != "sums":
            max_abs = max(max_abs, ae)
        if errs[name] > KERNEL_RTOL and name not in float64_gated:
            raise AssertionError(
                f"{kernel} {name} differs from the plain version by "
                f"{errs[name]:.3e} (tolerance {KERNEL_RTOL:.0e}) at "
                f"{where}")
    return errs, max_abs


def compare_runs(label, runs, stat_names, tolerance):
    """Hold a solve on the card against the same solve on the CPU: the
    stats columns ``stat_names`` row by row (relative), and each named
    array within its tolerance of its scale.  ``runs`` is
    ``[(itstat, {name: array}), ...]`` for the card, then the CPU."""
    (ig, ag), (ic, ac) = runs
    if len(ig) != PARITY_ITERS or len(ic) != PARITY_ITERS:
        raise AssertionError(f"{label}: runs did not take {PARITY_ITERS} "
                             "iterations")
    errs = {}
    for name in stat_names:
        a, b = getattr(ig, name), getattr(ic, name)
        errs[name] = float(np.max(np.abs(a - b) / np.abs(b)))
    for name in ag:
        a, b = ag[name], ac[name]
        errs[name] = float(np.abs(a - b).max() / max(np.abs(b).max(),
                                                      1e-6))
    for name, e in errs.items():
        tol = tolerance["X" if name in ag else name]
        if not e <= tol:
            raise AssertionError(f"{label}: {name} differs by {e:.3e} "
                                 f"(tolerance {tol:.0e})")
    return errs


def headline_weights(dev, D):
    """The polyphase weights of the headline dictionary on the card and
    the packed geometry (pos, C, T)."""
    Wf, Wa, _ = xstep_kernels(torch.as_tensor(D).permute(2, 0, 1)
                              .contiguous().to(dev), ND, ND, PS)
    return Wf, Wa, ((N // PS) ** 2, PS * PS * M, Wa.shape[0])


def float64_errors(names, got, ref, ref64):
    """Each output's largest difference from a float64 run of the plain
    version, relative to that output's largest magnitude there, for the
    kernel and the plain version (a report beside the gate, which is the
    plain version)."""
    out = {"kernel": {}, "plain": {}}
    for name, k, p, d in zip(names, got, ref, ref64):
        scale = max(float(d.abs().max()), 1e-300)
        out["kernel"][name] = float((k.double() - d).abs().max()) / scale
        out["plain"][name] = float((p.double() - d).abs().max()) / scale
    return out


def check_repeatable(kernel, run):
    """Two launches from the same inputs give the same bits, sums
    included."""
    a, b = run(), run()
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        if x is not None and not torch.equal(x, y):
            raise AssertionError(f"{kernel}: two launches from the same "
                                 "inputs differ")
    return True


def sass_counts(lib):
    """Instructions of interest by kernel in a built library, from
    ``cuobjdump -sass`` (beside nvcc)."""
    tool = os.path.join(os.path.dirname(_nvcc.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    counts, fn = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            fn = ln.split(":", 1)[1].strip()
            for short in ("iter_main", "iter_fwd", "pgm_main", "pgm_fwd",
                          "sums_kernel"):
                if short in fn:
                    fn = short
            # the instantiations of one template add up under its name
            counts.setdefault(fn, {"HGMMA": 0, "HMMA": 0, "FFMA": 0,
                                   "LDGSTS": 0})
        elif fn is not None:
            op = ln.split("*/", 1)[-1].strip().split(" ")[0].split(".")[0]
            if op in counts[fn]:
                counts[fn][op] += 1
    return counts


def check_split_build(name):
    """csc_iter/pgm_iter as built: no kernel spills or has a stack frame
    (ptxas, when this run built the library), and the forward pass runs
    its products on the tensor cores (HGMMA, wgmma, in its SASS)."""
    info = _nvcc.BUILD_INFO[name]
    for ln in info["log"].splitlines():
        if "stack frame" in ln and any(
                int(w) for w in ln.replace(",", " ").split() if w.isdigit()):
            raise AssertionError(f"{name}: ptxas reports {ln.strip()!r}")
    counts = sass_counts(info["path"])
    fwd = "iter_fwd" if name == "csc_iter" else "pgm_fwd"
    if not counts.get(fwd, {}).get("HGMMA"):
        raise AssertionError(f"{name}: no HGMMA in {fwd}: {counts}")
    return counts


def adjoint_rounding(G2, Y0, U0, Wa, Wf, wf3, rlx, us, scale):
    """Why csc_iter's adjoint is fp32 FFMA summed over k in order: the
    share of A = G2 @ Wa that the kernel gives bit for bit as cuBLAS does
    (read as PX at scale 0), and how far Un moves, relative to its scale,
    when the plain version gets the correctly rounded A (the float64
    product rounded once, fed as A @ I) in place of cuBLAS's: the most
    accurate A there is, yet not cuBLAS's bits."""
    def run(fn, g2, wa, sc, **kw):
        return fn(g2, Y0.clone(), U0.clone(), wa, Wf, 0.0143, 1.0, rlx, us,
                  sc, emit_px=True, **kw)
    a_kernel = run(tci.csc_iter, G2, Wa, 0.0, wf_split=wf3)[0]
    a_plain = run(tci.csc_iter_plain, G2, Wa, 0.0)[0]
    a_exact = (G2.double() @ Wa.double()).float()
    eye = torch.eye(a_exact.shape[1], device=G2.device)
    un_plain = run(tci.csc_iter_plain, G2, Wa, scale)[2]
    un_exact = run(tci.csc_iter_plain, a_exact, eye, scale)[2]
    ulp = torch.abs(torch.nextafter(a_exact, torch.full_like(a_exact,
                                                             math.inf))
                    - a_exact)
    return {"kernel_A_bits_as_cublas": float(
                (a_kernel == a_plain).float().mean()),
            "cublas_A_max_ulps": float(((a_plain - a_exact).abs()
                                        / ulp).max()),
            "un_rel_err_correctly_rounded_A": float(
                (un_exact - un_plain).abs().max()
                / un_plain.abs().max())}


def check_csc_iter(dev, Wf, Wa, pos, headline, seed=1, emit_fwd=True):
    """``csc_iter`` against its plain version on the card at (pos, C, T)
    over the flag grid, each output's error against a float64 run beside
    it, two launches alike bit for bit, kernel and plain version timed;
    with ``emit_fwd`` False all of it without the forward pair (the
    consensus stage's form; then the full form is timed beside it).

    The adjoint probe runs first.  Un cancels from A's magnitude down to
    the threshold's, so it holds the 1e-5 gate against the cuBLAS plain
    version only while the kernel's A is cuBLAS's bit for bit.  At the
    headline geometry that must hold.  At another geometry, where cuBLAS
    may choose another summation order, every output is gated at 1e-5
    if it holds; if not, Un alone is held against float64: the kernel's
    distance at most max(1e-5, 1.5 times the plain version's), of Un's
    scale (``un_rule``)."""
    C, T = Wf.shape
    wf3 = tci.split_weight(Wf)
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    G2 = 0.1 * randn(pos, T)
    Y0 = randn(pos, C) * (torch.rand((pos, C), generator=g, device=dev)
                          < 0.05)
    U0 = 0.01 * randn(pos, C)
    thr_v = 0.01 + 0.02 * torch.rand(C, generator=g, device=dev)
    wl1_v = 0.5 + torch.rand(C, generator=g, device=dev)
    rlx, us, scale = 1.8, 0.9, 1.0
    adjoint = adjoint_rounding(G2, Y0, U0, Wa, Wf, wf3, rlx, us, scale)
    alike = adjoint["kernel_A_bits_as_cublas"] == 1.0
    if headline and not alike:
        # the grid's Un gate holds only while A is cuBLAS's bit for bit
        raise AssertionError(
            "csc_iter: the adjoint's A is no longer cuBLAS's bit for bit "
            f"({adjoint}); cuBLAS changed its summation order, and Un's "
            f"{KERNEL_RTOL} gate against the plain version cannot hold")
    un_rule = ("plain version, 1e-5" if alike else
               "float64: kernel <= max(1e-5, 1.5 x plain version)")
    grid, max_abs = [], 0.0
    for emit_px in (False, True):
        for nonneg in (False, True):
            for vectors in (False, True):
                thr, wl1 = (thr_v, wl1_v) if vectors else (0.0143, 1.0)

                def run(fn, dt=torch.float32):
                    Y, U = Y0.to(dt, copy=True), U0.to(dt, copy=True)
                    o = fn(G2.to(dt), Y, U, Wa.to(dt), Wf.to(dt), thr, wl1,
                           rlx, us, scale, nonneg=nonneg, emit_px=emit_px,
                           emit_fwd=emit_fwd)
                    if not emit_fwd and (o[3] is not None
                                         or o[4] is not None):
                        raise AssertionError("csc_iter returned R1/R2 "
                                             "with emit_fwd=False")
                    return [t for t in o if t is not None]
                got = run(lambda *a, **k: tci.csc_iter(*a, **k,
                                                       wf_split=wf3))
                ref = run(tci.csc_iter_plain)
                names = ((["PX"] if emit_px else []) + ["Yn", "Un"]
                         + (["R1", "R2"] if emit_fwd else []) + ["sums"])
                where = (f"(pos, C, T) = {(pos, C, T)} emit_px={emit_px} "
                         f"nonneg={nonneg} vectors={vectors}")
                errs, ae = compare_outputs(
                    "csc_iter", names, got, ref, where,
                    float64_gated=() if alike else ("Un",))
                max_abs = max(max_abs, ae)
                f64 = float64_errors(names, got, ref,
                                     run(tci.csc_iter_plain, torch.float64))
                if not alike:
                    k64, p64 = f64["kernel"]["Un"], f64["plain"]["Un"]
                    if not k64 <= max(KERNEL_RTOL, 1.5 * p64):
                        raise AssertionError(
                            f"csc_iter Un is {k64:.3e} from float64, the "
                            f"plain version {p64:.3e}, at {where}")
                grid.append({"emit_px": emit_px, "nonneg": nonneg,
                             "vectors": vectors, "rel_err": errs,
                             "vs_float64": f64})
    # the main path's configuration: repeatable, timed, and by pass
    Y, U = Y0.clone(), U0.clone()

    dvals = device_scalars(G2.device, 0.0143, us, scale)

    def run(fn, fwd=emit_fwd):
        # the kernel with its scalars on the card, the plain version (which
        # would read a flag on the card) with numbers
        if fn is tci.csc_iter:
            live, thr_t, us_t, scale_t = dvals
            return lambda: fn(G2, Y, U, Wa, Wf, thr_t, 1.0, rlx, us_t,
                              scale_t, nonneg=False, emit_px=False,
                              wf_split=wf3, emit_fwd=fwd, live=live)
        return lambda: fn(G2, Y, U, Wa, Wf, 0.0143, 1.0, rlx, us, scale,
                          nonneg=False, emit_px=False, wf_split=wf3,
                          emit_fwd=fwd)
    check_repeatable("csc_iter", lambda: tci.csc_iter(
        G2, Y0.clone(), U0.clone(), Wa, Wf, 0.0143, 1.0, rlx, us, scale,
        emit_px=True, wf_split=wf3, emit_fwd=emit_fwd))
    # timed over batches of calls, as the FFT kernels are: the wrapper's
    # host time then overlaps the kernels of the call before, and the
    # events time the kernels, not the enqueue of the first
    batch = FFT_BATCH
    kernel_ms = cuda_ms(run(tci.csc_iter), batch=batch)
    pass_ms = device_ms_by_kernel(run(tci.csc_iter))
    plain_ms = cuda_ms(run(tci.csc_iter_plain), batch=batch)
    gflop = 2 * pos * T * C / 1e9
    out = {"geometry": {"pos": pos, "C": C, "T": T, "emit_fwd": emit_fwd},
           "tolerance_rel": KERNEL_RTOL, "adjoint": adjoint,
           "un_rule": un_rule, "grid": grid, "repeatable": True,
           "max_abs_err": max_abs, "kernel_ms": kernel_ms,
           "pass_ms": pass_ms, "plain_ms": plain_ms,
           **csc_iter_bound_ms(pos, C, T, False, False, emit_fwd),
           "kernel_tflops": (3 if emit_fwd else 1) * gflop / kernel_ms}
    if emit_fwd:
        out["forward_bf16_tflops"] = SPLIT_PASSES * 2 * gflop / pass_ms.get(
            "iter_fwd", float("nan"))
    else:
        # the profile of the form: the adjoint pass and the sums, no
        # forward pass; the full form timed beside it
        passes = " ".join(pass_ms)
        if "iter_fwd" in passes or not ("iter_main" in passes
                                        and "sums_kernel" in passes):
            raise AssertionError(f"csc_iter emit_fwd=False ran {pass_ms}, "
                                 "not iter_main and sums_kernel alone")
        out["full_ms"] = cuda_ms(run(tci.csc_iter, True), batch=batch)
        # the wrapper's host time per call (enqueue only, no sync): where
        # it exceeds the kernels' device time, the events time the host
        call = run(tci.csc_iter)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            call()
        out["host_ms"] = 1e3 * (time.perf_counter() - t0) / batch
        torch.cuda.synchronize()
        out["full_bound_ms"] = csc_iter_bound_ms(pos, C, T, False,
                                                 False)["bound_ms"]
    return out


def phase_kernel(dev, D):
    Wf, Wa, (pos, C, T) = headline_weights(dev, D)
    out = check_csc_iter(dev, Wf, Wa, pos, headline=True)
    # the fp32 rate cuBLAS reaches on this card for the kernel's two
    # product shapes (TF32 off): a check of the 67 TFLOP/s in the bound
    g = torch.Generator(device=dev).manual_seed(5)
    G2 = torch.randn((pos, T), generator=g, device=dev)
    Y = torch.randn((pos, C), generator=g, device=dev)
    with fp32_precision():
        adj_ms = cuda_ms(lambda: G2 @ Wa)
        fwd_ms = cuda_ms(lambda: Y @ Wf)
    gflop = 2 * pos * T * C / 1e9
    out["cublas_fp32_tflops"] = {"G2@Wa": gflop / adj_ms,
                                 "Y@Wf": gflop / fwd_ms}
    return out


def phase_parity(dev, D, S, lmbda):
    opt = ConvBPDN.options(max_iter=PARITY_ITERS, rel_stop_tol=0.0)
    runs = []
    for d in (dev, "cpu"):
        b = ConvBPDN(D, S, lmbda, opt=opt, device=d)
        Yd = b.solve()
        runs.append((b.getitstat(), {"Y": Yd.cpu().numpy(),
                                     "X": b.state.X.cpu().numpy()}))
    errs = compare_runs("parity", runs, ("ObjFun", "DFid", "RegL1", "Rho",
                                         "PrimalRsdl", "DualRsdl"), PARITY)
    return {"iterations": PARITY_ITERS, "rel_err": errs,
            "tolerance": PARITY}


def phase_solve(dev, D, S, lmbda):
    # warm-up: cuFFT plans, cuBLAS handles, allocator
    ConvBPDN(D, S, lmbda, opt=ConvBPDN.options(max_iter=3),
             device=dev).solve()
    b = ConvBPDN(D, S, lmbda, opt=ConvBPDN.options(
        max_iter=MAX_ITER, rel_stop_tol=REL_TOL), device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    X = b.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    its = b.getitstat()
    k = int(b.state.k)
    expect_launches(f"an ADMM solve of {k} iterations", counts,
                    csc_iter=k)
    loop = loop_reads(f"an ADMM solve of {k} iterations", k)
    if tuple(X.shape) != (N, N, 1, 1, M):
        raise AssertionError(f"coefficients have shape {tuple(X.shape)}")
    for name, t in (("Y", X), ("X", b.state.X), ("U", b.state.U)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} is not finite")
    if not (k < MAX_ITER and its.PrimalRsdl[-1] <= its.EPrimal[-1]
            and its.DualRsdl[-1] <= its.EDual[-1]):
        raise AssertionError(f"not converged to {REL_TOL} in {k} "
                             "iterations")
    if not (np.all(np.isfinite(its.ObjFun))
            and its.ObjFun[-1] < its.ObjFun[0]):
        raise AssertionError("objective not finite or not decreasing")
    nnz = float((b.state.Y != 0).float().mean())
    return {"iterations": k, "wall_s": wall, "iters_per_s": k / wall,
            "ms_per_iter": 1e3 * wall / k,
            "final_objective": float(its.ObjFun[-1]),
            "final_dfid": float(its.DFid[-1]),
            "final_rho": float(its.Rho[-1]), "nonzero_fraction": nnz,
            "launches": counts, "host_reads": loop["host_reads"],
            "device_loop": loop}


def pgm_options(max_iter=PGM_ITERS):
    return tpgm.ConvBPDN.options(max_iter=max_iter, rel_stop_tol=0.0,
                                 L=PGM_L)


def check_pgm_iter(dev, Wf, Wa, pos, seed=2):
    """``pgm_iter`` against its plain version on the card at (pos, C, T)
    over its flag grid (every output within KERNEL_RTOL), each output's
    error against float64 beside it, two launches alike, kernel and plain
    version timed."""
    C, T = Wf.shape
    wf3 = tci.split_weight(Wf)
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def sparse(*shape):
        return randn(*shape) * (torch.rand(shape, generator=g, device=dev)
                                < 0.05)
    G2 = randn(pos, T)
    Y0, X0 = sparse(pos, C), sparse(pos, C)
    thr_v = 0.01 + 0.02 * torch.rand(C, generator=g, device=dev)
    wl1_v = 0.5 + torch.rand(C, generator=g, device=dev)
    rL = 1.0 / PGM_L
    names = ("X", "Yn", "R1", "RX", "sums")
    grid, max_abs = [], 0.0
    for nonneg in (False, True):
        for vectors in (False, True):
            for beta in (0.0, 0.7):
                thr, wl1 = (thr_v, wl1_v) if vectors else (5e-4, 1.0)

                def run(fn, dt=torch.float32):
                    return fn(G2.to(dt), Y0.to(dt, copy=True),
                              X0.to(dt, copy=True), Wa.to(dt),
                              Wf.to(dt), thr, wl1, rL, beta, nonneg=nonneg)
                got = run(lambda *a, **k: tpi.pgm_iter(*a, **k,
                                                       wf_split=wf3))
                ref = run(tpi.pgm_iter_plain)
                errs, ae = compare_outputs(
                    "pgm_iter", names, got, ref,
                    f"(pos, C, T) = {(pos, C, T)} nonneg={nonneg} "
                    f"vectors={vectors} beta={beta}")
                max_abs = max(max_abs, ae)
                nnz = float((got[0] != 0).float().mean())
                grid.append({"nonneg": nonneg, "vectors": vectors,
                             "beta": beta, "x_nonzero": nnz,
                             "rel_err": errs,
                             "vs_float64": float64_errors(
                                 names, got, ref,
                                 run(tpi.pgm_iter_plain, torch.float64))})
    # the main path's configuration (scalar thr and wl1): repeatable,
    # timed, and by pass
    Y, X = Y0.clone(), X0.clone()

    dvals = device_scalars(G2.device, 5e-4, rL, 0.7)

    def run(fn):
        # the kernel with its scalars on the card, the plain version with
        # numbers (as csc_iter's)
        if fn is tpi.pgm_iter:
            live, thr_t, rl_t, beta_t = dvals
            return lambda: fn(G2, Y, X, Wa, Wf, thr_t, 1.0, rl_t, beta_t,
                              wf_split=wf3, live=live)
        return lambda: fn(G2, Y, X, Wa, Wf, 5e-4, 1.0, rL, 0.7,
                          wf_split=wf3)
    check_repeatable("pgm_iter", lambda: tpi.pgm_iter(
        G2, Y0.clone(), X0.clone(), Wa, Wf, 5e-4, 1.0, rL, 0.7,
        wf_split=wf3))
    # in batches of calls, as csc_iter's
    kernel_ms = cuda_ms(run(tpi.pgm_iter), batch=FFT_BATCH)
    pass_ms = device_ms_by_kernel(run(tpi.pgm_iter))
    plain_ms = cuda_ms(run(tpi.pgm_iter_plain), batch=FFT_BATCH)
    gflop = 2 * pos * T * C / 1e9
    return {"geometry": {"pos": pos, "C": C, "T": T},
            "tolerance_rel": KERNEL_RTOL, "grid": grid,
            "repeatable": True, "max_abs_err": max_abs,
            "kernel_ms": kernel_ms, "pass_ms": pass_ms,
            "plain_ms": plain_ms,
            **pgm_iter_bound_ms(pos, C, T, False),
            "kernel_tflops": 3 * gflop / kernel_ms,
            "forward_bf16_tflops": SPLIT_PASSES * 2 * gflop / pass_ms.get(
                "pgm_fwd", float("nan"))}


def phase_pgm_kernel(dev, D):
    Wf, Wa, (pos, _, _) = headline_weights(dev, D)
    return check_pgm_iter(dev, Wf, Wa, pos)


def phase_pgm_parity(dev, D, S, lmbda):
    W = (np.random.default_rng(3).random((N, N))
         >= MASK_MISSING).astype(np.float32)
    out = {}
    for masked in (False, True):
        cls = tpgm.ConvBPDNMask if masked else tpgm.ConvBPDN
        kw = {"W": W} if masked else {}
        runs = []
        for d in (dev, "cpu"):
            b = cls(D, S, lmbda, opt=pgm_options(PARITY_ITERS), device=d,
                    **kw)
            X = b.solve()
            runs.append((b.getitstat(), {"X": X.cpu().numpy(),
                                         "Y": b.state.Y.cpu().numpy()}))
        label = "masked" if masked else "unmasked"
        out[label] = compare_runs(f"FISTA parity ({label})", runs,
                                  ("ObjFun", "DFid", "RegL1", "Rsdl"),
                                  PGM_PARITY)
    return {"iterations": PARITY_ITERS, "mask_missing": MASK_MISSING,
            "rel_err": out, "tolerance": PGM_PARITY}


def phase_pgm_solve(dev, D, S, lmbda):
    # warm-up: cuBLAS handles, allocator
    tpgm.ConvBPDN(D, S, lmbda, opt=pgm_options(3), device=dev).solve()
    b = tpgm.ConvBPDN(D, S, lmbda, opt=pgm_options(), device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    X = b.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    its = b.getitstat()
    k = int(b.state.k)
    if k != PGM_ITERS:
        raise AssertionError(f"a FISTA solve of {k} iterations")
    expect_launches(f"a FISTA solve of {k} iterations", counts,
                    pgm_iter=k)
    loop = loop_reads(f"a FISTA solve of {k} iterations", k)
    if tuple(X.shape) != (N, N, 1, 1, M):
        raise AssertionError(f"coefficients have shape {tuple(X.shape)}")
    for name in ("X", "Y", "Xprv"):
        if not bool(torch.isfinite(getattr(b.state, name)).all()):
            raise AssertionError(f"{name} is not finite")
    if not (np.all(np.isfinite(its.ObjFun)) and np.all(its.Rsdl > 0)
            and its.ObjFun[-1] < its.ObjFun[0]):
        raise AssertionError("objective not finite or not decreasing")
    nnz = float((b.state.X != 0).float().mean())
    return {"iterations": k, "wall_ms": 1e3 * wall, "iters_per_s": k / wall,
            "ms_per_iter": 1e3 * wall / k,
            "final_objective": float(its.ObjFun[-1]),
            "final_dfid": float(its.DFid[-1]),
            "final_rsdl": float(its.Rsdl[-1]), "nonzero_fraction": nnz,
            "launches": counts, "host_reads": loop["host_reads"],
            "device_loop": loop}


def _rel_err(a, b, scale):
    return float((a - b).abs().max()) / scale


def device_ms_by_kernel(fn, reps=10, tries=3, need=()):
    """Device time per call of ``fn`` by kernel name, from
    ``torch.profiler`` over ``reps`` calls.  A profile that saw no device
    event at all, or fewer than ``reps`` launches of a kernel whose name
    holds a string of ``need`` (the profiler drops events now and then in
    a long run of profiles), is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile as tprof
    for _ in range(tries):
        torch.cuda.synchronize()
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events and all(sum(e.count for e in events if n in e.key) >= reps
                          for n in need):
            break
    out = {}
    for e in events:
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        key = e.key.replace("(anonymous namespace)::", "")
        key = key.replace("void ", "").split("(")[0][:48]
        out[key] = out.get(key, 0.0) + t / 1e3 / reps
    return out


def fft_pass_split(x, yr, yi):
    """Device time per call of each pass of both FFT kernels, each pass's
    share of its transform, the device time of torch.fft's call on the
    same inputs, and the kernels that ``ops.fft.irfftn`` runs on the
    complex64 spectrum, with their device time."""
    n1 = x.shape[-1]
    spec = torch.complex(yr, yi)
    fwd = device_ms_by_kernel(lambda: tfp.rfft2_planar(x),
                              need=("fft_rows_r2c_pow2", "fft_cols_pow2"))
    inv = device_ms_by_kernel(lambda: tfp.irfft2_planar(yr, yi, n1),
                              need=("fft_rows_c2r_pow2", "fft_cols_pow2"))
    libs = {"rfft2_planar": device_ms_by_kernel(lambda: torch.fft.rfft2(x)),
            "irfft2_planar": device_ms_by_kernel(
                lambda: torch.fft.irfft2(spec, s=x.shape[-2:]))}
    dispatch = device_ms_by_kernel(
        lambda: tsf.irfftn(spec, s=x.shape[-2:]))
    out = {}
    for name, by_kernel, row_kernel in (
            ("rfft2_planar", fwd, "fft_rows_r2c_pow2"),
            ("irfft2_planar", inv, "fft_rows_c2r_pow2")):
        rows = sum(t for k, t in by_kernel.items() if row_kernel in k)
        cols = sum(t for k, t in by_kernel.items() if "fft_cols_pow2" in k)
        if not (rows > 0 and cols > 0):
            raise AssertionError(f"the profiler did not see both passes "
                                 f"of {name}: {by_kernel}")
        total = rows + cols
        out[name] = {"device_ms": total, "rows_ms": rows, "cols_ms": cols,
                     "rows_share": rows / total, "cols_share": cols / total,
                     "library_device_ms": sum(libs[name].values())}
    own = ("fft_cols_pow2", "fft_rows_c2r_pow2")
    if sorted(k.split("<")[0] for k in dispatch) != sorted(own):
        raise AssertionError(f"irfftn on a complex64 spectrum ran "
                             f"{dispatch}, not the inverse's kernels alone")
    out["irfft2_planar"]["irfftn_device_ms"] = sum(dispatch.values())
    out["irfft2_planar"]["irfftn_kernels"] = sorted(dispatch)
    return out


def phase_fft_kernel(dev):
    """Both FFT kernels against their plain versions, cuFFT and float64
    references at FFT_SHAPES; kernel, plain and cuFFT timed at the first
    two shapes, and the device time of each kernel's passes at the
    first."""
    g = torch.Generator(device=dev).manual_seed(3)
    rows, timing, max_abs = [], {}, {}
    for (B, n0, n1) in FFT_SHAPES:
        x = torch.randn((B, n0, n1), generator=g, device=dev)
        yr, yi = tfp.rfft2_planar(x)
        pr, pi = tfp.rfft2_planar_plain(x)
        lib = torch.fft.rfft2(x)
        ref = torch.fft.rfft2(x.double())
        sc = float(ref.abs().max())
        fwd = {"ref": max(_rel_err(yr, ref.real, sc),
                          _rel_err(yi, ref.imag, sc)),
               "plain": max(_rel_err(yr, pr, sc), _rel_err(yi, pi, sc)),
               "cufft": max(_rel_err(yr, lib.real, sc),
                            _rel_err(yi, lib.imag, sc))}
        # the inverse of a random half-spectrum (not Hermitian), against
        # numpy's semantics (torch.fft on the CPU, float64) ...
        zr = torch.randn(yr.shape, generator=g, device=dev)
        zi = torch.randn(yr.shape, generator=g, device=dev)
        xb = tfp.irfft2_planar(zr, zi, n1)
        if not torch.equal(tfp.irfft2_spectrum(torch.complex(zr, zi), n1),
                           xb):
            raise AssertionError(f"irfft2_spectrum differs from the planar "
                                 f"call at {(B, n0, n1)}")
        xp = tfp.irfft2_planar_plain(zr, zi, n1)
        xref = torch.fft.irfft2(torch.complex(zr.double(), zi.double())
                                .cpu(), s=(n0, n1)).to(dev)
        # ... and of the spectrum of a real signal, against cuFFT and the
        # signal itself
        xr = tfp.irfft2_planar(yr, yi, n1)
        xlib = torch.fft.irfft2(lib, s=(n0, n1))
        inv = {"ref": _rel_err(xb, xref, 1.0),
               "plain": _rel_err(xb, xp, 1.0),
               "cufft": _rel_err(xr, xlib, 1.0),
               "round_trip": _rel_err(xr, x, 1.0)}
        where = f"(B, N0, N1) = {(B, n0, n1)}"
        for label, errs, tol in (("rfft2_planar", fwd, FFT_TOL["forward"]),
                                 ("irfft2_planar", inv,
                                  FFT_TOL["inverse"])):
            for key, e in errs.items():
                lim = tol if key in ("ref", "round_trip") else 2 * tol
                if not e <= lim:
                    raise AssertionError(f"{label} differs from {key} by "
                                         f"{e:.3e} (tolerance {lim:.0e}) "
                                         f"at {where}")
        rows.append({"shape": [B, n0, n1], "forward_rel_err": fwd,
                     "inverse_abs_err": inv})
        if len(timing) < 2:
            # the main path's shapes: 64 planes (generic x-step), 1 (glue)
            if not timing:
                max_abs = {"rfft2_planar": max(
                    float((yr - pr).abs().max()),
                    float((yi - pi).abs().max())),
                    "irfft2_planar": float((xb - xp).abs().max())}
            bound, by = fft_bound_ms(B, n0, n1)

            def ms(fn):
                return cuda_ms(fn, batch=FFT_BATCH)
            timing[B] = {
                "rfft2_planar": {
                    "ms": ms(lambda: tfp.rfft2_planar(x)),
                    "plain_ms": ms(lambda: tfp.rfft2_planar_plain(x)),
                    "library_ms": ms(lambda: torch.fft.rfft2(x))},
                "irfft2_planar": {
                    "ms": ms(lambda: tfp.irfft2_planar(yr, yi, n1)),
                    "plain_ms": ms(
                        lambda: tfp.irfft2_planar_plain(yr, yi, n1)),
                    "library_ms": ms(
                        lambda: torch.fft.irfft2(lib, s=(n0, n1)))},
                # the dispatch on cuFFT's complex64 spectrum, as the
                # solvers call it
                "irfftn": {"ms": ms(lambda: tsf.irfftn(lib, s=(n0, n1)))},
                "bound_ms": bound, "bound_by": by}
            timing[B]["irfftn"]["library_ms"] = \
                timing[B]["irfft2_planar"]["library_ms"]
            for name in ("rfft2_planar", "irfft2_planar", "irfftn"):
                t = timing[B][name]
                t["vs_library"] = t["ms"] / t["library_ms"]
            if B == M:
                for name, split in fft_pass_split(x, yr, yi).items():
                    timing[B][name]["passes"] = split
    return {"tolerance": FFT_TOL, "shapes": rows,
            "timing": {f"B={b}": t for b, t in timing.items()},
            "max_abs_err": max_abs, "headline": timing[M]}


def phase_generic_parity(dev, D, S, lmbda):
    opt = ConvBPDN.options(max_iter=PARITY_ITERS, rel_stop_tol=0.0)
    runs = []
    for d in (dev, "cpu"):
        with planar_fft("auto" if d == dev else "always"):
            b = ConvBPDN(D, S, lmbda, opt=opt, device=d, fused=False)
            Yd = b.solve()
        runs.append((b.getitstat(), {"Y": Yd.cpu().numpy(),
                                     "X": b.state.X.cpu().numpy()}))
    errs = compare_runs("generic parity", runs,
                        ("ObjFun", "DFid", "RegL1", "Rho", "PrimalRsdl",
                         "DualRsdl"), PARITY)
    return {"iterations": PARITY_ITERS, "rel_err": errs,
            "tolerance": PARITY}


def _timed_solve(b):
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    X = b.solve()
    torch.cuda.synchronize()
    return X, time.perf_counter() - t0, launches()


def phase_generic_solve(dev, D, S, lmbda, fused):
    def model(**kw):
        return ConvBPDN(D, S, lmbda, opt=ConvBPDN.options(
            max_iter=MAX_ITER, rel_stop_tol=REL_TOL), device=dev, **kw)
    # warm-up: kernels, cuBLAS handles, allocator
    ConvBPDN(D, S, lmbda, opt=ConvBPDN.options(max_iter=3), device=dev,
             fused=False).solve()
    b = model(fused=False)
    X, wall, counts = _timed_solve(b)
    its = b.getitstat()
    k = int(b.state.k)
    expect_launches(f"a generic ADMM solve of {k} iterations", counts,
                    rfft2_planar=k + 2, irfft2_planar=k)
    loop_g = generic_loop(f"a generic ADMM solve of {k} iterations", b, k)
    if tuple(X.shape) != (N, N, 1, 1, M) or not all(
            bool(torch.isfinite(t).all()) for t in (X, b.state.X,
                                                   b.state.U)):
        raise AssertionError("generic solve: bad shape or not finite")
    if not (k < MAX_ITER and its.PrimalRsdl[-1] <= its.EPrimal[-1]
            and its.DualRsdl[-1] <= its.EDual[-1]):
        raise AssertionError(f"generic solve not converged to {REL_TOL} "
                             f"in {k} iterations")
    obj = float(its.ObjFun[-1])
    agree = abs(obj - fused["final_objective"]) / fused["final_objective"]
    if not (np.all(np.isfinite(its.ObjFun)) and agree <= OBJ_AGREE):
        raise AssertionError(f"generic objective {obj} against the fused "
                             f"solve's {fused['final_objective']}")
    # the fused solve at the default precision: its glue runs the FFT
    # kernels on one plane (setup 2, per iteration 1 + 1, final x-step
    # 1 + 1)
    bf = model()
    _, wall_f, counts_f = _timed_solve(bf)
    kf = int(bf.state.k)
    expect_launches(f"a fused ADMM solve of {kf} iterations at highest",
                    counts_f, csc_iter=kf, rfft2_planar=kf + 3,
                    irfft2_planar=kf + 1)
    loop_f = loop_reads(f"a fused ADMM solve of {kf} iterations at "
                        "highest", kf)
    return {"iterations": k, "wall_s": wall, "iters_per_s": k / wall,
            "ms_per_iter": 1e3 * wall / k, "final_objective": obj,
            "fused_final_objective": fused["final_objective"],
            "fused_iterations": fused["iterations"],
            "objective_rel_diff": agree, "final_dfid": float(its.DFid[-1]),
            "final_rho": float(its.Rho[-1]), "launches": counts,
            "host_reads": loop_g["host_reads"], "route": loop_g["route"],
            "device_loop": loop_g,
            "fused_highest": {"iterations": kf, "wall_s": wall_f,
                              "final_objective": float(
                                  bf.getitstat().ObjFun[-1]),
                              "launches": counts_f,
                              "host_reads": loop_f["host_reads"],
                              "device_loop": loop_f}}


def phase_pgm_generic_solve(dev, D, S, lmbda):
    W = (np.random.default_rng(3).random((N, N))
         >= MASK_MISSING).astype(np.float32)
    out = {}
    for masked in (False, True):
        cls = tpgm.ConvBPDNMask if masked else tpgm.ConvBPDN
        kw = {"W": W} if masked else {}
        cls(D, S, lmbda, opt=pgm_options(3), device=dev, fused=False,
            **kw).solve()
        b = cls(D, S, lmbda, opt=pgm_options(PGM_GENERIC_ITERS), device=dev,
                fused=False, **kw)
        X, wall, counts = _timed_solve(b)
        its = b.getitstat()
        k = int(b.state.k)
        # per iteration: gradient 1 + 1 (2 + 2 masked), objective 1 + 0
        # (1 + 1 masked); the setup's D and S
        fwd, inv = (3, 3) if masked else (2, 1)
        label = "masked" if masked else "unmasked"
        if k != PGM_GENERIC_ITERS:
            raise AssertionError(f"generic FISTA ({label}) ran {k} "
                                 "iterations")
        expect_launches(f"a generic FISTA solve ({label})", counts,
                        rfft2_planar=fwd * k + 2, irfft2_planar=inv * k)
        loop = generic_loop(f"a generic FISTA solve ({label})", b, k)
        if not (bool(torch.isfinite(X).all())
                and np.all(np.isfinite(its.ObjFun))
                and its.ObjFun[-1] < its.ObjFun[0]):
            raise AssertionError(f"generic FISTA ({label}): objective not "
                                 "finite or not decreasing")
        out[label] = {"iterations": k, "wall_s": wall,
                      "iters_per_s": k / wall, "ms_per_iter": 1e3 * wall / k,
                      "final_objective": float(its.ObjFun[-1]),
                      "final_rsdl": float(its.Rsdl[-1]),
                      "launches": counts, "host_reads": loop["host_reads"],
                      "route": loop["route"], "device_loop": loop,
                      "predicted": {"rfft2_planar": f"{fwd} k + 2",
                                    "irfft2_planar": f"{inv} k"}}
    return out


COND_CHAIN = 50         # the flat chain of IF nodes timed in cond_node
COND_NESTED = 8         # the depth of nested IF nodes checked there


def phase_cond_node(dev):
    """The device loop's conditional nodes (``csrc/cond_node.cu``).  IF
    (``device_loop.when``): a captured node whose body adds 1 runs it where
    its flag is true and skips it where false, at replay; a chain of
    COND_NESTED nested nodes stops at the first false flag; a flat chain
    of COND_CHAIN nodes (the line search's groups are one) runs as many
    bodies as its flags allow, and its time with every node but the
    first skipped, over the nodes skipped, is what a skipped node
    costs.  WHILE (``device_loop.while_``): ``while_node_checks``."""
    x = torch.zeros((), device=dev)
    pred = torch.zeros((), dtype=torch.bool, device=dev)
    g = device_loop._capture(lambda: device_loop.when(
        pred, lambda: x.add_(1.0)), dev)
    seen = []
    for flag in (True, False, True):
        pred.fill_(flag)
        g.replay()
        seen.append(float(x))
    if seen != [1.0, 1.0, 2.0]:
        raise AssertionError(f"IF node: the body's count {seen} at flags "
                             "1, 0, 1")
    c = torch.zeros((), device=dev)
    lim = torch.zeros((), device=dev)

    def level(i):
        c.add_(1.0)
        if i + 1 < COND_NESTED:
            device_loop.when(c < lim, lambda: level(i + 1))
    gn = device_loop._capture(lambda: level(0), dev)
    nested = {}
    for n in (0, 3, COND_NESTED + 5):
        c.zero_()
        lim.fill_(n)
        gn.replay()
        nested[n] = float(c)
    if nested != {0: 1.0, 3: 3.0, COND_NESTED + 5: float(COND_NESTED)}:
        raise AssertionError(f"nested IF nodes ran {nested} levels")
    go = torch.zeros((), dtype=torch.bool, device=dev)

    def body():
        c.add_(1.0)
        torch.lt(c, lim, out=go)

    def chain():
        body()
        for _ in range(COND_CHAIN - 1):
            device_loop.when(go, body)
    gf = device_loop._capture(chain, dev)
    flat = {}
    for n in (0, 7, 2 * COND_CHAIN):
        c.zero_()
        lim.fill_(n)
        gf.replay()
        flat[n] = float(c)
    if flat != {0: 1.0, 7: 7.0, 2 * COND_CHAIN: float(COND_CHAIN)}:
        raise AssertionError(f"a flat chain of IF nodes ran {flat} bodies")
    times = {}
    for n in (0, 2 * COND_CHAIN):
        lim.fill_(n)
        times[n] = cuda_ms(lambda: (c.zero_(), gf.replay()), 20)
    torch.cuda.synchronize()
    return {"single": seen, "nested": nested, "flat": flat,
            "flat_ms_all_skipped": times[0],
            "flat_ms_all_run": times[2 * COND_CHAIN],
            "us_per_skipped_node": 1e3 * times[0] / (COND_CHAIN - 1),
            **while_node_checks(dev)}


WHILE_PASSES = (0, 1, 7, 1000)   # the limits a captured WHILE node runs


def while_node_checks(dev):
    """The device loop's WHILE node (``device_loop.while_``): one captured
    graph runs its body n times for a limit n written before each replay
    (WHILE_PASSES); a WHILE node in an IF node's body and an IF node in a
    WHILE body run as their flags say; a pass's µs, from the replay's
    time at 1000 passes less its time at 0, over 1000 (the body one add
    and one compare, each a one-element kernel, and the set-condition
    kernel that ends it)."""
    c = torch.zeros((), device=dev)
    lim = torch.zeros((), device=dev)
    go = torch.zeros((), dtype=torch.bool, device=dev)

    def body():
        c.add_(1.0)
        torch.lt(c, lim, out=go)

    def loop():
        torch.lt(c, lim, out=go)
        device_loop.while_(go, body)
    gw = device_loop._capture(loop, dev)
    passes = {}
    for n in WHILE_PASSES:
        c.zero_()
        lim.fill_(n)
        gw.replay()
        passes[n] = float(c)
    if passes != {n: float(n) for n in WHILE_PASSES}:
        raise AssertionError(f"WHILE node: passes {passes} at limits "
                             f"{WHILE_PASSES}")
    odd = torch.zeros((), device=dev)
    on = torch.zeros((), dtype=torch.bool, device=dev)

    def odd_body():
        c.add_(1.0)
        device_loop.when(torch.remainder(c, 2.0) == 1.0,
                         lambda: odd.add_(1.0))
        torch.lt(c, lim, out=go)

    def while_in_if():
        torch.lt(c, lim, out=go)
        device_loop.while_(go, odd_body)
    gn = device_loop._capture(lambda: device_loop.when(on, while_in_if),
                              dev)
    nested = {}
    for flag, n in ((True, 5), (False, 5), (True, 0), (True, 8)):
        c.zero_()
        odd.zero_()
        on.fill_(flag)
        lim.fill_(n)
        gn.replay()
        nested[f"{int(flag)}/{n}"] = [float(c), float(odd)]
    want = {"1/5": [5.0, 3.0], "0/5": [0.0, 0.0], "1/0": [0.0, 0.0],
            "1/8": [8.0, 4.0]}
    if nested != want:
        raise AssertionError(f"WHILE in IF, IF in WHILE: (passes, odd "
                             f"passes) {nested}, not {want}")
    times = {}
    for n in (0, WHILE_PASSES[-1]):
        lim.fill_(n)
        times[n] = cuda_ms(lambda: (c.zero_(), gw.replay()), 20)
    torch.cuda.synchronize()
    return {"while_passes": passes, "while_if_nested": nested,
            "while_ms_0_passes": times[0],
            "while_ms_1000_passes": times[WHILE_PASSES[-1]],
            "us_per_while_pass": 1e3 * (times[WHILE_PASSES[-1]] - times[0])
            / WHILE_PASSES[-1]}


# the line-search FISTA solves of bt_solve: iterations, and a first L
# below the headline's Lipschitz constant, which the first search raises
# over several trials; a bt_maxiter past the 64 trials that once sent a
# search to the eager route
BT_ITERS, BT_L, BT_LONG = 24, 1.0, 200


def _bt_model(D, S, lmbda, dev, backtrack, route, bt_maxiter=None):
    kw = {} if bt_maxiter is None else {"bt_maxiter": bt_maxiter}
    b = tpgm.ConvBPDN(D, S, lmbda, device=dev, fused=False,
                      opt=tpgm.ConvBPDN.options(
                          max_iter=BT_ITERS, rel_stop_tol=0.0, L=BT_L,
                          backtrack=backtrack, **kw))
    if route == "eager":
        # the same problem declared eager: one host read a trial
        b.problem = dataclasses.replace(b.problem, route="eager")
    return b


@contextlib.contextmanager
def capture_seconds():
    """The host seconds of each CUDA-graph capture of the device loop
    (``device_loop._capture``, its warm-up included, synchronised before
    and after) made inside the block."""
    seen = []
    capture = device_loop._capture

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = capture(*a, **k)
        torch.cuda.synchronize()
        seen.append(time.perf_counter() - t0)
        return g
    device_loop._capture = timed
    try:
        yield seen
    finally:
        device_loop._capture = capture


def _equal_rows(label, a, b):
    """Fail unless the stats rows ``a`` and ``b`` are equal to the bit
    (NaN where NaN)."""
    bad = [n for n in a._names if not np.array_equal(
        getattr(a, n), getattr(b, n), equal_nan=True)]
    if bad:
        raise AssertionError(f"{label}: rows {bad} differ: "
                             + "; ".join(f"{n} {getattr(a, n)} against "
                                         f"{getattr(b, n)}" for n in bad))


def phase_bt_solve(dev, D, S, lmbda):
    """Generic FISTA with each line search (standard, robust) on the
    headline, BT_ITERS iterations in float32: on the graph route (the
    search a WHILE node; no flag read, one host read a block) against the
    same problem declared eager (one host read a trial): the same
    arithmetic, so every stats row equal to the bit, ``IterBTrack`` among
    them, and the same FFT launches; the standard search also at
    ``bt_maxiter`` BT_LONG on the graph route (equal to the default's
    where no search reaches the default's cap).  For each: ms an
    iteration (the graph's a replay of the kept loop), the first solve's
    seconds, its captures' seconds and the memory its graph pool took."""
    out = {}
    for bt in ("standard", "robust"):
        r = {}
        runs = [("graph", "graph", None), ("eager", "eager", None)]
        if bt == "standard":
            runs.append(("graph_200", "graph", BT_LONG))
        for label, route, n in runs:
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_reserved(dev)
            b = _bt_model(D, S, lmbda, dev, bt, route, n)
            with capture_seconds() as caps:
                first, _ = _timed(b)
            mem1 = torch.cuda.memory_reserved(dev)
            b = _bt_model(D, S, lmbda, dev, bt, route, n)
            wall, counts = _timed(b)
            its = b.getitstat()
            k = len(its)
            last = dict(device_loop.LAST)
            if k != BT_ITERS or (LOOP_GRAPH and (
                    last["route"] != route
                    or last["graph"] != (route == "graph"))):
                raise AssertionError(f"FISTA ({bt}, {label}): {k} "
                                     f"iterations, record {last}")
            if LOOP_GRAPH and route == "graph" and (
                    last["flag_reads"] != 0 or last["captured"]):
                raise AssertionError(f"FISTA ({bt}, {label}): the graph "
                                     f"route read flags or captured "
                                     f"again: {last}")
            exact_reads(f"FISTA ({bt}, {label})", k)
            if not (np.all(np.isfinite(its._arr)) and
                    its.ObjFun[-1] < its.ObjFun[0]):
                raise AssertionError(f"FISTA ({bt}, {label}): objective "
                                     "not finite or not decreasing")
            r[label] = {"rows": its, "launches": counts, "wall_s": wall,
                        "ms_per_iter": 1e3 * wall / k,
                        "first_solve_s": first, "capture_s": caps,
                        "reserved_MB": (mem1 - mem0) / 2 ** 20,
                        "bt_maxiter": b.opts.bt_maxiter,
                        "flag_reads": last["flag_reads"],
                        "host_reads": last["host_reads"]}
        g = r["graph"]
        ibt = g["rows"].IterBTrack
        for label in r:
            if label == "graph" or (label == "graph_200"
                                    and ibt.max() >= g["bt_maxiter"]):
                continue
            _equal_rows(f"FISTA ({bt}): graph against {label}",
                        g["rows"], r[label]["rows"])
            if g["launches"] != r[label]["launches"]:
                raise AssertionError(f"FISTA ({bt}): launches "
                                     f"{g['launches']} (graph) against "
                                     f"{r[label]['launches']} ({label})")
        for v in r.values():
            del v["rows"]
        out[bt] = {"iterations": BT_ITERS, "rows_equal": True,
                   "trials": int(ibt.sum()), "max_trials": int(ibt.max()),
                   **r}
    return out


def phase_tail_kernel(dev):
    """admm_tail against its plain version at TAIL_SHAPES over the flag
    grid (per-channel or scalar thr/wl1, nonneg, us); kernel and plain
    version timed at the headline layout."""
    g = torch.Generator(device=dev).manual_seed(4)

    def arrays(R, C):
        PX = torch.randn((R, C), generator=g, device=dev)
        PY = torch.randn((R, C), generator=g, device=dev) * (
            torch.rand((R, C), generator=g, device=dev) < 0.05)
        PU = 0.01 * torch.randn((R, C), generator=g, device=dev)
        thr_v = 0.01 + 0.02 * torch.rand(C, generator=g, device=dev)
        wl1_v = 0.5 + torch.rand(C, generator=g, device=dev)
        return PX, PY, PU, thr_v, wl1_v
    grid, max_abs, sums_rel = [], 0.0, 0.0
    for R, C in TAIL_SHAPES:
        PX, PY0, PU0, thr_v, wl1_v = arrays(R, C)
        for vectors in (False, True):
            for nonneg in (False, True):
                for us in (1.0, 0.9):
                    thr, wl1 = (thr_v, wl1_v) if vectors else (0.0143, 1.0)
                    outs = []
                    for fn in (tct.admm_tail, tct.admm_tail_plain):
                        outs.append(fn(PX, PY0.clone(), PU0.clone(), thr,
                                       wl1, 1.8, nonneg=nonneg, us=us))
                    where = (f"(R, C) = {(R, C)} vectors={vectors} "
                             f"nonneg={nonneg} us={us}")
                    errs, ae = compare_outputs(
                        "admm_tail", ("PYn", "PUn", "sums"), *outs, where)
                    # each sum to KERNEL_RTOL of itself
                    srel = float(((outs[0][2] - outs[1][2]).abs()
                                  / outs[1][2].abs().clamp_min(1e-30))
                                 .max())
                    if srel > KERNEL_RTOL:
                        raise AssertionError(
                            f"admm_tail sums differ by {srel:.3e} relative "
                            f"at {where}")
                    max_abs = max(max_abs, ae)
                    sums_rel = max(sums_rel, srel)
                    grid.append({"shape": [R, C], "vectors": vectors,
                                 "nonneg": nonneg, "us": us,
                                 "rel_err": errs, "sums_rel_err": srel})
    # time the main path's configuration (per-filter weights, us != 1)
    R, C = TAIL_SHAPES[0]
    PX, PY, PU, thr_v, wl1_v = arrays(R, C)

    live, us_t = device_scalars(PX.device, 0.9)

    def run(fn):
        # the kernel with us on the card, the plain version with a number
        # (as csc_iter's)
        if fn is tct.admm_tail:
            return lambda: fn(PX, PY, PU, thr_v, wl1_v, 1.8, us=us_t,
                              live=live)
        return lambda: fn(PX, PY, PU, thr_v, wl1_v, 1.8, us=0.9)
    kernel_ms = cuda_ms(run(tct.admm_tail), batch=10)
    plain_ms = cuda_ms(run(tct.admm_tail_plain), batch=10)
    bound_ms, bound_by = tail_bound_ms(R, C, True)
    return {"tolerance_rel": KERNEL_RTOL, "grid": grid,
            "max_abs_err": max_abs, "sums_max_rel_err": sums_rel,
            "geometry": {"R": R, "C": C}, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "achieved_gb_per_s": 5 * 4 * R * C / kernel_ms / 1e6}


def gradreg_problem(D):
    """The headline dictionary with its last filter made an impulse, whose
    map carries the smooth part of the image (``examples/csc_gradreg.py``):
    GradWeight 1 on it and 0 elsewhere, L1Weight 0 on it and 1
    elsewhere."""
    m = D.shape[-1]
    Dg = D.copy()
    Dg[..., -1] = 0.0
    Dg[0, 0, -1] = 1.0
    wgrd = np.zeros(m, np.float32)
    wgrd[-1] = 1.0
    wl1 = np.ones((1, 1, 1, 1, m), np.float32)
    wl1[..., -1] = 0.0
    return Dg, dict(mu=GRAD_MU, wgrd=wgrd, wl1=wl1)


def admm_options(cls, max_iter=MAX_ITER, rel_stop_tol=REL_TOL):
    return cls.options(max_iter=max_iter, rel_stop_tol=rel_stop_tol)


def phase_gradreg_parity(dev, Dg, S, kw):
    opt = admm_options(ConvBPDNGradReg, PARITY_ITERS, 0.0)
    runs = []
    for d in (dev, "cpu"):
        b = ConvBPDNGradReg(Dg, S, LMBDA, opt=opt, device=d, **kw)
        Yd = b.solve()
        runs.append((b.getitstat(), {"Y": Yd.cpu().numpy(),
                                     "X": b.state.X.cpu().numpy()}))
    errs = compare_runs("gradreg parity", runs,
                        ("ObjFun", "DFid", "RegL1", "RegGrad", "Rho",
                         "PrimalRsdl", "DualRsdl"), PARITY)
    return {"iterations": PARITY_ITERS, "rel_err": errs,
            "tolerance": PARITY}


def phase_gradreg_layout(dev, D, S):
    """The gradreg problem cut to each of GRAD_LAYOUTS: 10 iterations on
    the card, where the tail kernel must run once per iteration (the JAX
    package's tail_eligible rejects these layouts; the CUDA kernel takes
    any), against the CPU."""
    opt = admm_options(ConvBPDNGradReg, PARITY_ITERS, 0.0)
    out = {}
    for n, m in GRAD_LAYOUTS:
        Dg, kw = gradreg_problem(np.ascontiguousarray(D[..., :m]))
        Sn = np.ascontiguousarray(S[:n, :n])
        runs = []
        for d in (dev, "cpu"):
            b = ConvBPDNGradReg(Dg, Sn, LMBDA, opt=opt, device=d, **kw)
            if d is dev:
                _, _, counts = _timed_solve(b)
            else:
                b.solve()
            runs.append((b.getitstat(), {"Y": b.state.Y.cpu().numpy(),
                                         "X": b.state.X.cpu().numpy()}))
        label = f"gradreg at {n}x{n}, M = {m}"
        k = PARITY_ITERS
        planar = tfp.supported(n, n, torch.float32)
        expect_launches(label, counts, admm_tail=k,
                        rfft2_planar=k + 3 if planar else 0,
                        irfft2_planar=k if planar else 0)
        errs = compare_runs(label, runs,
                            ("ObjFun", "DFid", "RegL1", "RegGrad", "Rho",
                             "PrimalRsdl", "DualRsdl"), PARITY)
        out[f"{n}x{n}x{m}"] = {"rows": (n // PS) ** 2, "C": PS * PS * m,
                               "launches": counts, "rel_err": errs}
    return out


def _variant_solves(label, make, fused_want, generic_want, xshape=None):
    """A fused solve and the generic solve (``fused=False``) of the same
    problem, each timed after a 3-iteration warm-up; the launches of each
    must be ``fused_want(k)`` / ``generic_want(k)``, the coefficients of
    shape ``xshape``, the final objectives must agree within OBJ_AGREE,
    and both must reach the stopping tolerance."""
    xshape = xshape or (N, N, 1, 1, M)
    out = {}
    for route, want in (("fused", fused_want), ("generic", generic_want)):
        kw = {} if route == "fused" else {"fused": False}
        make(max_iter=3, **kw).solve()
        b = make(**kw)
        X, wall, counts = _timed_solve(b)
        its = b.getitstat()
        k = int(b.state.k)
        expect_launches(f"a {route} {label} solve of {k} iterations",
                        counts, **want(k))
        loop = (loop_reads(f"a fused {label} solve of {k} iterations", k)
                if route == "fused" else {})
        if tuple(X.shape) != xshape or not all(
                bool(torch.isfinite(t).all()) for t in (X, b.state.X,
                                                       b.state.U)):
            raise AssertionError(f"{route} {label}: bad shape or not "
                                 "finite")
        done = (its.PrimalRsdl[-1] <= its.EPrimal[-1]
                and its.DualRsdl[-1] <= its.EDual[-1])
        if not (k < MAX_ITER and done):
            raise AssertionError(f"{route} {label} not converged to "
                                 f"{REL_TOL} in {k} iterations")
        if not (np.all(np.isfinite(its.ObjFun))
                and its.ObjFun[-1] < its.ObjFun[0]):
            raise AssertionError(f"{route} {label}: objective not finite "
                                 "or not decreasing")
        out[route] = {"iterations": k, "converged": bool(done),
                      "wall_s": wall, "iters_per_s": k / wall,
                      "ms_per_iter": 1e3 * wall / k,
                      "final_objective": float(its.ObjFun[-1]),
                      "final_primal_rsdl": float(its.PrimalRsdl[-1]),
                      "final_rho": float(its.Rho[-1]),
                      "nonzero_fraction": float(
                          (b.state.Y != 0).float().mean()),
                      "launches": counts, **({"host_reads": loop[
                          "host_reads"], "device_loop": loop}
                                             if loop else {})}
    fo, go = out["fused"]["final_objective"], out["generic"]["final_objective"]
    agree = abs(fo - go) / abs(go)
    if not agree <= OBJ_AGREE:
        raise AssertionError(f"{label}: fused objective {fo} against the "
                             f"generic solve's {go}")
    out["objective_rel_diff"] = agree
    out["launches"] = out["fused"]["launches"]
    return out


def phase_gradreg_solve(dev, Dg, S, kw):
    def make(max_iter=MAX_ITER, **extra):
        return ConvBPDNGradReg(Dg, S, LMBDA, device=dev, **kw, **extra,
                               opt=admm_options(ConvBPDNGradReg, max_iter))
    # fused: setup D, S and the gradient filters, then per iteration the
    # x-step's pair on 64 planes and one tail; the generic path the same
    # transforms
    out = _variant_solves(
        "gradreg", make,
        lambda k: dict(admm_tail=k, rfft2_planar=k + 3, irfft2_planar=k),
        lambda k: dict(rfft2_planar=k + 3, irfft2_planar=k))
    out["predicted"] = {"admm_tail": "k", "rfft2_planar": "k + 3",
                        "irfft2_planar": "k"}
    return out


def phase_elastic_solve(dev, D, S):
    def make(max_iter=MAX_ITER, **extra):
        return ConvElasticNet(D, S, LMBDA, mu=ELASTIC_MU, device=dev,
                              **extra,
                              opt=admm_options(ConvElasticNet, max_iter))
    # fused at "highest": the glue's pair on one plane per iteration,
    # setup D and S, the final x-step's pair
    return _variant_solves(
        "elastic", make,
        lambda k: dict(csc_iter=k, rfft2_planar=k + 3,
                       irfft2_planar=k + 1),
        lambda k: dict(rfft2_planar=k + 2, irfft2_planar=k))


def phase_wl1_spatial_solve(dev, D, S):
    W = (0.5 + np.random.default_rng(5).random((N, N, M))).astype(
        np.float32)

    def make(max_iter=MAX_ITER, **extra):
        return ConvBPDN(D, S, LMBDA, wl1=W, device=dev, **extra,
                        opt=admm_options(ConvBPDN, max_iter))
    # fused body: the spatial x-step's pair on one plane per iteration,
    # the torch-op tail, X carried (no final x-step)
    return _variant_solves(
        "spatial-L1Weight", make,
        lambda k: dict(rfft2_planar=k + 2, irfft2_planar=k),
        lambda k: dict(rfft2_planar=k + 2, irfft2_planar=k))


def colour_problem(seed=1, n=None):
    """The colour problems' data: a 512x512x3 image (n x n x 3, N by
    default), three channels of the headline's smoothed noise, and 64
    filters of 8x8x3 from a normal draw, each normalised (the shape of
    the dictionary pack's ``RGB:8x8x3x64``)."""
    from scipy.ndimage import gaussian_filter
    n = n or N
    rng = np.random.default_rng(seed)
    Dc = rng.standard_normal((ND, ND, 3, M)).astype(np.float32)
    Dc /= np.sqrt((Dc ** 2).sum(axis=(0, 1, 2), keepdims=True))
    S = np.stack([gaussian_filter(rng.standard_normal((n, n)), 8.0) * 5.0
                  + 0.1 * rng.standard_normal((n, n)) for _ in range(3)],
                 axis=-1)
    return Dc, S.astype(np.float32)


def colour_weights(dev, Dc):
    """``xstep_kernels`` of a (ND, ND, C, M) dictionary."""
    return xstep_kernels(torch.as_tensor(Dc).permute(2, 3, 0, 1)
                         .contiguous().to(dev), ND, ND, PS)[:2]


def phase_clr_kernel(dev, D, Dc):
    """Both packed-state kernels at the colour geometries: T = 768 taps
    (the colour dictionary's weights) and pos = 12288 rows (three image
    channels folded into the batch, the headline weights); ``csc_iter``
    also at T = 512 with MultiDictConvBPDN's weights (Cd = 2, the
    dictionary its fused solve in ``csc_variants_solve`` builds)."""
    Wfc, Wac = colour_weights(dev, Dc)
    Wf, Wa, (pos, _, _) = headline_weights(dev, D)
    out = {}
    for label, (wf, wa, p) in (("colour_dict", (Wfc, Wac, pos)),
                               ("folded", (Wf, Wa, 3 * pos))):
        out[label] = {"csc_iter": check_csc_iter(dev, wf, wa, p,
                                                 headline=False),
                      "pgm_iter": check_pgm_iter(dev, wf, wa, p)}
    Wfm, Wam = colour_weights(dev, multidict_dict(D))
    out["multidict"] = {"csc_iter": check_csc_iter(dev, Wfm, Wam, pos,
                                                   headline=False)}
    return out


def phase_clr_parity(dev, D, Dc, S3):
    """10 iterations on the card against the port on the CPU: the colour
    dictionary on fused ADMM and fused FISTA (unmasked, and with a
    per-channel mask missing MASK_MISSING of the pixels), and the grey
    dictionary on the colour image, folded, on fused ADMM."""
    W3 = (np.random.default_rng(4).random((N, N, 3))
          >= MASK_MISSING).astype(np.float32)
    cases = {
        "colour_admm": (ConvBPDN, Dc, {}),
        "colour_fista": (tpgm.ConvBPDN, Dc, {}),
        "colour_fista_masked": (tpgm.ConvBPDNMask, Dc, {"W": W3}),
        "folded_admm": (ConvBPDN, D, {})}
    out = {}
    for label, (cls, Dl, kw) in cases.items():
        admm = cls is ConvBPDN
        opt = (admm_options(ConvBPDN, PARITY_ITERS, 0.0) if admm
               else pgm_options(PARITY_ITERS))
        runs = []
        for d in (dev, "cpu"):
            b = cls(Dl, S3, LMBDA, opt=opt, device=d, dimK=0, **kw)
            if d is dev:
                counts = _timed_solve(b)[2]
                k = PARITY_ITERS
                # the fused ADMM glue's transforms (at "highest"): setup
                # D and S, a pair per iteration, the final x-step's pair
                expect_launches(label, counts, **(
                    dict(csc_iter=k, rfft2_planar=k + 3,
                         irfft2_planar=k + 1) if admm else
                    dict(pgm_iter=k)))
            else:
                b.solve()
            runs.append((b.getitstat(), {"Y": b.state.Y.cpu().numpy(),
                                         "X": b.state.X.cpu().numpy()}))
        if admm:
            out[label] = compare_runs(
                label, runs, ("ObjFun", "DFid", "RegL1", "Rho",
                              "PrimalRsdl", "DualRsdl"), PARITY)
        else:
            out[label] = compare_runs(label, runs, ("ObjFun", "DFid",
                                                    "RegL1", "Rsdl"),
                                      PGM_PARITY)
    return {"iterations": PARITY_ITERS, "rel_err": out,
            "tolerance": {"admm": PARITY, "fista": PGM_PARITY}}


def phase_clr_solve(dev, Dc, S3):
    """The colour dictionary to 1e-3 by ADMM, l1 and the elastic net,
    fused (the rank-3 glue's transforms on three planes: setup D and S,
    a pair per iteration, the final x-step's pair) against generic."""
    out = {}
    for label, cls, kw in (("l1", ConvBPDN, {}),
                           ("elastic", ConvElasticNet,
                            {"mu": ELASTIC_MU})):
        def make(max_iter=MAX_ITER, cls=cls, kw=kw, **extra):
            return cls(Dc, S3, LMBDA, device=dev, dimK=0, **kw, **extra,
                       opt=admm_options(cls, max_iter))
        out[label] = _variant_solves(
            f"colour {label}", make,
            lambda k: dict(csc_iter=k, rfft2_planar=k + 3,
                           irfft2_planar=k + 1),
            lambda k: dict(rfft2_planar=k + 2, irfft2_planar=k))
    return out


def _fista_solves(label, make, fused_want, generic_want, xshape):
    """A fused FISTA solve at L = 100 and the generic one of the same
    problem, PGM_ITERS iterations each after a 3-iteration warm-up; the
    launches of each must be ``fused_want(k)`` / ``generic_want(k)``, the
    final objectives agree within OBJ_AGREE and decrease."""
    out = {}
    for route, want in (("fused", fused_want), ("generic", generic_want)):
        kw = {} if route == "fused" else {"fused": False}
        make(max_iter=3, **kw).solve()
        b = make(**kw)
        X, wall, counts = _timed_solve(b)
        its = b.getitstat()
        k = int(b.state.k)
        if k != PGM_ITERS:
            raise AssertionError(f"{route} {label} ran {k} iterations")
        expect_launches(f"a {route} {label} solve", counts, **want(k))
        loop = (loop_reads(f"a fused {label} solve", k)
                if route == "fused" else {})
        if tuple(X.shape) != xshape or not bool(torch.isfinite(X).all()):
            raise AssertionError(f"{route} {label}: bad shape or not "
                                 "finite")
        if not (np.all(np.isfinite(its.ObjFun))
                and its.ObjFun[-1] < its.ObjFun[0]):
            raise AssertionError(f"{route} {label}: objective not finite "
                                 "or not decreasing")
        out[route] = {"iterations": k, "wall_s": wall,
                      "iters_per_s": k / wall, "ms_per_iter": 1e3 * wall / k,
                      "final_objective": float(its.ObjFun[-1]),
                      "final_rsdl": float(its.Rsdl[-1]),
                      "nonzero_fraction": float((X != 0).float().mean()),
                      "launches": counts, **({"host_reads": loop[
                          "host_reads"], "device_loop": loop}
                                             if loop else {})}
    fo, go = out["fused"]["final_objective"], out["generic"]["final_objective"]
    agree = abs(fo - go) / abs(go)
    if not agree <= OBJ_AGREE:
        raise AssertionError(f"{label}: fused objective {fo} against the "
                             f"generic solve's {go}")
    out["objective_rel_diff"] = agree
    return out


def phase_clr_pgm_solve(dev, Dc, S3):
    """The colour dictionary by FISTA at L = 100 for PGM_ITERS
    iterations: fused (one pgm_iter per iteration, no transform) against
    the generic FFT problem."""
    def make(max_iter=PGM_ITERS, **extra):
        return tpgm.ConvBPDN(Dc, S3, LMBDA, device=dev, dimK=0, **extra,
                             opt=pgm_options(max_iter))
    return _fista_solves("colour FISTA", make, lambda k: dict(pgm_iter=k),
                         lambda k: dict(rfft2_planar=2 * k + 2,
                                        irfft2_planar=k),
                         (N, N, 1, 1, M))


def phase_cfold_solve(dev, D, S3):
    """The headline dictionary on the colour image (dimK=0, C = 3),
    folded into three batch entries on both fused drivers: ADMM to 1e-3
    and FISTA at L = 100, each against its generic solve."""
    xshape = (N, N, 3, 1, M)

    def admm(max_iter=MAX_ITER, **extra):
        return ConvBPDN(D, S3, LMBDA, device=dev, dimK=0, **extra,
                        opt=admm_options(ConvBPDN, max_iter))

    def fista(max_iter=PGM_ITERS, **extra):
        return tpgm.ConvBPDN(D, S3, LMBDA, device=dev, dimK=0, **extra,
                             opt=pgm_options(max_iter))
    return {"admm": _variant_solves(
                "folded l1", admm,
                lambda k: dict(csc_iter=k, rfft2_planar=k + 3,
                               irfft2_planar=k + 1),
                lambda k: dict(rfft2_planar=k + 2, irfft2_planar=k),
                xshape),
            "fista": _fista_solves(
                "folded FISTA", fista, lambda k: dict(pgm_iter=k),
                lambda k: dict(rfft2_planar=2 * k + 2, irfft2_planar=k),
                xshape)}


# The consensus dictionary learning problem of bench.py's _bench_cdlcns
# (BASELINE configuration 5): 40 images of 128x128, 32 filters of 8x8,
# lmbda = 0.1, 50 outer iterations
CN, CK, CND, CM, CLMBDA, CNS_ITERS = 128, 40, 8, 32, 0.1, 50
CNS_PARITY_ITERS = 5
CDL_ITERS = 20
CNS_KEPT = 0.8           # share of pixels the masked problem keeps
# card (kernels) against CPU (plain versions) over CNS_PARITY_ITERS outer
# iterations: the float32 tolerances of the CPU tests of the DFT-domain
# and spatial stages against the JAX package (D and Z of their scale,
# the objective relative)
CNS_PARITY = {"D": 1e-4, "Z": 1e-4, "objective": 1e-4}
CNS_UNIT_NORM = 1e-5
# FFT planes of the consensus loop at 128x128: K M (the coefficient maps)
# and K (the signals)
CNS_FFT_PLANES = (CK * CM, CK)


def cdl_problem():
    """The problem of ``bench.py``'s ``_bench_cdlcns``."""
    rng = np.random.default_rng(0)
    S = rng.standard_normal((CN, CN, CK)).astype(np.float32)
    D0 = rng.standard_normal((CND, CND, CM)).astype(np.float32)
    return D0, S, CLMBDA


def fft_128(dev, B):
    """Both FFT kernels on B planes of 128x128 against their plain
    versions and float64 references (the fft_kernel phase's rules), and
    kernel, plain version and torch.fft timed."""
    n0 = n1 = CN
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((B, n0, n1), generator=g, device=dev)
    yr, yi = tfp.rfft2_planar(x)
    pr, pi = tfp.rfft2_planar_plain(x)
    ref = torch.fft.rfft2(x.double())
    sc = float(ref.abs().max())
    zr = torch.randn(yr.shape, generator=g, device=dev)
    zi = torch.randn(yr.shape, generator=g, device=dev)
    xb = tfp.irfft2_planar(zr, zi, n1)
    xp = tfp.irfft2_planar_plain(zr, zi, n1)
    xref = torch.fft.irfft2(torch.complex(zr.double(), zi.double()).cpu(),
                            s=(n0, n1)).to(dev)
    errs = {"rfft2_planar": {"ref": max(_rel_err(yr, ref.real, sc),
                                        _rel_err(yi, ref.imag, sc)),
                             "plain": max(_rel_err(yr, pr, sc),
                                          _rel_err(yi, pi, sc))},
            "irfft2_planar": {"ref": _rel_err(xb, xref, 1.0),
                              "plain": _rel_err(xb, xp, 1.0)}}
    for name, tol in (("rfft2_planar", FFT_TOL["forward"]),
                      ("irfft2_planar", FFT_TOL["inverse"])):
        for key, e in errs[name].items():
            lim = tol if key == "ref" else 2 * tol
            if not e <= lim:
                raise AssertionError(f"{name} differs from {key} by {e:.3e} "
                                     f"(tolerance {lim:.0e}) at (B, N0, N1) "
                                     f"= {(B, n0, n1)}")
    lib = torch.fft.rfft2(x)
    bound, by = fft_bound_ms(B, n0, n1)

    def ms(fn):
        return cuda_ms(fn, batch=FFT_BATCH)
    out = {"shape": [B, n0, n1], "rel_err": errs,
           "max_abs_err": {
               "rfft2_planar": max(float((yr - pr).abs().max()),
                                   float((yi - pi).abs().max())),
               "irfft2_planar": float((xb - xp).abs().max())},
           "rfft2_planar": {
               "ms": ms(lambda: tfp.rfft2_planar(x)),
               "plain_ms": ms(lambda: tfp.rfft2_planar_plain(x)),
               "library_ms": ms(lambda: torch.fft.rfft2(x))},
           "irfft2_planar": {
               "planar_ms": ms(lambda: tfp.irfft2_planar(yr, yi, n1)),
               # the call the loop makes: irfftn on a complex64 spectrum
               "ms": ms(lambda: tsf.irfftn(lib, s=(n0, n1))),
               "plain_ms": ms(lambda: tfp.irfft2_planar_plain(yr, yi, n1)),
               "library_ms": ms(lambda: torch.fft.irfft2(lib, s=(n0, n1)))},
           "bound_ms": bound, "bound_by": by}
    for name in ("rfft2_planar", "irfft2_planar"):
        out[name]["vs_library"] = out[name]["ms"] / out[name]["library_ms"]
    return out


def phase_cns_kernel(dev, D0):
    """``csc_iter`` with ``emit_fwd=False`` at the consensus kernel
    stage's geometry (10240, 2048, 256), with the weights of the initial
    dictionary projected on the constraint set, under the rules of
    :func:`check_csc_iter`; the FFT kernels at 128x128."""
    Dn = D0 / np.sqrt((D0 ** 2).sum(axis=(0, 1), keepdims=True))
    Wf, Wa, _ = xstep_kernels(torch.as_tensor(Dn).permute(2, 0, 1)
                              .contiguous().to(dev), CND, CND, PS)
    pos = CK * (CN // PS) ** 2
    out = check_csc_iter(dev, Wf, Wa, pos, headline=False, emit_fwd=False)
    out["fft"] = {f"B={B}": fft_128(dev, B) for B in CNS_FFT_PLANES}
    return out


def _cns_route(d):
    return ("kernel" if d.cfg.kernel_x else "spatial" if d.cfg.fused_x
            else "masked" if d.cfg.masked else "dft")


def phase_cns_parity(dev, D0, S, lmbda):
    """CNS_PARITY_ITERS outer iterations of the kernel stage and of the
    DFT-domain stage on the card against the same on the CPU."""
    out = {}
    for label, fused in (("kernel", "auto"), ("dft", False)):
        runs = []
        for d in (dev, "cpu"):
            c = tcns.ConvBPDNDictLearn_Consensus(
                D0, S, lmbda, max_iter=CNS_PARITY_ITERS, fused=fused,
                device=d)
            if _cns_route(c) != label:
                raise AssertionError(f"consensus with fused={fused} took "
                                     f"the {_cns_route(c)} stage")
            c.solve()
            runs.append((c.getdict().cpu().numpy(),
                         c.getcoef().cpu().numpy(), c.evaluate()[0]))
        (Dg, Zg, og), (Dc, Zc, oc) = runs
        errs = {"D": float(np.abs(Dg - Dc).max()),
                "Z": float(np.abs(Zg - Zc).max() / np.abs(Zc).max()),
                "objective": abs(og - oc) / abs(oc)}
        for name, e in errs.items():
            if not e <= CNS_PARITY[name]:
                raise AssertionError(f"consensus {label} stage: {name} "
                                     f"card against CPU {e:.3e} (tolerance "
                                     f"{CNS_PARITY[name]:.0e})")
        out[label] = {"rel_err": errs, "objective": og}
    return {"iterations": CNS_PARITY_ITERS, "tolerance": CNS_PARITY, **out}


def phase_cns_solve(dev, D0, S, lmbda):
    """CNS_ITERS outer iterations on the card of each CSC stage: the
    objective falls, the filters keep unit norm, and the launches are
    those of the stage (csc_iter once per iteration in the kernel stage
    only; per iteration 4 forward and 2 inverse transforms, masked 6 and
    3); the unmasked stages end at the same objective."""
    W = (np.random.default_rng(4).random(S.shape)
         < CNS_KEPT).astype(np.float32)
    cases = (("kernel", tcns.ConvBPDNDictLearn_Consensus, {}),
             ("spatial", tcns.ConvBPDNDictLearn_Consensus,
              {"wl1": np.ones((1, 1, 1, 1, CM), np.float32)}),
             ("dft", tcns.ConvBPDNDictLearn_Consensus, {"fused": False}),
             ("masked", tcns.ConvBPDNMaskDcplDictLearn_Consensus,
              {"W": W}))
    per_iter = {"kernel": (1, 4, 2), "spatial": (0, 4, 2), "dft": (0, 4, 2),
                "masked": (0, 6, 3)}
    out = {}
    for label, cls, kw in cases:
        d = cls(D0, S, lmbda, max_iter=CNS_ITERS, device=dev, **kw)
        if _cns_route(d) != label:
            raise AssertionError(f"consensus {label}: took the "
                                 f"{_cns_route(d)} stage")
        obj0 = d.evaluate()[0]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        d.step(CNS_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        obj1 = d.evaluate()[0]
        n_csc, n_fwd, n_inv = per_iter[label]
        expect_launches(f"consensus {label}, {CNS_ITERS} iterations",
                        counts, csc_iter=n_csc * CNS_ITERS,
                        rfft2_planar=n_fwd * CNS_ITERS,
                        irfft2_planar=n_inv * CNS_ITERS)
        D = d.getdict().cpu().numpy()
        nrm = np.sqrt((D.astype(np.float64) ** 2).sum(axis=(0, 1)))
        Z = d.getcoef()
        if not (np.all(np.isfinite(D)) and bool(torch.isfinite(Z).all())
                and obj1 < obj0):
            raise AssertionError(f"consensus {label}: objective {obj0} -> "
                                 f"{obj1}, or not finite")
        if not np.abs(nrm - 1.0).max() <= CNS_UNIT_NORM:
            raise AssertionError(f"consensus {label}: filter norms "
                                 f"{nrm.min()}..{nrm.max()}")
        out[label] = {"iterations": CNS_ITERS, "wall_s": wall,
                      "ms_per_iter": 1e3 * wall / CNS_ITERS,
                      "iters_per_s": CNS_ITERS / wall,
                      "objective_before": obj0, "objective_after": obj1,
                      "norm_err": float(np.abs(nrm - 1.0).max()),
                      "launches": counts}
    objs = [out[k]["objective_after"] for k in ("kernel", "spatial", "dft")]
    spread = (max(objs) - min(objs)) / min(objs)
    if not spread <= OBJ_AGREE:
        raise AssertionError(f"consensus stages end at objectives {objs}")
    out["objective_spread"] = spread
    return out


def phase_cdl_solve(dev, D0, S, lmbda):
    """ConvBPDNDictLearn (float32, fused ADMM x-step, consensus CCMOD) for
    CDL_ITERS outer iterations: one full csc_iter per outer iteration."""
    d = tdl.ConvBPDNDictLearn(D0, S, lmbda, xmethod="admm", dmethod="cns",
                              max_iter=CDL_ITERS, dtype=torch.float32,
                              device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    D = d.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    if counts["csc_iter"] != CDL_ITERS or counts["pgm_iter"] \
            or counts["admm_tail"]:
        raise AssertionError(f"ConvBPDNDictLearn: launches {counts}, "
                             f"expected {CDL_ITERS} csc_iter")
    its = d.getitstat()
    obj = its["XObjFun"]
    if not (np.all(np.isfinite(obj)) and bool(torch.isfinite(D).all())
            and len(obj) == CDL_ITERS):
        raise AssertionError("ConvBPDNDictLearn: not finite")
    return {"iterations": CDL_ITERS, "wall_s": wall,
            "ms_per_iter": 1e3 * wall / CDL_ITERS,
            "ms_per_outer_iter": 1e3 * wall / CDL_ITERS,
            "objective_first": float(obj[0]),
            "objective": float(obj[-1]), "dfid": float(its["XDFid"][-1]),
            "launches": counts}


# ---------------------------------------------------------------------------
# Masked CSC by Additive Mask Simulation, the "mixed" precision and the
# FISTA dictionary update

AMS_MISSING = 0.25      # share of the headline's pixels the mask drops
# "mixed" rounds R1's operands to bf16 (8 bits, 4e-3 relative), and the
# ADMM x-step's residual cancels: its solve may stall short of the
# stopping tolerance (reported, not a failure); its final objective must
# stay within 1e-2 of the "high" solve's
MIXED_OBJ_AGREE = 1e-2
AMS_MU = 0.05           # gradient penalty of cbpdngrdmsk (csc_accel.py)


def ams_problem(S):
    """The headline image with a quarter of its pixels missing: the mask
    from ``numpy.random.default_rng(0)`` and the image it leaves."""
    W = (np.random.default_rng(0).random((N, N))
         >= AMS_MISSING).astype(np.float32)
    return W, (S * W).astype(np.float32)


def _ams_model(kind, D, Sm, W, dev, max_iter=MAX_ITER, rel_stop_tol=REL_TOL,
               **kw):
    """The model ``accel.cbpdnmsk`` (kind "l1") or ``accel.cbpdngrdmsk``
    ("gradreg") builds: AddMaskSim over ConvBPDN or ConvBPDNGradReg."""
    cls = ConvBPDN if kind == "l1" else ConvBPDNGradReg
    if kind == "gradreg":
        kw["mu"] = AMS_MU
    return AddMaskSim(cls, D, Sm, W, LMBDA, device=dev,
                      opt=admm_options(cls, max_iter, rel_stop_tol), **kw)


def phase_ams_tail_kernel(dev, W):
    """admm_tail's AMS form against its plain version at the masked
    headline layout (4096 x 4160: 64 filters and the impulse map), with
    the headline mask packed as the driver packs it, and at ragged ones
    (the 16-byte path's 37 rows, a C off a multiple of 4, two impulse
    maps), over nonneg and us; PYn and PUn must equal the plain
    version's bit for bit, the sums 1e-5 relative.  Kernel and plain
    version timed at the headline layout, beside the plain form of the
    kernel on the same arrays."""
    g = torch.Generator(device=dev).manual_seed(8)
    P = PS * PS
    Wp_head = tfc.ams_mask(torch.as_tensor(W, device=dev).reshape(
        1, 1, 1, N, N), 1, (N, N))

    def arrays(R, Mt, nimp):
        C = P * Mt
        PX = torch.randn((R, C), generator=g, device=dev)
        PY = torch.randn((R, C), generator=g, device=dev) * (
            torch.rand((R, C), generator=g, device=dev) < 0.05)
        PU = 0.01 * torch.randn((R, C), generator=g, device=dev)
        wl1 = torch.ones(Mt, device=dev)
        wl1[Mt - nimp:] = 0.0
        wl1 = wl1.repeat(P).contiguous()
        Wp = Wp_head if R == Wp_head.shape[0] else (
            torch.rand((R, P), generator=g, device=dev) >= AMS_MISSING
        ).float()
        return PX, PY, PU, 0.0143 * wl1, wl1, Wp
    shapes = [((N // PS) ** 2, M + 1, 1), (37, M + 1, 1), (25, 5, 1),
              (64, 9, 2)]
    grid, max_abs, sums_rel = [], 0.0, 0.0
    for R, Mt, nimp in shapes:
        PX, PY0, PU0, thr, wl1, Wp = arrays(R, Mt, nimp)
        for nonneg in (False, True):
            for us in (1.0, 0.9):
                outs = [fn(PX, PY0.clone(), PU0.clone(), thr, wl1, 1.8,
                           nonneg=nonneg, us=us, ams=(Wp, nimp))
                        for fn in (tct.admm_tail, tct.admm_tail_plain)]
                where = (f"(R, C) = {(R, P * Mt)} nimp={nimp} "
                         f"nonneg={nonneg} us={us}")
                errs, ae = compare_outputs(
                    "admm_tail (AMS)", ("PYn", "PUn", "sums"), *outs, where)
                for name, k, p in zip(("PYn", "PUn"), outs[0], outs[1]):
                    if not torch.equal(k, p):
                        raise AssertionError(
                            f"admm_tail (AMS) {name} differs from the plain "
                            f"version's bits at {where}")
                srel = float(((outs[0][2] - outs[1][2]).abs()
                              / outs[1][2].abs().clamp_min(1e-30)).max())
                if srel > KERNEL_RTOL:
                    raise AssertionError(f"admm_tail (AMS) sums differ by "
                                         f"{srel:.3e} at {where}")
                max_abs = max(max_abs, ae)
                sums_rel = max(sums_rel, srel)
                grid.append({"shape": [R, P * Mt], "nimp": nimp,
                             "nonneg": nonneg, "us": us, "rel_err": errs,
                             "sums_rel_err": srel})
    R, Mt, nimp = shapes[0]
    PX, PY, PU, thr, wl1, Wp = arrays(R, Mt, nimp)
    C = P * Mt

    def run(fn, ams=(Wp, nimp)):
        return lambda: fn(PX, PY, PU, thr, wl1, 1.8, us=0.9, ams=ams)
    kernel_ms = cuda_ms(run(tct.admm_tail), batch=10)
    plain_form_ms = cuda_ms(run(tct.admm_tail, None), batch=10)
    plain_ms = cuda_ms(run(tct.admm_tail_plain), batch=10)
    bound_ms, bound_by = tail_bound_ms(R, C, True, mask_floats=R * P)
    return {"tolerance_rel": KERNEL_RTOL, "grid": grid,
            "max_abs_err": max_abs, "sums_max_rel_err": sums_rel,
            "geometry": {"R": R, "C": C, "M": Mt, "nimp": nimp},
            "mask_kept": float(Wp.mean()), "kernel_ms": kernel_ms,
            "plain_form_kernel_ms": plain_form_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "achieved_gb_per_s": (5 * R * C + R * P) * 4 / kernel_ms / 1e6}


def phase_ams_parity(dev, D, Sm, W):
    """10 iterations of the masked headline problem (cbpdnmsk's and
    cbpdngrdmsk's models, fused) on the card against the CPU."""
    out = {}
    for kind in ("l1", "gradreg"):
        runs = []
        for d in (dev, "cpu"):
            b = _ams_model(kind, D, Sm, W, d, PARITY_ITERS, 0.0).cbpdn
            Yd = b.solve()
            runs.append((b.getitstat(), {"Y": Yd.cpu().numpy(),
                                         "X": b.state.X.cpu().numpy()}))
        names = ("ObjFun", "DFid", "RegL1", "Rho", "PrimalRsdl",
                 "DualRsdl") + (("RegGrad",) if kind == "gradreg" else ())
        out[kind] = compare_runs(f"AMS parity ({kind})", runs, names, PARITY)
    return {"iterations": PARITY_ITERS, "rel_err": out, "tolerance": PARITY}


def phase_ams_solve(dev, D, Sm, W):
    """accel.cbpdnmsk and accel.cbpdngrdmsk on the masked headline to
    1e-3, fused (one AMS admm_tail an iteration) and fused=False: the
    models' solves (fused against generic within OBJ_AGREE), then each
    accel call, which must give the model's coefficients and launches."""
    out = {}
    for kind in ("l1", "gradreg"):
        def make(max_iter=MAX_ITER, **kw):
            return _ams_model(kind, D, Sm, W, dev, max_iter, **kw).cbpdn
        # fused: setup D, S (and the gradient filters), then per iteration
        # the x-step's pair on one plane (l1) or 65 (gradreg), one tail
        extra = 1 if kind == "gradreg" else 0
        res = _variant_solves(
            f"masked {kind}", make,
            lambda k: dict(admm_tail=k, rfft2_planar=k + 2 + extra,
                           irfft2_planar=k),
            lambda k: dict(rfft2_planar=k + 2 + extra, irfft2_planar=k),
            xshape=(N, N, 1, 1, M + 1))
        fn = accel.cbpdnmsk if kind == "l1" else accel.cbpdngrdmsk
        args = (D, Sm, W, LMBDA) + ((AMS_MU,) if kind == "gradreg" else ())
        for route in ("fused", "generic"):
            cls = ConvBPDN if kind == "l1" else ConvBPDNGradReg
            kw = {} if route == "fused" else {"fused": False}
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            X = fn(*args, opt=admm_options(cls), **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launches()
            ref = make(**kw)
            Xm = ref.solve()[..., :M]
            err = float((X - Xm).abs().max() / Xm.abs().max())
            k = int(ref.state.k)
            if counts != res[route]["launches"] or not err <= 1e-6 \
                    or tuple(X.shape) != (N, N, 1, 1, M):
                raise AssertionError(
                    f"accel {kind} ({route}): launches {counts} against "
                    f"the model's {res[route]['launches']}, coefficients "
                    f"{err:.3e} from the model's")
            res[route]["accel"] = {"wall_s": wall,
                                   "ms_per_iter": 1e3 * wall / k,
                                   "launches": counts,
                                   "rel_diff_from_model": err}
        out[kind] = res
    out["launches"] = out["l1"]["launches"]
    out["mask_missing"] = AMS_MISSING
    return out


def phase_mixed_kernel(dev, D):
    """csc_iter and pgm_iter with the "mixed" R1 (one bf16 product) at the
    headline geometry against their plain versions: every output but R1
    within KERNEL_RTOL, and the "high" launch's bits; R1 within
    KERNEL_RTOL of the float64 product of the kernel's own bf16-rounded
    operands (where the kernel's Yn/Un differ from the plain version's
    by an fp32 ulp, a bf16 rounding flips and R1 moves by a bf16 ulp of
    one term; the plain version's R1 distance is reported beside); and
    the time of the mixed and the high form in the same run."""
    Wf, Wa, (pos, C, T) = headline_weights(dev, D)
    wf3 = tci.split_weight(Wf)
    g = torch.Generator(device=dev).manual_seed(9)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def sparse(*shape):
        return randn(*shape) * (torch.rand(shape, generator=g, device=dev)
                                < 0.05)
    G2 = 0.1 * randn(pos, T)
    Y0, U0, X0 = sparse(pos, C), 0.01 * randn(pos, C), sparse(pos, C)
    bf = Wf.to(torch.bfloat16).double()
    out, max_abs = {}, 0.0
    specs = {
        "csc_iter": (lambda fn, mixed: fn(
            G2, Y0.clone(), U0.clone(), Wa, Wf, 0.0143, 1.0, 1.8, 0.9, 1.0,
            emit_px=False, wf_split=wf3, mixed=mixed),
            tci.csc_iter, tci.csc_iter_plain, ("Yn", "Un", "R1", "R2",
                                               "sums"),
            lambda o: o[0] - o[1]),
        "pgm_iter": (lambda fn, mixed: fn(
            G2, Y0.clone(), X0.clone(), Wa, Wf, 5e-4, 1.0, 1.0 / PGM_L, 0.7,
            wf_split=wf3, mixed=mixed),
            tpi.pgm_iter, tpi.pgm_iter_plain, ("X", "Yn", "R1", "RX",
                                               "sums"),
            lambda o: o[1])}
    for name, (call, kern, plain, names, operand) in specs.items():
        got = [t for t in call(kern, True) if t is not None]
        high = [t for t in call(kern, False) if t is not None]
        ref = [t for t in call(plain, True) if t is not None]
        errs, ae = compare_outputs(f"{name} (mixed)", names, got, ref,
                                   f"(pos, C, T) = {(pos, C, T)}",
                                   float64_gated=("R1",))
        i1 = names.index("R1")
        for i, (a, b) in enumerate(zip(got, high)):
            if i != i1 and not torch.equal(a, b):
                raise AssertionError(f"{name} (mixed): {names[i]} differs "
                                     "from the high launch's bits")
        r64 = operand(got).to(torch.bfloat16).double() @ bf
        scale = float(r64.abs().max())
        r1_err = float((got[i1].double() - r64).abs().max()) / scale
        if not r1_err <= KERNEL_RTOL:
            raise AssertionError(f"{name} (mixed): R1 is {r1_err:.3e} from "
                                 "the float64 product of its operands")
        max_abs = max(max_abs, ae)
        torch.cuda.synchronize()

        def timed(fn, mixed):
            Y, U = Y0.clone(), (U0 if name == "csc_iter" else X0).clone()
            if name == "csc_iter":
                return lambda: fn(G2, Y, U, Wa, Wf, 0.0143, 1.0, 1.8, 0.9,
                                  1.0, emit_px=False, wf_split=wf3,
                                  mixed=mixed)
            return lambda: fn(G2, Y, U, Wa, Wf, 5e-4, 1.0, 1.0 / PGM_L, 0.7,
                              wf_split=wf3, mixed=mixed)
        # in turns: high, mixed, mixed, high
        t = [cuda_ms(timed(kern, m)) for m in (False, True, True, False)]
        bounds = (csc_iter_bound_ms(pos, C, T, False, False, mixed=True)
                  if name == "csc_iter"
                  else pgm_iter_bound_ms(pos, C, T, False, mixed=True))
        out[name] = {
            "geometry": {"pos": pos, "C": C, "T": T},
            "rel_err": errs, "max_abs_err": ae,
            "r1_vs_float64_of_bf16_operands": {
                "kernel": r1_err,
                "plain": float(
                    (ref[i1].double() - operand(ref).to(torch.bfloat16)
                     .double() @ bf).abs().max()) / scale},
            "r1_rel_diff_from_high": float((got[i1] - high[i1]).abs().max()
                                           / high[i1].abs().max()),
            "kernel_ms": 0.5 * (t[1] + t[2]), "high_ms": 0.5 * (t[0] + t[3]),
            "times_in_turn_ms": t,
            "pass_ms": device_ms_by_kernel(timed(kern, True)),
            "plain_ms": cuda_ms(timed(plain, True)), **bounds}
    out["max_abs_err"] = max_abs
    return out


@contextlib.contextmanager
def matmul_precision(mode):
    prev = tfc.get_matmul_precision()
    tfc.set_matmul_precision(mode)
    try:
        yield
    finally:
        tfc.set_matmul_precision(prev)


def phase_mixed_solve(dev, D, S, lmbda, high, pgm_high):
    """The fused ADMM solve to 1e-3 (or MAX_ITER iterations; whether it
    converged is reported) and the fused FISTA solve (250 iterations)
    under "mixed" at FFT precision "high", against the "high" solves of
    the ``solve`` and ``pgm_solve`` phases (objectives within
    MIXED_OBJ_AGREE); then 10 iterations
    on the card against the CPU: FISTA at PGM_PARITY; ADMM's first four
    rows at PARITY and the run within twice the CPU's own drift from
    "mixed" to "high" (ADMM parts at bf16 rounding flips:
    tests/test_torch_mixed.py)."""
    out = {}
    with matmul_precision("mixed"):
        ConvBPDN(D, S, lmbda, opt=ConvBPDN.options(max_iter=3),
                 device=dev).solve()
        b = ConvBPDN(D, S, lmbda, opt=ConvBPDN.options(
            max_iter=MAX_ITER, rel_stop_tol=REL_TOL), device=dev)
        X, wall, counts = _timed_solve(b)
        k = int(b.state.k)
        expect_launches(f"a mixed ADMM solve of {k} iterations", counts,
                        csc_iter=k)
        loop = loop_reads(f"a mixed ADMM solve of {k} iterations", k)
        its = b.getitstat()
        obj = float(its.ObjFun[-1])
        drift = abs(obj - high["final_objective"]) / high["final_objective"]
        if not (bool(torch.isfinite(X).all())
                and np.all(np.isfinite(its.ObjFun))
                and drift <= MIXED_OBJ_AGREE):
            raise AssertionError(f"mixed ADMM: objective {obj} against "
                                 f"high's {high['final_objective']}")
        out["admm"] = {"iterations": k, "high_iterations": high["iterations"],
                       "converged": bool(
                           its.PrimalRsdl[-1] <= its.EPrimal[-1]
                           and its.DualRsdl[-1] <= its.EDual[-1]),
                       "final_objective": obj,
                       "high_objective": high["final_objective"],
                       "objective_rel_diff_from_high": abs(
                           obj - high["final_objective"])
                       / high["final_objective"],
                       "wall_s": wall, "ms_per_iter": 1e3 * wall / k,
                       "high_ms_per_iter": high["ms_per_iter"],
                       "launches": counts,
                       "host_reads": loop["host_reads"]}
        b = tpgm.ConvBPDN(D, S, lmbda, opt=pgm_options(), device=dev)
        X, wall, counts = _timed_solve(b)
        k = int(b.state.k)
        expect_launches(f"a mixed FISTA solve of {k} iterations", counts,
                        pgm_iter=k)
        loop = loop_reads(f"a mixed FISTA solve of {k} iterations", k)
        its = b.getitstat()
        obj = float(its.ObjFun[-1])
        if k != PGM_ITERS or not np.all(np.isfinite(its.ObjFun)) or not (
                abs(obj - pgm_high["final_objective"])
                <= MIXED_OBJ_AGREE * pgm_high["final_objective"]):
            raise AssertionError(f"mixed FISTA: {k} iterations, objective "
                                 f"{obj} against high's "
                                 f"{pgm_high['final_objective']}")
        out["fista"] = {"iterations": k, "final_objective": obj,
                        "high_objective": pgm_high["final_objective"],
                        "objective_rel_diff_from_high": abs(
                            obj - pgm_high["final_objective"])
                        / pgm_high["final_objective"],
                        "wall_s": wall, "ms_per_iter": 1e3 * wall / k,
                        "high_ms_per_iter": pgm_high["ms_per_iter"],
                        "launches": counts,
                        "host_reads": loop["host_reads"]}
    # card against CPU, 10 iterations
    runs = {}
    for mode, where in (("mixed", dev), ("mixed", "cpu"), ("high", "cpu")):
        with matmul_precision(mode):
            b = ConvBPDN(D, S, lmbda, opt=ConvBPDN.options(
                max_iter=PARITY_ITERS, rel_stop_tol=0.0), device=where)
            Y = b.solve()
            runs[(mode, str(where))] = (b.getitstat(), Y.cpu().numpy(),
                                        b.state.X.cpu().numpy())

    def diffs(a, b):
        (ia, Ya, Xa), (ib, Yb, Xb) = a, b
        d = {n: float(np.max(np.abs(getattr(ia, n) - getattr(ib, n))
                             / np.abs(getattr(ib, n))))
             for n in ("ObjFun", "DFid", "RegL1", "Rho")}
        d["Y"] = float(np.abs(Ya - Yb).max() / np.abs(Yb).max())
        d["X"] = float(np.abs(Xa - Xb).max() / np.abs(Xb).max())
        return d
    card, cpu, cpu_high = (runs[("mixed", str(dev))], runs[("mixed", "cpu")],
                           runs[("high", "cpu")])
    first = {n: float(np.max(np.abs(getattr(card[0], n)[:4]
                                    - getattr(cpu[0], n)[:4])
                             / np.abs(getattr(cpu[0], n)[:4])))
             for n in ("ObjFun", "DFid", "RegL1", "Rho")}
    got, drift = diffs(card, cpu), diffs(cpu, cpu_high)
    for n, e in first.items():
        if not e <= PARITY[n]:
            raise AssertionError(f"mixed ADMM parity: {n} of the first four "
                                 f"rows differs by {e:.3e}")
    for n, e in got.items():
        if not e <= 2 * drift[n]:
            raise AssertionError(f"mixed ADMM parity: {n} differs by "
                                 f"{e:.3e}, twice the drift {drift[n]:.3e}")
    pruns = []
    with matmul_precision("mixed"):
        for d in (dev, "cpu"):
            b = tpgm.ConvBPDN(D, S, lmbda, opt=pgm_options(PARITY_ITERS),
                              device=d)
            X = b.solve()
            pruns.append((b.getitstat(), {"X": X.cpu().numpy(),
                                          "Y": b.state.Y.cpu().numpy()}))
    out["parity"] = {
        "iterations": PARITY_ITERS,
        "admm": {"first_rows_rel_err": first, "rel_err": got,
                 "cpu_drift_from_high": drift},
        "fista": compare_runs("mixed FISTA parity", pruns,
                              ("ObjFun", "DFid", "RegL1", "Rsdl"),
                              PGM_PARITY)}
    out["launches"] = {"csc_iter": out["admm"]["launches"]["csc_iter"],
                       "pgm_iter": out["fista"]["launches"]["pgm_iter"]}
    return out


CDL_PGM_PARITY_ITERS = 3


def phase_cdl_pgm_solve(dev, D0, S, lmbda):
    """ConvBPDNDictLearn(xmethod="pgm", dmethod="pgm") at cdl_solve's size
    (float32): 20 outer iterations on the card, one pgm_iter each (the
    FISTA dictionary update runs its FFTs on the planar kernels); then 3
    outer iterations on the card against the CPU."""
    def make(max_iter, device):
        return tdl.ConvBPDNDictLearn(D0, S, lmbda, xmethod="pgm",
                                     dmethod="pgm", max_iter=max_iter,
                                     dtype=torch.float32, device=device)
    d = make(CDL_ITERS, dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    D = d.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    if counts["pgm_iter"] != CDL_ITERS or counts["csc_iter"] \
            or counts["admm_tail"]:
        raise AssertionError(f"ConvBPDNDictLearn (pgm, pgm): launches "
                             f"{counts}, expected {CDL_ITERS} pgm_iter")
    its = d.getitstat()
    obj = its["XObjFun"]
    if not (np.all(np.isfinite(obj)) and bool(torch.isfinite(D).all())
            and len(obj) == CDL_ITERS):
        raise AssertionError("ConvBPDNDictLearn (pgm, pgm): not finite")
    nrm = D.double().pow(2).sum(dim=(0, 1)).sqrt()
    unit = float((nrm - 1.0).abs().max())
    if not unit <= CNS_UNIT_NORM:
        raise AssertionError(f"filters not unit norm: {unit:.3e}")
    out = []
    for where in (dev, "cpu"):
        c = make(CDL_PGM_PARITY_ITERS, where)
        c.solve()
        out.append((c.getdict().cpu().numpy(), c.getitstat()))
    (Dg, ig), (Dc, ic) = out
    errs = {"D": float(np.abs(Dg - Dc).max() / np.abs(Dc).max())}
    for name in ("XObjFun", "DDFid"):
        errs[name] = float(np.max(np.abs(ig[name] - ic[name])
                                  / np.abs(ic[name])))
    for name, e in errs.items():
        if not e <= CNS_PARITY["objective"]:
            raise AssertionError(f"ConvBPDNDictLearn (pgm, pgm) parity: "
                                 f"{name} differs by {e:.3e}")
    return {"iterations": CDL_ITERS, "wall_s": wall,
            "ms_per_iter": 1e3 * wall / CDL_ITERS,
            "ms_per_outer_iter": 1e3 * wall / CDL_ITERS,
            "objective_first": float(obj[0]), "objective": float(obj[-1]),
            "dfid": float(its["XDFid"][-1]), "unit_norm_err": unit,
            "launches": counts,
            "parity": {"iterations": CDL_PGM_PARITY_ITERS, "rel_err": errs,
                       "tolerance": CNS_PARITY["objective"]}}


# ---------------------------------------------------------------------------
# BASELINE configurations 1-3: dense BPDN, TV and Robust PCA, and the
# generic dictionary learning alternation

BPDN_N, BPDN_M, BPDN_K, BPDN_NNZ = 512, 512, 256, 32   # bench.py:265-318
BPDN_LMBDA, BPDN_MU = 1e-2, 1e-2
BPDN_ITERS, DENSE_TOL = 500, 1e-3
TV_N, TV_LMBDA, TV_ITERS = 256, 0.05, 500              # bench.py:321-343
TVL1_LMBDA = 0.8                                       # examples/tv_deconv.py
TVD_N, TVD_LMBDA, TVD_ITERS, TVD_TOL = 512, 5e-3, 200, 1e-4
# TVL1Deconv's lmbda on the same problem: an l1 data term's subgradient
# is 1 where the l2 term's is the noise (0.02), so the l2 lmbda 5e-3
# corresponds to about 0.25; 0.2 from a sweep (tools/dense_cpu_study.py
# tvl1): PSNR 22.5 -> 43.0 dB, where 5e-3 gives 9.0 dB
TVL1D_LMBDA = 0.2
RPCA_N, RPCA_R, RPCA_RANK, RPCA_ITERS = 512, 8, 16, 200  # bench.py:346-377
HANDOVER_OUTER, HANDOVER_INNER = 3, 5
# card against CPU over 10 iterations in float64: the stats rows are
# float32 in both (agree to rtol 1e-6), X and Y within 1e-8 of their
# scale (the CPU tests' float64 tolerance); in float32 the TV models at
# the CPU tests' tolerances (the dense models' residual rows move by
# about 1e-3 for a change of the Gram product's rounding at 512x512:
# their float32 runs are held by their final objectives instead)
F64_PARITY = {"X": 1e-8, "rows": 1e-6, "zero": 1e-12}
# a float32 solve on the card against the same solve on the CPU, each
# limit between the card's largest difference from the CPU and the spread
# that moving S by one ulp gives two CPU solves (tools/dense_cpu_study.py
# ulp, at these sizes; the card an H100).  The BPDN models' final
# objectives: the card 2.5e-3 off (BPDN K = 1), one ulp up to 5.6e-3
# (ElasticNet) and 4.9e-3 (BPDN K = 1), while their float64 runs agree to
# 1e-13: the square Gaussian dictionary's small singular values amplify
# float32 rounding
DENSE_OBJ_AGREE = 4e-3
# BPDNProjL1's objective, DFid, goes to 0 (x0 lies in the l1 ball), so it
# is held absolutely, over ||S||^2: the card 9.2e-10 off, one ulp 1.0e-9
PROJL1_DFID_AGREE = 1e-9
# the TV models' final objectives: the card 1.2e-7 off (TVL1Deconv, one
# float32 ulp of its objective; the others equal), one ulp of S up to
# 5.3e-7 (TVL2Deconv); Robust PCA's: randomized, the card 4.5e-7 off,
# one ulp of S 7.9e-7; full, one ulp 5.6e-7, and a control: a Jacobi SVD
# rotating float32 rows in float32 put the card 3.0e-6 off (its singular
# values 16 times further off than LAPACK's; ops/svd.py works in float64)
TV_OBJ_AGREE = 5e-7
RPCA_OBJ_AGREE = 6e-7
TV_PARITY = {"X": 2e-4, "ObjFun": 1e-4, "DFid": 1e-4, "RegTV": 1e-4,
             "Rho": 1e-4, "PrimalRsdl": 1e-3, "DualRsdl": 1e-3,
             "GSRelRes": 1e-3, "zero": 1e-4}


def bpdn_problem(K, seed=0):
    """``bench.py``'s ``_bench_bpdn`` (K = 1) and ``_bench_bpdn_batch``:
    a 512x512 Gaussian dictionary, x0 32-sparse per signal, S = D x0."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((BPDN_N, BPDN_M)).astype(np.float32)
    x0 = np.zeros((BPDN_M, K), np.float32)
    if K == 1:
        x0[rng.choice(BPDN_M, BPDN_NNZ, replace=False)] = \
            rng.standard_normal((BPDN_NNZ, 1))
    else:
        for k in range(K):
            x0[rng.choice(BPDN_M, BPDN_NNZ, replace=False), k] = \
                rng.standard_normal(BPDN_NNZ)
    return D, (D @ x0).astype(np.float32), x0


def bpdn_models(D, S, x0):
    """Each model of ``models/bpdn.py`` on (D, S): name -> (class,
    arguments beside D and S)."""
    return {
        "BPDN": (tbpdn.BPDN, {"lmbda": BPDN_LMBDA}),
        "BPDNJoint": (tbpdn.BPDNJoint, {"lmbda": BPDN_LMBDA,
                                        "mu": BPDN_MU}),
        "ElasticNet": (tbpdn.ElasticNet, {"lmbda": BPDN_LMBDA,
                                          "mu": BPDN_MU}),
        "BPDNProjL1": (tbpdn.BPDNProjL1,
                       {"gamma": float(np.abs(x0).sum(axis=0).max())}),
        "MinL1InL2Ball": (tbpdn.MinL1InL2Ball,
                          {"epsilon": 1e-2 * float(np.linalg.norm(S))}),
    }


def tv_example(n):
    """``examples/tv_deconv.py``'s problem at n x n: the two-level square,
    its 5x5 box blur with noise at 0.02, and its salt and pepper
    corruption (5% each)."""
    rng = np.random.default_rng(12345)
    img = np.zeros((n, n), np.float32)
    img[n // 4:3 * n // 4, n // 4:3 * n // 4] = 1.0
    img[3 * n // 8:5 * n // 8, 3 * n // 8:5 * n // 8] = 0.5
    h = np.ones((5, 5), np.float32) / 25.0
    blurred = np.fft.irfft2(np.fft.rfft2(img) * np.fft.rfft2(h, s=(n, n)),
                            s=(n, n))
    noisy = (blurred + 0.02 * rng.standard_normal((n, n))).astype(
        np.float32)
    sp = img.copy()
    m = rng.random((n, n))
    sp[m < 0.05] = 0.0
    sp[m > 0.95] = 1.0
    return img, h, noisy, sp.astype(np.float32)


def tv_problems():
    """name -> (class, positional arguments, options, the clean image):
    ``TVL2Denoise`` on ``bench.py``'s square with noise at 0.1,
    ``TVL1Denoise`` on the example's salt and pepper image at 256x256,
    the deconvolutions on the example's blurred image at 512x512
    (``TVL1Deconv`` at ``TVL1D_LMBDA``)."""
    rng = np.random.default_rng(0)
    sq = np.zeros((TV_N, TV_N), np.float32)
    sq[TV_N // 4:3 * TV_N // 4, TV_N // 4:3 * TV_N // 4] = 1.0
    Sd = sq + 0.1 * rng.standard_normal((TV_N, TV_N)).astype(np.float32)
    img_s, _, _, sp = tv_example(TV_N)
    img, h, noisy, _ = tv_example(TVD_N)
    den = {"max_iter": TV_ITERS, "rel_stop_tol": DENSE_TOL}
    dcn = {"max_iter": TVD_ITERS, "rel_stop_tol": TVD_TOL}
    return {
        "TVL2Denoise": (ttv.TVL2Denoise, (Sd, TV_LMBDA), den, sq),
        "TVL1Denoise": (ttv.TVL1Denoise, (sp, TVL1_LMBDA),
                        {"max_iter": 200, "rel_stop_tol": TVD_TOL}, img_s),
        "TVL2Deconv": (ttv.TVL2Deconv, (h, noisy, TVD_LMBDA), dcn, img),
        "TVL1Deconv": (ttv.TVL1Deconv, (h, noisy, TVL1D_LMBDA), dcn, img),
    }


def rpca_problem(seed=0):
    """``bench.py``'s ``_bench_rpca``: rank 8 plus 10% sparse outliers at
    scale 5, 512x512."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((RPCA_N, RPCA_R)) @ rng.standard_normal(
        (RPCA_R, RPCA_N))
    Ssp = (rng.random((RPCA_N, RPCA_N)) > 0.9) \
        * rng.standard_normal((RPCA_N, RPCA_N)) * 5
    return (L + Ssp).astype(np.float32), L, Ssp


def psnr(ref, x):
    """Peak signal-to-noise ratio of ``x`` against ``ref`` in dB, the
    peak the range of ``ref``."""
    mse = float(np.mean((np.asarray(x, np.float64) - ref) ** 2))
    return 10.0 * math.log10(float(np.ptp(ref)) ** 2 / mse)


def _state_arrays(b):
    """(Each block of) X and Y of a model's state, as numpy arrays (a
    two-block X as ``X`` and ``X1``)."""
    out = {}
    for name, v in (("X", b.state.X), ("Y", b.state.Y)):
        blocks = v if isinstance(v, tuple) else (v,)
        for i, a in enumerate(blocks):
            key = name if name == "X" and i == 0 else f"{name}{i}"
            out[key] = a.cpu().numpy()
    return out


def _rel_rows(a, c, zero):
    """The largest relative difference of two stats columns, where a row
    equal in both counts 0, and so does a row where both are within
    ``zero`` times the column's largest value of 0: a quantity that is 0
    up to rounding (the TV-l1 deconvolution's DualRsdl of a first
    iteration whose y-step leaves Y at 0: 1.5e-14 of the column's
    largest in float64, 4.9e-5 in float32, on the CPU)."""
    a, c = np.asarray(a, np.float64), np.asarray(c, np.float64)
    floor = zero * np.nanmax(np.abs(c)) if np.isfinite(c).any() else 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.max(np.where(
            (a == c) | (np.isnan(a) & np.isnan(c))
            | (np.maximum(np.abs(a), np.abs(c)) <= floor), 0.0,
            np.abs(a - c) / np.abs(c))))


def f64_parity(label, dev, make, iters=PARITY_ITERS, on_card=None):
    """``make(device)`` (a float64 model of ``iters`` iterations) solved
    on the card and on the CPU: every stats row to rtol 1e-6 (``XSlvRelRes``,
    rounding noise, within 1e-12; a ``Cnstr`` at zero skipped; an entry
    within 1e-12 of its column's largest on both sides counts as equal),
    X and Y within 1e-8 of their scale.  ``on_card(model)``, where given,
    runs after the card's solve (to check its loop)."""
    runs = []
    for d in (dev, "cpu"):
        b = make(d)
        b.solve()
        if on_card is not None and d is dev:
            on_card(b)
        runs.append((b.getitstat(), _state_arrays(b)))
    (ig, ag), (ic, ac) = runs
    if len(ig) != iters or len(ic) != iters:
        raise AssertionError(f"{label}: not {iters} iterations")
    errs = {}
    for name in ig._names[1:]:
        a, c = getattr(ig, name), getattr(ic, name)
        if name == "Cnstr" and np.abs(c).max() < 1e-6 * \
                np.abs(ac["X"]).max():
            continue        # the distance to a constraint set: zero
        if name == "XSlvRelRes":
            # the per-bin solve's relative residual: rounding, about
            # 1e-16; held absolutely, as in the CPU tests (NaN on both
            # sides where LinSolveCheck is off)
            if not np.array_equal(np.isnan(a), np.isnan(c)):
                raise AssertionError(f"{label}: {name} is NaN on one side")
            errs[name] = (float(np.nanmax(np.abs(a - c)))
                          if np.isfinite(c).any() else 0.0)
            if not errs[name] <= 1e-12:
                raise AssertionError(f"{label}: {name} differs by "
                                     f"{errs[name]:.3e}")
            continue
        errs[name] = _rel_rows(a, c, F64_PARITY["zero"])
        if not errs[name] <= F64_PARITY["rows"]:
            raise AssertionError(f"{label}: {name} differs by "
                                 f"{errs[name]:.3e}")
    for name in ag:
        errs[name] = float(np.abs(ag[name] - ac[name]).max()
                           / max(np.abs(ac[name]).max(), 1e-30))
        if not errs[name] <= F64_PARITY["X"]:
            raise AssertionError(f"{label}: {name} differs by "
                                 f"{errs[name]:.3e}")
    return errs


def _timed(b):
    """Solve ``b`` with the launch counts reset just before and read just
    after; returns the wall seconds and the counts."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    b.solve()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, launches()


def _solve_record(b, wall, counts, max_iter):
    its = b.getitstat()
    k = len(its)
    if not (np.all(np.isfinite(its._arr[:, 1:-5]))
            and all(bool(torch.isfinite(v).all())
                    for v in _tree_leaves(b.state.X, b.state.Y))):
        raise AssertionError(f"{type(b).__name__}: not finite")
    loop = generic_loop(type(b).__name__, b, k)
    return {"iterations": k, "converged": k < max_iter,
            "final_objective": float(its._arr[-1, 1]),
            "objective_name": its._names[1], "wall_s": wall,
            "ms_per_iter": 1e3 * wall / k, "rho": float(its.Rho[-1]),
            "launches": counts, "host_reads": loop["host_reads"],
            "route": loop["route"], "device_loop": loop}


def _repeat_ms(make, reps=2):
    """ms an iteration of ``reps`` more solves, each of a fresh model
    ``make()``: the spread of the host-bound loops' times within a run."""
    out = []
    for _ in range(reps):
        b = make()
        wall, _ = _timed(b)
        out.append(1e3 * wall / len(b.getitstat()))
    return out


def _tree_leaves(*ts):
    return [v for t in ts for v in (t if isinstance(t, tuple) else (t,))]


def phase_bpdn_parity(dev):
    """Each BPDN model on (D, S) of ``_bench_bpdn``, 10 iterations in
    float64, card against CPU; BPDN also on the 256 signals."""
    errs = {}
    for K in (1, BPDN_K):
        D, S, x0 = bpdn_problem(K)
        for name, (cls, kw) in bpdn_models(D, S, x0).items():
            if K > 1 and name != "BPDN":
                continue
            label = f"{name} K={K}"
            errs[label] = f64_parity(label, dev, lambda d: cls(
                D, S, opt=cls.options(max_iter=PARITY_ITERS,
                                      rel_stop_tol=0.0),
                dtype=torch.float64, device=d, **kw))
    return {"iterations": PARITY_ITERS, "dtype": "float64",
            "rel_err": errs, "tolerance": F64_PARITY}


def phase_bpdn_solve(dev):
    """Each BPDN model at BASELINE configuration 1's size in float32 to
    1e-3 (500 iterations at most): iterations, objective, ms an
    iteration (and that of two more solves) and X's recovery error
    against x0 on the card (BPDN and BPDNProjL1 converged and within
    1e-2); the final objective within DENSE_OBJ_AGREE of the same solve
    on the CPU (BPDNProjL1's, DFid, which goes to 0, within
    PROJL1_DFID_AGREE of ||S||^2)."""
    out = {}
    for K in (1, BPDN_K):
        D, S, x0 = bpdn_problem(K)
        # warm-up: cuBLAS and cuSOLVER handles
        tbpdn.BPDN(D, S, BPDN_LMBDA, opt=tbpdn.BPDN.options(max_iter=3),
                   device=dev).solve()
        for name, (cls, kw) in bpdn_models(D, S, x0).items():
            if K > 1 and name != "BPDN":
                continue
            opt = cls.options(max_iter=BPDN_ITERS, rel_stop_tol=DENSE_TOL)
            b = cls(D, S, opt=opt, device=dev, **kw)
            wall, counts = _timed(b)
            rec = _solve_record(b, wall, counts, BPDN_ITERS)
            rec["ms_per_iter_repeats"] = _repeat_ms(
                lambda: cls(D, S, opt=opt, device=dev, **kw))
            expect_launches(f"{name} K={K}", counts)
            X = b.getmin().cpu().numpy()
            if X.shape != x0.shape:
                raise AssertionError(f"{name}: X of shape {X.shape}")
            rec["recovery_rel_err"] = float(np.linalg.norm(X - x0)
                                            / np.linalg.norm(x0))
            c = cls(D, S, opt=opt, device="cpu", **kw)
            c.solve()
            ic = c.getitstat()
            rec["cpu_iterations"] = len(ic)
            rec["cpu_final_objective"] = float(ic._arr[-1, 1])
            diff = abs(rec["final_objective"] - rec["cpu_final_objective"])
            if name == "BPDNProjL1":
                # its objective is DFid, which goes to 0 (x0 lies in the
                # l1 ball): held over ||S||^2
                agree = diff / float(np.sum(S.astype(np.float64) ** 2))
                rec["objective_diff_over_S2"] = agree
                limit = PROJL1_DFID_AGREE
            else:
                agree = diff / abs(rec["cpu_final_objective"])
                rec["objective_rel_diff"] = agree
                limit = DENSE_OBJ_AGREE
            if not agree <= limit:
                raise AssertionError(f"{name} K={K}: objective "
                                     f"{rec['final_objective']} against "
                                     f"the CPU's "
                                     f"{rec['cpu_final_objective']}")
            out[f"{name} K={K}"] = rec
    for key in ("BPDN K=1", f"BPDN K={BPDN_K}", "BPDNProjL1 K=1"):
        r = out[key]
        if not (r["converged"] and r["recovery_rel_err"] < 1e-2):
            raise AssertionError(f"{key}: {r['iterations']} iterations, "
                                 f"recovery {r['recovery_rel_err']:.3e}")
    out[f"BPDN K={BPDN_K}"]["problem_iters_per_s"] = \
        BPDN_K * 1e3 / out[f"BPDN K={BPDN_K}"]["ms_per_iter"]
    return out


def phase_tv_parity(dev):
    """The four TV models at their BASELINE sizes, 10 iterations card
    against CPU: in float64 (rows 1e-6, X and Y 1e-8), and in float32 at
    the CPU tests' tolerances (the deconvolutions' transforms of X on
    the FFT kernels on the card, on torch.fft on the CPU)."""
    errs = {}
    for name, (cls, args, _, _) in tv_problems().items():
        opt = cls.options(max_iter=PARITY_ITERS, rel_stop_tol=0.0)
        errs[f"{name} float64"] = f64_parity(name, dev, lambda d: cls(
            *args, opt=opt, dtype=torch.float64, device=d))
        runs = []
        for d in (dev, "cpu"):
            b = cls(*args, opt=opt, device=d)
            b.solve()
            runs.append((b.getitstat(), _state_arrays(b)))
        (ig, ag), (ic, ac) = runs
        e32 = {n: _rel_rows(getattr(ig, n), getattr(ic, n),
                            TV_PARITY["zero"])
               for n in ig._names if n in TV_PARITY}
        e32.update({n: float(np.abs(ag[n] - ac[n]).max()
                             / np.abs(ac[n]).max()) for n in ag})
        for n, e in e32.items():
            tol = TV_PARITY["X" if n in ag else n]
            if not e <= tol:
                raise AssertionError(f"{name} float32 parity: {n} differs "
                                     f"by {e:.3e} (tolerance {tol:.0e})")
        errs[f"{name} float32"] = e32
    return {"iterations": PARITY_ITERS, "rel_err": errs,
            "tolerance": {"float64": F64_PARITY, "float32": TV_PARITY}}


def phase_tv_solve(dev):
    """The four TV models at their BASELINE sizes in float32 on the card:
    iterations, objective, ms an iteration (and that of two more solves),
    PSNR against the clean image above the input's, the final objective
    within TV_OBJ_AGREE of the CPU's; the
    deconvolutions launch ``rfft2_planar`` k + 4 times (the set-up's 4)
    and ``irfft2_planar`` 3k (TVL2) or 2k (TVL1) times, the denoisers no
    kernel."""
    out = {}
    for name, (cls, args, okw, clean) in tv_problems().items():
        cls(*args, opt=cls.options(max_iter=3), device=dev).solve()
        b = cls(*args, opt=cls.options(**okw), device=dev)
        wall, counts = _timed(b)
        rec = _solve_record(b, wall, counts, okw["max_iter"])
        rec["ms_per_iter_repeats"] = _repeat_ms(
            lambda: cls(*args, opt=cls.options(**okw), device=dev))
        k = rec["iterations"]
        if name == "TVL2Deconv":
            expect_launches(name, counts, rfft2_planar=k + 4,
                            irfft2_planar=3 * k)
        elif name == "TVL1Deconv":
            expect_launches(name, counts, rfft2_planar=k + 4,
                            irfft2_planar=2 * k)
        else:
            expect_launches(name, counts)
        X = b.getmin().cpu().numpy()
        S = args[-2]
        rec["psnr_input_db"] = psnr(clean, S)
        rec["psnr_db"] = psnr(clean, X)
        if not rec["psnr_db"] > rec["psnr_input_db"]:
            raise AssertionError(f"{name}: PSNR {rec['psnr_db']:.2f} dB "
                                 f"not above the input's "
                                 f"{rec['psnr_input_db']:.2f}")
        c = cls(*args, opt=cls.options(**okw), device="cpu")
        c.solve()
        ic = c.getitstat()
        rec["cpu_iterations"] = len(ic)
        rec["cpu_final_objective"] = float(ic.ObjFun[-1])
        agree = abs(rec["final_objective"] - rec["cpu_final_objective"]) \
            / abs(rec["cpu_final_objective"])
        rec["objective_rel_diff"] = agree
        if not agree <= TV_OBJ_AGREE:
            raise AssertionError(f"{name}: objective "
                                 f"{rec['final_objective']} against the "
                                 f"CPU's {rec['cpu_final_objective']}")
        out[name] = rec
    return out


def _rpca_sketch():
    return torch.randn(RPCA_N, RPCA_RANK + 10,
                       generator=torch.Generator().manual_seed(0))


def rpca_loop(label, k):
    """Robust PCA's last solve ran on the graph route, captured (under
    ``global_capture()``: nothing in its iteration synchronises
    with the host) and read the host exactly ``ceil(k / 8) + 1`` times;
    its Jacobi SVD's sweeps, counted on the device (the loop's inner
    passes), ran.  The CPU rehearsal (``LOOP_GRAPH`` off) checks the
    reads alone: its SVD is ``torch.linalg.svd``."""
    last = dict(device_loop.LAST)
    reads = exact_reads(label, k)
    if LOOP_GRAPH and not (last.get("graph") and last.get("route") == "graph"
                           and last.get("inner", 0) > 0):
        raise AssertionError(f"{label}: not a graph-route run with Jacobi "
                             f"sweeps: {last}")
    return {"host_reads": reads, "svd_sweeps": last.get("inner"),
            "captured": last.get("captured")}


def phase_rpca_parity(dev):
    """Robust PCA at 512x512, 10 iterations in float64 card against CPU,
    the randomized SVD (the same sketch on both sides) and the full
    SVD; the card's loop on the graph route with exact reads."""
    S, _, _ = rpca_problem()
    sk = _rpca_sketch().double()
    errs, loops = {}, {}
    for label, kw in (("randomized", {"svd_rank": RPCA_RANK,
                                      "sketch": sk}),
                      ("full", {})):
        def on_card(b, label=label):
            loops[label] = rpca_loop(f"RobustPCA {label} float64",
                                     PARITY_ITERS)
        with global_capture():
            errs[label] = f64_parity(f"RobustPCA {label}", dev, lambda d: (
                trpca.RobustPCA(S, opt=trpca.RobustPCA.options(
                    max_iter=PARITY_ITERS, rel_stop_tol=0.0),
                    dtype=torch.float64, device=d, **kw)), on_card=on_card)
    return {"iterations": PARITY_ITERS, "dtype": "float64",
            "rel_err": errs, "tolerance": F64_PARITY, "loop": loops}


def rpca_solves(dev, S, L, Ssp, dtype, agree, what="RobustPCA"):
    """Robust PCA of ``S`` (low-rank part ``L``, sparse part ``Ssp``) in
    ``dtype`` on the card: the randomized SVD (rank 16, the model's default
    sketch) and the full SVD, to 1e-3 (200 iterations at most), on the
    graph route (captured under ``global_capture()``, exactly ``ceil(k /
    8) + 1`` host reads, the device's ``jac_round`` launches the sweeps
    the loop counted times the rounds a sweep): iterations, objective, ms
    an iteration and the recovery of both parts (1% of their norms), and
    the ms an iteration of two more solves; against the same solve on the
    CPU (the randomized with the same sketch) the iterations within one
    and the final objective within ``agree``."""
    out = {}
    opt = trpca.RobustPCA.options(max_iter=RPCA_ITERS,
                                  rel_stop_tol=DENSE_TOL)
    for label, kw in (("randomized", {"svd_rank": RPCA_RANK}),
                      ("full", {})):
        name = f"{what} {label}"
        with global_capture():
            trpca.RobustPCA(S, opt=trpca.RobustPCA.options(max_iter=3),
                            dtype=dtype, device=dev, **kw).solve()
        b = trpca.RobustPCA(S, opt=opt, dtype=dtype, device=dev, **kw)
        wall, counts = _timed(b)
        rec = _solve_record(b, wall, counts, RPCA_ITERS)
        rec.update(rpca_loop(name, rec["iterations"]))
        # jac_round: the rounds of every sweep the device loop counted
        jac = 0
        if LOOP_GRAPH:
            geo = tsvd.LAST["geometry"]
            rec["svd_geometry"] = list(geo)
            jac = rec["svd_sweeps"] * (geo.Pp // geo.w - 1)
        expect_launches(name, counts, jac_round=jac)
        rec["ms_per_iter_repeats"] = _repeat_ms(
            lambda: trpca.RobustPCA(S, opt=opt, dtype=dtype, device=dev,
                                    **kw))
        X, Y = (t.cpu().numpy() for t in (b.state.X, b.state.Y))
        rec["lowrank_rel_err"] = float(np.linalg.norm(X - L)
                                       / np.linalg.norm(L))
        rec["sparse_rel_err"] = float(np.linalg.norm(Y - Ssp)
                                      / np.linalg.norm(Ssp))
        if not (rec["lowrank_rel_err"] < 1e-2
                and rec["sparse_rel_err"] < 1e-2):
            raise AssertionError(f"{name}: recovery "
                                 f"{rec['lowrank_rel_err']:.3e}, "
                                 f"{rec['sparse_rel_err']:.3e}")
        if "svd_rank" in kw:
            kw = dict(kw, sketch=b.params["sketch"].cpu())
        t0 = time.perf_counter()
        c = trpca.RobustPCA(S, opt=opt, dtype=dtype, device="cpu", **kw)
        c.solve()
        rec["cpu_s"] = time.perf_counter() - t0
        ic = c.getitstat()
        rec["cpu_iterations"] = len(ic)
        rec["cpu_final_objective"] = float(ic.ObjFun[-1])
        diff = abs(rec["final_objective"] - rec["cpu_final_objective"]) \
            / abs(rec["cpu_final_objective"])
        rec["objective_rel_diff"] = diff
        if not (abs(rec["iterations"] - len(ic)) <= 1 and diff <= agree):
            raise AssertionError(
                f"{name}: {rec['iterations']} iterations, objective "
                f"{rec['final_objective']} against the CPU's {len(ic)}, "
                f"{rec['cpu_final_objective']}")
        out[label] = rec
    return out


def phase_rpca_solve(dev):
    """BASELINE configuration 3 in float32 on the card, as
    ``rpca_solves`` runs it, each final objective within RPCA_OBJ_AGREE
    of the CPU's."""
    return rpca_solves(dev, *rpca_problem(), torch.float32, RPCA_OBJ_AGREE)


# the decompositions of Robust PCA's x-step at its shapes: the full SVD,
# the SVD of the randomized form's small matrix b = q^T v (rank 16 plus
# 10 over 512 columns) and the QR of its 512 x 26 sketches
SVD_SHAPES = (("full", (RPCA_N, RPCA_N)), ("small", (RPCA_RANK + 10, RPCA_N)))
QR_SHAPE = (RPCA_N, RPCA_RANK + 10)
# beyond them, in the type given: rows too long for one block's shared
# memory (a wide and a tall matrix, in a cluster's), a video's pixels by
# frames (76800 x 100, tests/test_torch_svd.py: rows beyond a cluster's
# shared memory, the kernel's route in global memory) and a larger
# square, timed beside torch.linalg.svd
SVD_MORE = (("wide", (4, 20000), torch.float64),
            ("tall", (30000, 8), torch.float32),
            ("video", (76800, 100), torch.float32),
            ("large", (2048, 2048), torch.float32))
# the Jacobi SVD against torch.linalg.svd on the card: singular values of
# the largest, the product of a's norm, orthonormality, each within
# SVD_TOL L eps for rows of length L (a Jacobi SVD's rounding: an entry
# goes through some P rotations a sweep; tests/test_torch_svd.py); the
# thresholded product of the prox (eight values kept, above a gap) within
# the same of its norm
SVD_TOL = 8


def _svd_errors(a, u, s, vt, s_ref):
    k = min(a.shape)
    eye = torch.eye(k, dtype=a.dtype, device=a.device)
    return {"s": float((s - s_ref).abs().max() / s_ref[0]),
            "recon": float(((u * s) @ vt - a).norm() / a.norm()),
            "orth_u": float((u.mH @ u - eye).abs().max()),
            "orth_v": float((vt @ vt.mH - eye).abs().max())}


def _all_nan(ts):
    return all(bool(torch.isnan(t).all()) for t in ts)


def jacobi_bound_ms(geo, sweeps, itemsize, cplx=False):
    """Least time on an H100 SXM of one Jacobi SVD in the geometry ``geo``
    that took ``sweeps`` sweeps, of a matrix of ``itemsize``-byte
    entries: its bytes, the matrix (P x L) read once and u, s and v^T (P
    x P, P and P x L) written once, over ``PEAK_HBM_BYTES``; its
    operations, the sweeps' rounds of pairs each forming its Gram
    matrix's upper triangle and applying R to its rows of W and Q, in
    double over ``PEAK_FP64_FLOPS``, a complex (``cplx``) multiply-add
    counted as four real ones; the larger of the two, and which bounds
    it."""
    P, L, w, Pp = geo[:4]
    n2, rounds = 2 * w, Pp // w - 1
    flops = Pp // n2 * (n2 * (n2 + 1) * L + 2 * n2 * n2 * (L + Pp))
    if cplx:
        flops *= 4
    t_ops = sweeps * rounds * flops / PEAK_FP64_FLOPS * 1e3
    t_bytes = itemsize * (2 * P * L + P * P + P) / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _svd_case(a, name, jacobi_plain, reps, prox):
    """The Jacobi SVD of ``a`` (on the card) checked and timed: its
    "eager" form (each sweep's flag read on the host) against
    ``torch.linalg.svd`` within ``SVD_TOL`` L eps, where ``prox`` the
    prox's thresholded product too (``a`` of rank 8 over noise: the
    threshold in the gap after the 8th value) and, where
    ``jacobi_plain``, against the kernels' own plain version (its time
    ``jacobi_plain_ms``, the largest difference of the singular values
    ``max_abs_err``); its "node" form captured under global mode
    (``device_loop._capture``) replays bit for bit the eager form's
    outputs, and with a NaN in the input gives NaN in every output with
    no synchronisation; ``ms`` the replay, ``plain_ms``
    ``torch.linalg.svd``; the geometry (``C``, ``w``, the route, blocks a
    round, launches a sweep: its rounds and ``jac_sweep_end``), the
    replay's ``jac_round`` launches counted on the device (the sweeps
    times the rounds, or the case fails) and ``bound_ms``."""
    limit = SVD_TOL * max(a.shape) * torch.finfo(a.dtype).eps
    u, s, vt = tsvd.jacobi_svd(a)
    status = tsvd.LAST["status"].tolist()
    geo = tsvd.LAST["geometry"]
    up, sp, vp = tsvd.svd_plain(a)
    errs = _svd_errors(a, u, s, vt, sp)
    rounds = geo.Pp // geo.w - 1
    rec = {"shape": list(a.shape), "geometry": list(geo),
           "C": geo.C, "w": geo.w,
           "route": "shared" if geo.shared else "global",
           "blocks_per_round": geo.Pp // (2 * geo.w) * geo.C,
           "rounds_per_sweep": rounds, "launches_per_sweep": rounds + 1,
           "sweeps": status[1], "unconverged": status[2],
           "vs_plain": errs, "plain": _svd_errors(a, up, sp, vp, sp),
           "limit": limit}
    rec["bound_ms"], rec["bound_by"] = jacobi_bound_ms(
        geo, status[1], a.element_size(), a.is_complex())
    checks = dict(errs)
    if prox:
        alpha = 0.5 * (sp[7] + sp[8])
        x = (u * torch.clamp(s - alpha, min=0)) @ vt
        xp = (up * torch.clamp(sp - alpha, min=0)) @ vp
        checks["prox"] = rec["prox_vs_plain"] = float(
            (x - xp).norm() / xp.norm())
    if jacobi_plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        jp = tsvd.jacobi_svd_plain(a)
        torch.cuda.synchronize()
        rec["jacobi_plain_ms"] = 1e3 * (time.perf_counter() - t0)
        rec["vs_jacobi_plain"] = _svd_errors(a, u, s, vt, jp[1])
        rec["max_abs_err"] = float((s - jp[1]).abs().max())
        rec["jacobi_plain_sweeps"] = tsvd.LAST["sweeps"]
        checks["jacobi_plain"] = rec["vs_jacobi_plain"]["s"]
    bad = {k: v for k, v in checks.items() if not v <= limit}
    if bad or status[2]:
        raise AssertionError(f"jacobi_svd {name}: {bad}, status {status}")
    x = a.clone()
    outs = [torch.empty_like(t) for t in (u, s, vt)]

    def step():
        for o, t in zip(outs, tsvd.jacobi_svd(x)):
            o.copy_(t)
    with global_capture():
        graph = device_loop._capture(step, a.device)
    torch.cuda.synchronize()
    tsvd.reset_launches()
    graph.replay()
    rec["jac_round_launches"] = tsvd.launches(a.device)
    if rec["jac_round_launches"] != status[1] * rounds:
        raise AssertionError(f"jacobi_svd {name}: {rec['jac_round_launches']}"
                             f" jac_round launches for {status[1]} sweeps "
                             f"of {rounds} rounds")
    rec["replay_equals_eager"] = all(torch.equal(o, t) for o, t in
                                     zip(outs, (u, s, vt)))
    if not rec["replay_equals_eager"]:
        raise AssertionError(f"jacobi_svd {name}: the captured form's "
                             "replay differs from the eager form")
    x[1, 2] = math.nan
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rec["nan_gives_nan"] = _all_nan(outs)
    if not rec["nan_gives_nan"]:
        raise AssertionError(f"jacobi_svd {name}: a NaN input gave a "
                             "finite output")
    x.copy_(a)
    rec["ms"] = cuda_ms(graph.replay, reps=reps, warmup=1)
    rec["plain_ms"] = cuda_ms(lambda: tsvd.svd_plain(a), reps=reps, warmup=1)
    return rec


def phase_svd_qr(dev):
    """Robust PCA's x-step decompositions on the card.  The Jacobi SVD
    (``ops/svd.py`` ``jacobi_svd``, the kernels of
    ``csrc/jacobi_svd.cu``) of a 512x512 matrix and of a 26x512 one (the
    randomized form's small matrix), each rank 8 at scale 10 over unit
    noise, in float32 and float64, then of ``SVD_MORE`` (Gaussian, no
    prox), each as ``_svd_case`` checks it (against the kernels' plain
    version too, but at 512x512 float64 and 2048x2048).  The QR
    (``torch.linalg.qr``) of a 512x26 matrix captured under global mode:
    its replay equals the eager call bit for bit, a NaN input gives NaN.
    Times from CUDA events beside ``torch.linalg``'s, with the card's
    name and power limit."""
    out = {"nvidia_smi": nvidia_smi(), "svd": {}, "qr": {}}
    g = torch.Generator().manual_seed(7)
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[1]
        for label, shape in SVD_SHAPES:
            # rank 8 at scale 10 over unit noise, Robust PCA's x-step
            # input in kind: the prox's threshold between the 8th and 9th
            # singular values falls in a gap
            lo = torch.randn(shape[0], 8, generator=g, dtype=dt) @ \
                torch.randn(8, shape[1], generator=g, dtype=dt)
            a = (10.0 * lo + torch.randn(shape, generator=g, dtype=dt)).to(
                dev)
            out["svd"][f"{name} {label}"] = _svd_case(
                a, f"{name} {label}", label == "small" or name == "float32",
                reps=10, prox=True)
        y = torch.randn(QR_SHAPE, generator=g, dtype=dt).to(dev)
        q_eager = torch.linalg.qr(y)[0]
        static = y.clone()
        q = torch.empty_like(q_eager)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="global"):
            q.copy_(torch.linalg.qr(static)[0])
        graph.replay()
        rec = {"shape": list(QR_SHAPE),
               "replay_equals_eager": bool(torch.equal(q, q_eager))}
        static[3, 4] = math.nan
        graph.replay()
        rec["nan_gives_nan"] = _all_nan([q])
        static.copy_(y)
        rec["ms"] = cuda_ms(graph.replay, reps=20)
        rec["eager_ms"] = cuda_ms(lambda: torch.linalg.qr(y), reps=20)
        if not (rec["replay_equals_eager"] and rec["nan_gives_nan"]):
            raise AssertionError(f"qr {name}: {rec}")
        out["qr"][name] = rec
    for label, shape, dt in SVD_MORE:
        a = torch.randn(shape, generator=g, dtype=dt).to(dev)
        name = f"{str(dt).split('.')[1]} {label}"
        out["svd"][name] = _svd_case(a, name, label != "large", reps=3,
                                     prox=False)
    return out


# complex Robust PCA (the JAX package's RobustPCA takes complex64 and
# complex128): rpca_problem made complex, and the complex Jacobi SVD
# (csrc/jacobi_svd.cu jac_round<w, SH, true>, launched by
# jac_round_z_launch) at its x-step's shapes, the full and
# the randomized form's small matrix, and a 256 x 192 beside them
CSVD_SHAPES = (("full", (RPCA_N, RPCA_N)), ("small", (RPCA_RANK + 10, RPCA_N)),
               ("mid", (256, 192)))
# the complex64 solves' final objectives against the same solves on the
# CPU: the limit between the card's difference and the spread that moving
# S by one float32 ulp (both parts) gives two CPU solves
# (tools/dense_cpu_study.py ulp "RobustPCA complex randomized" "RobustPCA
# complex full", on the card's machine; the card an H100): randomized,
# the card equal, one ulp 5.3e-7; full, the card 2.1e-7 off, one ulp
# 1.2e-6
RPCA_COMPLEX_OBJ_AGREE = 5e-7


def rpca_complex_problem(seed=0):
    """``rpca_problem`` made complex: rank 8 plus 10% sparse outliers at
    scale 5, 512x512, complex64, the factors and the outliers complex
    Gaussians of unit variance from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)

    def cn(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)) / np.sqrt(2.0)
    L = cn(RPCA_N, RPCA_R) @ cn(RPCA_R, RPCA_N)
    Ssp = (rng.random((RPCA_N, RPCA_N)) > 0.9) * cn(RPCA_N, RPCA_N) * 5
    return (L + Ssp).astype(np.complex64), L, Ssp


def rpca_complex_solves(dev):
    """Complex64 Robust PCA on ``rpca_complex_problem``, as
    ``rpca_solves`` runs it (the device's ``jac_round`` launches the
    complex form's), each final objective within
    ``RPCA_COMPLEX_OBJ_AGREE`` of the CPU's."""
    return rpca_solves(dev, *rpca_complex_problem(), torch.complex64,
                       RPCA_COMPLEX_OBJ_AGREE, "complex RobustPCA")


def phase_rpca_complex(dev):
    """Complex Robust PCA on the card.  The complex form of the Jacobi SVD
    (``jac_round<w, SH, true>``) of complex64 matrices of rank 8 at scale
    10 over unit noise at ``CSVD_SHAPES``, each as ``_svd_case`` checks it
    (against ``torch.linalg.svd``, the prox's thresholded product, the
    kernels' plain version on the card but at 256x192, which is no
    shape of the x-step's, the captured replay bit for bit, NaN in gives
    NaN out, the device's launches) and times it beside
    ``torch.linalg.svd``, with the card's name and power limit; then
    ``rpca_complex_solves``."""
    out = {"nvidia_smi": nvidia_smi(), "svd": {}}
    g = torch.Generator().manual_seed(9)
    dt = torch.complex64
    for label, shape in CSVD_SHAPES:
        lo = torch.randn(shape[0], 8, generator=g, dtype=dt) @ \
            torch.randn(8, shape[1], generator=g, dtype=dt)
        a = (10.0 * lo + torch.randn(shape, generator=g, dtype=dt)).to(dev)
        out["svd"][f"complex64 {label}"] = _svd_case(
            a, f"complex64 {label}", label != "mid", reps=5, prox=True)
    out.update(rpca_complex_solves(dev))
    return out


def dense_profile_models(dev):
    """profile phase name -> a maker of the float32 model it profiles: BPDN
    on the 256 signals, ``TVL2Denoise``, ``TVL2Deconv`` and the
    randomized Robust PCA, as their solve phases run them."""
    D, S, _ = bpdn_problem(BPDN_K)
    tv = tv_problems()

    def tvm(name):
        cls, args, okw, _ = tv[name]
        return lambda: cls(*args, opt=cls.options(**okw), device=dev)
    Sr, _, _ = rpca_problem()
    return {
        "bpdn_profile": lambda: tbpdn.BPDN(
            D, S, BPDN_LMBDA, device=dev, opt=tbpdn.BPDN.options(
                max_iter=BPDN_ITERS, rel_stop_tol=DENSE_TOL)),
        "tvl2den_profile": tvm("TVL2Denoise"),
        "tvl2dcn_profile": tvm("TVL2Deconv"),
        "rpca_profile": lambda: trpca.RobustPCA(
            Sr, svd_rank=RPCA_RANK, device=dev,
            opt=trpca.RobustPCA.options(max_iter=RPCA_ITERS,
                                        rel_stop_tol=DENSE_TOL))}


def phase_dictlrn_handover(dev, D, S, lmbda):
    """The generic ``DictLearn`` alternation over port models on the card
    at the headline size (ConvBPDN, fused, and the consensus CCMOD, each
    5 iterations an outer iteration): its user-layout hand-overs take
    the models' own card tensors.  3 outer iterations: one csc_iter an
    inner ADMM iteration, finite, filters in the unit ball, and the
    dictionary and coefficients within 2e-4 of their scale of the same
    run on the CPU."""
    def make(d):
        x = ConvBPDN(D, S, lmbda, opt=ConvBPDN.options(
            max_iter=HANDOVER_INNER, rel_stop_tol=0.0), device=d)
        z0 = np.zeros(S.shape[:2] + (1, 1, D.shape[-1]), np.float32)
        dstep = tccmod.ConvCnstrMOD(
            z0, S, D.shape, method="cns", device=d,
            opt=tccmod.ConvCnstrMODBase.options(max_iter=HANDOVER_INNER,
                                               rel_stop_tol=0.0))
        return tdl.DictLearn(x, dstep, max_iter=HANDOVER_OUTER)
    b = make(dev)
    wall, counts = _timed(b)
    want = HANDOVER_OUTER * HANDOVER_INNER
    if counts["csc_iter"] != want:
        raise AssertionError(f"DictLearn: launches {counts}, expected "
                             f"{want} csc_iter")
    Dl, Xl = b.getdict(), b.getcoef()
    if Dl.device != Xl.device or Dl.device.type != torch.device(dev).type:
        raise AssertionError("DictLearn: the results left the card")
    if not (bool(torch.isfinite(Dl).all()) and bool(torch.isfinite(Xl)
                                                    .all())):
        raise AssertionError("DictLearn: not finite")
    nrm = float(Dl.double().pow(2).sum(dim=(0, 1)).sqrt().max())
    if not nrm <= 1.0 + 1e-5:
        raise AssertionError(f"DictLearn: a filter of norm {nrm}")
    c = make("cpu")
    c.solve()
    errs = {}
    for key, g, r in (("D", Dl, c.getdict()), ("X", Xl, c.getcoef())):
        g, r = g.cpu().numpy(), r.numpy()
        errs[key] = float(np.abs(g - r).max() / np.abs(r).max())
        if not errs[key] <= 2e-4:
            raise AssertionError(f"DictLearn: {key} differs from the CPU "
                                 f"run by {errs[key]:.3e}")
    its = b.getitstat()
    return {"outer_iterations": HANDOVER_OUTER,
            "inner_iterations": HANDOVER_INNER, "wall_s": wall,
            "ms_per_outer_iter": 1e3 * wall / HANDOVER_OUTER,
            "x_objective": its["XObjFun"].tolist(),
            "d_dfid": its["DDFid"].tolist(), "max_filter_norm": nrm,
            "rel_err_vs_cpu": errs, "launches": counts}


# ---------------------------------------------------------------------------
# Masked, online and patch dictionary learning: the two-block CSC models,
# ConvBPDNMaskDictLearn, online CDL and the dense learners

# ConvL1L1Grd at examples/csc_impulse_denoise.py:41 (lmbda 3e-2, mu 0.1,
# an impulse filter whose map carries the smooth part, with the gradient
# penalty on it alone and no l1 weight) on the headline image with
# salt-and-pepper noise at the example's density 0.2; ConvMinL1InL2Ball
# at examples/csc_minl1.py:32 (epsilon = 1.1 sigma N) on the headline
# image with Gaussian noise sigma
L1L1_LMBDA, L1L1_MU, SPN_FRC = 3e-2, 0.1, 0.2
MINL1_SIGMA = 0.1
ONLINE_SAMPLES, ONLINE_LMBDA = 5, 0.05
ONLINE_PARITY_SAMPLES, ONLINE_PARITY_ITERS = 2, 3
MDL_PAIRS = (("admm", "cns"), ("admm", "ism"), ("admm", "cg"),
             ("pgm", "pgm"))
MDL_CG_ITERS = 10
# the depth of the two-block models' and the masked learner's float64
# card-against-CPU checks (a crop, and fewer iterations than PARITY_ITERS
# and CNS_PARITY_ITERS), to keep the script in its time (PERF.md, 4; the
# crop 128x128 since complex Robust PCA's phase came)
MASKDCPL_PARITY_N, MASKDCPL_PARITY_ITERS = 128, 2
MDL_PARITY_ITERS = 1
# the pairs whose float32 x-step objective, one inner iteration an outer
# one, falls and then rises over CNS_ITERS outer iterations at this
# geometry in the JAX package too (on the CPU: (admm, cns) 51815 ->
# least 23823 at 37 -> 82034, while the masked consensus d-step's
# AutoRho multiplies rho every outer iteration, 40 -> 1.2e16; (pgm, pgm)
# 235481 -> least 40725 at 14 -> 273936, FISTA at the default L = 14 K,
# in float64 as well; tools/dense_cpu_study.py mdl jax): their gate is
# the least objective below the first
MDL_RISE = (("admm", "cns"), ("pgm", "pgm"))
# the dense learners: every 8x8 patch at stride 1 of a 256x256 image,
# zero-mean, 128 atoms, lmbda 0.1
DDL_IMG, DDL_PATCH, DDL_ATOMS, DDL_LMBDA = 256, 8, 128, 0.1
DDL_ITERS, DDL_PARITY_ITERS = 50, 5
UNIT_NORM = 1e-5


def impulse_problem(S):
    """The headline image with salt-and-pepper noise (density SPN_FRC,
    half each to the image's minimum and maximum; the draw from
    ``numpy.random.default_rng(1)``) and the example's dictionary: the
    headline filters and an impulse, with its l1 and gradient weights."""
    m = np.random.default_rng(1).random(S.shape)
    Sn = S.copy()
    Sn[m < SPN_FRC / 2] = S.min()
    Sn[m > 1.0 - SPN_FRC / 2] = S.max()
    wl1 = np.ones((1, 1, 1, 1, M + 1), np.float32)
    wl1[..., -1] = 0.0
    wgrd = np.zeros(M + 1, np.float32)
    wgrd[-1] = 1.0
    return Sn.astype(np.float32), wl1, wgrd


def impulse_dict(D):
    imp = np.zeros((ND, ND, 1), np.float32)
    imp[0, 0, 0] = 1.0
    return np.concatenate([D, imp], axis=-1)


def two_block_models(D, S, W, Sm):
    """name -> (class, positional arguments, keyword arguments, the
    launches per iteration and in the set-up of rfft2_planar and
    irfft2_planar): ConvBPDNMaskDcpl on the masked headline,
    ConvL1L1Grd on its impulse-noise image, ConvMinL1InL2Ball on its
    Gaussian-noise image.  The x-step is 2 forward and 2 inverse
    transforms an iteration; the dual residual rho A^T U 1 and 1
    (ConvL1L1Grd: its standard residual and its normaliser, 2 and 2);
    the set-up transforms the dictionary (ConvL1L1Grd: and the gradient
    filters)."""
    Sn, wl1, wgrd = impulse_problem(S)
    Sg = (S + MINL1_SIGMA * np.random.default_rng(2).standard_normal(
        S.shape)).astype(np.float32)
    return {
        "ConvBPDNMaskDcpl": (tcbpdn.ConvBPDNMaskDcpl, (D, Sm, LMBDA),
                             {"W": W}, (3, 1)),
        "ConvL1L1Grd": (tcbpdn.ConvL1L1Grd, (impulse_dict(D), Sn,
                                             L1L1_LMBDA),
                        {"mu": L1L1_MU, "wl1": wl1, "wgrd": wgrd}, (4, 2)),
        "ConvMinL1InL2Ball": (tcbpdn.ConvMinL1InL2Ball,
                              (D, Sg, 1.1 * MINL1_SIGMA * S.shape[0]), {},
                              (3, 1)),
    }


def phase_maskdcpl_parity(dev, D, S, W, Sm):
    """Each two-block model on the MASKDCPL_PARITY_N crop of its problem
    (the top left of S, W and Sm), MASKDCPL_PARITY_ITERS iterations in
    float64, card against CPU (rows 1e-6, X, DX, Y0 and Y1 within 1e-8
    of their scale)."""
    errs = {}
    k, n = MASKDCPL_PARITY_ITERS, MASKDCPL_PARITY_N
    S, W, Sm = (a[:n, :n] for a in (S, W, Sm))
    for name, (cls, args, kw, _) in two_block_models(D, S, W, Sm).items():
        errs[name] = f64_parity(name, dev, lambda d: cls(
            *args, opt=cls.options(max_iter=k, rel_stop_tol=0.0),
            dtype=torch.float64, device=d, **kw), iters=k)
    return {"iterations": k, "side": S.shape[0], "dtype": "float64",
            "rel_err": errs, "tolerance": F64_PARITY}


def phase_maskdcpl_solve(dev, D, S, W, Sm):
    """Each two-block model in float32 to 1e-3 (500 iterations at most):
    iterations, objective, ms an iteration (three solves); the FFT
    kernels' launches as ``two_block_models`` predicts them, no other
    kernel; ConvBPDNMaskDcpl's objective beside AddMaskSim's on the same
    image (a different problem: reported, not gated)."""
    out = {}
    for name, (cls, args, kw, (per, setup)) in two_block_models(
            D, S, W, Sm).items():
        opt = cls.options(max_iter=MAX_ITER, rel_stop_tol=REL_TOL)
        cls(*args, opt=cls.options(max_iter=3), device=dev, **kw).solve()
        b = cls(*args, opt=opt, device=dev, **kw)
        wall, counts = _timed(b)
        rec = _solve_record(b, wall, counts, MAX_ITER)
        rec["ms_per_iter_repeats"] = _repeat_ms(
            lambda: cls(*args, opt=opt, device=dev, **kw))
        k = rec["iterations"]
        expect_launches(name, counts, rfft2_planar=per * k + setup,
                        irfft2_planar=per * k)
        X = b.getmin()
        if tuple(X.shape[-1:]) != (args[0].shape[-1],):
            raise AssertionError(f"{name}: coefficients of shape "
                                 f"{tuple(X.shape)}")
        if name == "ConvMinL1InL2Ball":
            its = b.getitstat()
            rec["constraint_violation"] = float(its.Cnstr[-1])
            rec["epsilon"] = args[2]
        out[name] = rec
    return out


def mdl_mask(S):
    """The mask of the consensus masked stage: CNS_KEPT of the pixels
    (``numpy.random.default_rng(4)``)."""
    return (np.random.default_rng(4).random(S.shape)
            < CNS_KEPT).astype(np.float32)


def _learner_arrays(d):
    """The dictionary and the coefficients (online CDL: the last
    sample's) of a learner, as numpy arrays."""
    Z = d.getcoef() if hasattr(d, "getcoef") else d.xstep.getcoef()
    return {"D": d.getdict().cpu().numpy(), "Z": Z.cpu().numpy()}


def learner_parity(label, dev, make, run=lambda d: d.solve()):
    """``make(device)`` (a float64 learner) run by ``run`` on the card
    and on the CPU: every itstat column to rtol 1e-6 (a ``Cnstr`` or
    ``XSlvRelRes`` column, rounding noise, within 1e-10 absolutely; an
    entry within 1e-12 of its column's largest on both sides counts as
    equal), and its arrays within 1e-8 of their scale."""
    out = []
    for d in (dev, "cpu"):
        m = make(d)
        run(m)
        out.append((m.getitstat(), _learner_arrays(m)))
    (ig, ag), (ic, ac) = out
    errs = {}
    for name in ic:
        a, c = np.asarray(ig[name]), np.asarray(ic[name])
        if name.endswith("Cnstr") or name.endswith("XSlvRelRes"):
            e = float(np.nanmax(np.abs(a - c))) if np.isfinite(c).any() \
                else 0.0
            lim = 1e-10
        else:
            e, lim = _rel_rows(a, c, F64_PARITY["zero"]), F64_PARITY["rows"]
        errs[name] = e
        if not e <= lim:
            raise AssertionError(f"{label}: {name} differs by {e:.3e}")
    for name in ac:
        errs[name] = float(np.abs(ag[name] - ac[name]).max()
                           / max(np.abs(ac[name]).max(), 1e-30))
        if not errs[name] <= F64_PARITY["X"]:
            raise AssertionError(f"{label}: {name} differs by "
                                 f"{errs[name]:.3e}")
    return errs


def _mdl(D0, S, W, lmbda, xm, dm, dev, max_iter, dtype=torch.float32):
    return tdl.ConvBPDNMaskDictLearn(D0, S, lmbda, W=W, xmethod=xm,
                                     dmethod=dm, max_iter=max_iter,
                                     dtype=dtype, device=dev)


def _fixed_cg(d):
    """The CG d-step at a fixed MDL_CG_ITERS iterations (tolerance 0): at
    its default tolerance a rounding difference can move its stopping
    test by one iteration, which parts card and CPU by 1e-6 of DualRsdl
    (my first chip run)."""
    if d.dmethod == "cg":
        d.dstep.cfg = dataclasses.replace(d.dstep.cfg, cg_tol=0.0,
                                          cg_max_iter=MDL_CG_ITERS)
    return d


def phase_mdl_parity(dev, D0, S, lmbda):
    """ConvBPDNMaskDictLearn at the consensus geometry, each method pair
    of MDL_PAIRS, MDL_PARITY_ITERS outer iterations in float64, card
    against CPU (the CG d-step at MDL_CG_ITERS iterations)."""
    W = mdl_mask(S)
    errs = {f"{xm}/{dm}": learner_parity(
        f"ConvBPDNMaskDictLearn ({xm}, {dm})", dev,
        lambda d: _fixed_cg(_mdl(D0, S, W, lmbda, xm, dm, d,
                                 MDL_PARITY_ITERS, torch.float64)))
        for xm, dm in MDL_PAIRS}
    return {"outer_iterations": MDL_PARITY_ITERS, "dtype": "float64",
            "cg_iterations": MDL_CG_ITERS, "rel_err": errs,
            "tolerance": F64_PARITY}


def mdl_launches(xm, dm):
    """The kernels one outer iteration of ConvBPDNMaskDictLearn launches
    at the consensus geometry in float32: the ADMM x-step (one two-block
    iteration) 4 forward and 3 inverse transforms (the set-up's
    dictionary, the x-step's 2 and 2, rho A^T U); the FISTA x-step one
    ``pgm_iter`` on its fused masked problem; the ``cns`` d-step 4 and 2
    (the set-up's Z and S, the x-step's 2 and 2), ``ism``/``cg`` 6 and 4
    (also the standard dual residual and its normaliser), the FISTA
    d-step 5 and 3 (the set-up's 2, the masked gradient's 2 and 2, the
    masked objective's 1 and 1)."""
    x = {"admm": (0, 4, 3), "pgm": (1, 0, 0)}[xm]
    d = {"cns": (4, 2), "ism": (6, 4), "cg": (6, 4), "pgm": (5, 3)}[dm]
    return {"pgm_iter": x[0], "rfft2_planar": x[1] + d[0],
            "irfft2_planar": x[2] + d[1]}


@contextlib.contextmanager
def cg_record():
    """The records (``ops/linalg.py`` ``CG_LAST``) of the CG solves run
    inside the block."""
    seen = []
    cg = tla.cg

    def recorded(*a, **k):
        out = cg(*a, **k)
        seen.append(dict(tla.CG_LAST))
        return out
    tla.cg = recorded
    try:
        yield seen
    finally:
        tla.cg = cg


@contextlib.contextmanager
def solve_record(model):
    """The device loop's records (``device_loop.LAST``, with the generic
    ADMM loop's ``inner``) of the calls of ``model.solve`` inside the
    block."""
    seen = []
    solve = model.solve

    def recorded(*a, **k):
        out = solve(*a, **k)
        seen.append(dict(device_loop.LAST))
        return out
    model.solve = recorded
    try:
        yield seen
    finally:
        del model.solve


def check_cg_loops(label, cgs, subs, route="graph"):
    """The CG d-step's solves (their device loops' records ``subs``) on
    ``route``: each of k ADMM iterations read the host ``ceil(k / 8) +
    1`` times and ran some CG iterations (the loop's device count); on
    the graph route every CG solve a WHILE node of the captured iteration
    that read nothing, on the eager route a graph of its own that read
    once.  Returns the solves' (k, CG iterations, host reads)."""
    if not subs:
        raise AssertionError(f"{label}: no CG d-step ran")
    form, reads = ("node", 0) if route == "graph" else ("graph", 1)
    for r in subs:
        want = math.ceil(r["live"] / device_loop.UNROLL) + 1
        if r["host_reads"] != want or r["inner"] <= 0 or (
                LOOP_GRAPH and (r["route"] != route
                                or r["graph"] != (route == "graph"))):
            raise AssertionError(f"{label}: a d-step's loop record {r}, "
                                 f"not {want} reads of a {route} run with "
                                 "CG iterations")
    for c in cgs:
        if LOOP_GRAPH and (c["form"] != form or c["host_reads"] != reads
                           or c["flag_reads"]):
            raise AssertionError(f"{label}: a CG solve's record {c}, not a "
                                 f"{form} with {reads} reads")
    return [(r["live"], r["inner"], r["host_reads"]) for r in subs]


def phase_mdl_solve(dev, D0, S, lmbda):
    """CNS_ITERS outer iterations of each method pair in float32 on the
    card: ms an outer iteration, filters in the unit ball within
    UNIT_NORM, the x-step objective lower at the last outer iteration
    than at the first (for the pairs of MDL_RISE its least value), and
    the launches of ``mdl_launches``; the admm/cg pair's d-step on the
    graph route (``check_cg_loops``), then again declared eager, whose
    rows and D must equal the graph route's to the bit."""
    W = mdl_mask(S)
    out = {}
    for xm, dm in MDL_PAIRS + (("admm", "cg eager"),):
        label = f"{xm}/{dm}"
        eager = dm == "cg eager"
        dm = "cg" if eager else dm

        def make(n):
            d = _mdl(D0, S, W, lmbda, xm, dm, dev, n)
            if eager:
                d.dstep.problem = dataclasses.replace(d.dstep.problem,
                                                      route="eager")
            return d
        make(2).solve()
        d = make(CNS_ITERS)
        if xm == "pgm" and d.xstep._fused_solve is None:
            raise AssertionError(f"ConvBPDNMaskDictLearn ({label}): the "
                                 "FISTA x-step is not fused")
        with cg_record() as cgs, solve_record(d.dstep) as loops:
            wall, counts = _timed(d)
        rec = {}
        if dm == "cg":
            subs = check_cg_loops(f"ConvBPDNMaskDictLearn ({label})", cgs,
                                  loops, "eager" if eager else "graph")
            rec = {"d_step_solves": subs,
                   "cg_iterations": sum(n for _, n, _ in subs),
                   "cg_solves": [(c["iterations"], c["host_reads"])
                                 for c in cgs]}
        per = mdl_launches(xm, dm)
        expect_launches(f"ConvBPDNMaskDictLearn ({label})", counts,
                        **{k: v * CNS_ITERS for k, v in per.items()})
        its = d.getitstat()
        obj = its["XObjFun"]
        Dl = d.getdict().cpu().double()
        nrm = Dl.pow(2).sum(dim=(0, 1)).sqrt().numpy()
        if not (np.all(np.isfinite(obj)) and bool(torch.isfinite(Dl).all())
                and len(obj) == CNS_ITERS):
            raise AssertionError(f"ConvBPDNMaskDictLearn ({label}): not "
                                 "finite")
        if not nrm.max() <= 1.0 + UNIT_NORM:
            raise AssertionError(f"ConvBPDNMaskDictLearn ({label}): a "
                                 f"filter of norm {nrm.max()}")
        end = obj.min() if (xm, dm) in MDL_RISE else obj[-1]
        if not end < obj[0]:
            raise AssertionError(f"ConvBPDNMaskDictLearn ({label}): x-step "
                                 f"objective {obj[0]} -> {obj[-1]} (least "
                                 f"{obj.min()})")
        if eager:
            g = out["admm/cg"]
            bad = [n for n in its if not np.array_equal(
                np.asarray(its[n]), g["_rows"][n], equal_nan=True)]
            if bad or not np.array_equal(Dl.numpy(), g["_D"]) \
                    or counts != g["launches"] \
                    or rec["cg_iterations"] != g["cg_iterations"]:
                raise AssertionError(
                    f"ConvBPDNMaskDictLearn (admm/cg): the eager d-step "
                    f"parts from the graph route's in {bad}, D equal "
                    f"{np.array_equal(Dl.numpy(), g['_D'])}, launches "
                    f"{counts} against {g['launches']}, CG iterations "
                    f"{rec['cg_iterations']} against "
                    f"{g['cg_iterations']}")
            rec["rows_and_D_equal_graph"] = True
        out[label] = {"outer_iterations": CNS_ITERS, "wall_s": wall,
                      "ms_per_outer_iter": 1e3 * wall / CNS_ITERS, **rec,
                      "x_objective_first": float(obj[0]),
                      "x_objective_least": float(obj.min()),
                      "x_objective_least_at": int(np.argmin(obj)),
                      "x_objective": float(obj[-1]),
                      "d_dfid": float(its["DDFid"][-1]),
                      "max_filter_norm": float(nrm.max()),
                      "launches": counts}
        if label == "admm/cg":
            out[label]["_rows"] = {n: np.asarray(its[n]) for n in its}
            out[label]["_D"] = Dl.numpy()
    for rec in out.values():
        rec.pop("_rows", None)
        rec.pop("_D", None)
    return out


# ConvCnstrMOD(method="cg") at the consensus geometry: the coefficient
# maps' density, the ADMM iterations and tolerance, the CG tolerance (the
# model's default)
CCMOD_CG_DENSITY, CCMOD_CG_ITERS, CCMOD_CG_TOL = 0.05, 50, 1e-3


def ccmod_cg_model(dev, route, D0, S):
    """``ConvCnstrMOD(method="cg")`` in float32 on the consensus problem's
    S and D0, its coefficients drawn from ``default_rng(5)`` (a share
    CCMOD_CG_DENSITY of them non-zero), on ``route``."""
    g = np.random.default_rng(5)
    shape = S.shape[:2] + (1, S.shape[2], D0.shape[-1])
    Z = (g.standard_normal(shape) * (g.random(shape) < CCMOD_CG_DENSITY)
         ).astype(np.float32)
    b = tccmod.ConvCnstrMOD(Z, S, D0.shape, method="cg", D0=D0,
                            dtype=torch.float32, device=dev,
                            opt=tccmod.ConvCnstrMODBase.options(
                                max_iter=CCMOD_CG_ITERS,
                                rel_stop_tol=CCMOD_CG_TOL))
    if route == "eager":
        b.problem = dataclasses.replace(b.problem, route="eager")
    return b


def phase_ccmod_cg_solve(dev, D0, S):
    """``ConvCnstrMOD(method="cg")`` at the consensus geometry in float32,
    on the graph route (its ADMM iteration one captured graph, each CG
    solve a WHILE node in it) against the same problem declared eager (a
    CG graph of its own and one read a CG solve): rows and D equal to the
    bit, the same FFT launches and CG iterations, ``check_cg_loops``; ms
    an iteration of each (a second solve, the first capturing)."""
    out = {}
    for route in ("graph", "eager"):
        ccmod_cg_model(dev, route, D0, S).solve()
        b = ccmod_cg_model(dev, route, D0, S)
        with cg_record() as cgs:
            wall, counts = _timed(b)
        loops = [dict(device_loop.LAST)]
        its = b.getitstat()
        k = len(its)
        subs = check_cg_loops(f"ConvCnstrMOD cg ({route})", cgs, loops,
                              route)
        Dl = b.getdict().cpu().numpy()
        if not (np.all(np.isfinite(its._arr[:, 1:2])) and np.isfinite(
                Dl).all()):
            raise AssertionError(f"ConvCnstrMOD cg ({route}): not finite")
        out[route] = {"iterations": k, "wall_s": wall,
                      "ms_per_iter": 1e3 * wall / k,
                      "cg_iterations": subs[0][1],
                      "host_reads": subs[0][2],
                      "cg_solves": [(c["iterations"], c["host_reads"])
                                    for c in cgs],
                      "dfid": float(its.DFid[-1]), "launches": counts,
                      "_rows": its, "_D": Dl}
    g, e = out["graph"], out["eager"]
    _equal_rows("ConvCnstrMOD cg: graph against eager", g["_rows"],
                e["_rows"])
    if not np.array_equal(g["_D"], e["_D"]) or g["launches"] != \
            e["launches"] or g["cg_iterations"] != e["cg_iterations"]:
        raise AssertionError(
            f"ConvCnstrMOD cg: D equal {np.array_equal(g['_D'], e['_D'])}, "
            f"launches {g['launches']} against {e['launches']}, CG "
            f"iterations {g['cg_iterations']} against {e['cg_iterations']}")
    for rec in (g, e):
        del rec["_rows"], rec["_D"]
    return {"geometry": {"signals": S.shape[2], "side": S.shape[0],
                         "filters": D0.shape[-1]}, "dtype": "float32",
            "rows_and_D_equal": True, **out}


def online_samples():
    """Five images built like ``headline_problem``'s (seeds 0-4) and the
    masked form's mask, ``ams_problem``'s."""
    imgs = [headline_problem(seed)[1] for seed in range(ONLINE_SAMPLES)]
    W = ams_problem(imgs[0])[0]
    return imgs, W


def _online_run(d, imgs, W, masked):
    """Feed the samples; returns each x-step's iteration count."""
    iters = []
    for S in imgs:
        if masked:
            d.solve((S * W).astype(S.dtype), W=W)
        else:
            d.solve(S)
        iters.append(int(d.xstep.state.k))
    return iters


def phase_online_solve(dev, D, imgs, W):
    """Online CDL, plain and masked, over ONLINE_SAMPLES 512x512 samples
    at lmbda ONLINE_LMBDA with the default 50 x-step iterations, float32
    on the card: ms a sample; the plain form's x-step on the fused
    driver, ``csc_iter`` launched once an x-step iteration, the FFT
    kernels as the x-steps and the d-step make them (plain: k + 3 and
    k + 1 an x-step of k iterations, masked 3k + 1 and 3k, and the
    d-step 3 and 1); eta decays, filters of unit norm.  Then
    ONLINE_PARITY_SAMPLES samples of ONLINE_PARITY_ITERS x-step
    iterations in float64, card against CPU: every column (``XObjFun``
    among them) and the dictionary at ``mdl_parity``'s limits."""
    out = {}
    for masked in (False, True):
        cls = (tdl.OnlineConvBPDNMaskDictLearn if masked
               else tdl.OnlineConvBPDNDictLearn)
        label = cls.__name__
        warm = cls(D, ONLINE_LMBDA, device=dev, cbpdn_opt=(
            tcbpdn.ConvBPDNMaskDcpl if masked else ConvBPDN).options(
                max_iter=3))
        _online_run(warm, imgs[:1], W, masked)
        d = cls(D, ONLINE_LMBDA, device=dev)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        iters = _online_run(d, imgs, W, masked)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        k, n = sum(iters), len(iters)
        if masked:
            want = dict(rfft2_planar=3 * k + 4 * n,
                        irfft2_planar=3 * k + n)
        else:
            if d.xstep._fused_solve is not tfc.cbpdn_solve:
                raise AssertionError(f"{label}: the x-step is not fused")
            want = dict(csc_iter=k, rfft2_planar=k + 6 * n,
                        irfft2_planar=k + 2 * n)
        expect_launches(label, counts, **want)
        its = d.getitstat()
        eta = its["Eta"]
        Dl = d.getdict().cpu().double()
        nrm = Dl.pow(2).sum(dim=(0, 1)).sqrt().numpy()
        if not (np.all(np.diff(eta) < 0) and np.all(np.isfinite(
                its["XObjFun"])) and np.abs(nrm - 1.0).max() <= UNIT_NORM):
            raise AssertionError(f"{label}: eta {eta}, filter norms "
                                 f"{nrm.min()}..{nrm.max()}")
        errs = learner_parity(
            f"{label} float64", dev,
            lambda dv: cls(D, ONLINE_LMBDA, dtype=torch.float64, device=dv,
                           cbpdn_opt=(tcbpdn.ConvBPDNMaskDcpl if masked
                                      else ConvBPDN).options(
                               max_iter=ONLINE_PARITY_ITERS)),
            lambda m: _online_run(m, imgs[:ONLINE_PARITY_SAMPLES], W,
                                  masked))
        out[label] = {"samples": n, "xstep_iterations": iters,
                      "wall_s": wall, "ms_per_sample": 1e3 * wall / n,
                      "ms_per_xstep_iter": 1e3 * wall / k,
                      "x_objective": its["XObjFun"].tolist(),
                      "eta": eta.tolist(), "launches": counts,
                      "parity": {"samples": ONLINE_PARITY_SAMPLES,
                                 "xstep_iterations": ONLINE_PARITY_ITERS,
                                 "rel_err": errs}}
    return out


def patch_problem(seed=0):
    """Every DDL_PATCH x DDL_PATCH patch at stride 1 of a DDL_IMG square
    image (smoothed noise with noise on top, from the seed), zero-mean
    per patch, as (64, 62001) columns, and an initial dictionary of
    DDL_ATOMS normal columns; the weight of the weighted learner
    uniform on [0.5, 1.5]."""
    from scipy.ndimage import gaussian_filter
    from numpy.lib.stride_tricks import sliding_window_view
    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.standard_normal((DDL_IMG, DDL_IMG)), 2.0)
    img = 5.0 * img + 0.1 * rng.standard_normal(img.shape)
    P = sliding_window_view(img, (DDL_PATCH, DDL_PATCH))
    S = P.reshape(-1, DDL_PATCH * DDL_PATCH).T
    S = (S - S.mean(axis=0, keepdims=True)).astype(np.float32)
    D0 = rng.standard_normal((DDL_PATCH ** 2, DDL_ATOMS)).astype(np.float32)
    Wt = rng.uniform(0.5, 1.5, S.shape).astype(np.float32)
    return S, D0, Wt


def dense_fista_models():
    """name -> maker(device, dtype, opt keywords) of the dense FISTA
    models and the ADMM and FISTA CnstrMOD on BASELINE configuration 1's
    problem: BPDN (K = 1 and 256) and WeightedBPDN (K = 256) at L 1.01
    times D's largest squared singular value (the default L = 500 is
    below it: 2.0e3 for this D), CnstrMOD learning D back from x0 and S
    (K = 256) from a normalised normal D0."""
    D1, S1, _ = bpdn_problem(1)
    D, S, x0 = bpdn_problem(BPDN_K)
    L = 1.01 * float(np.linalg.norm(D.astype(np.float64), 2)) ** 2
    Wt = np.random.default_rng(5).uniform(0.5, 1.5, S.shape).astype(
        np.float32)
    D0 = np.random.default_rng(6).standard_normal(D.shape)
    D0 = (D0 / np.linalg.norm(D0, axis=0)).astype(np.float32)

    def bp(cls, Dm, Sm, **kw):
        return lambda d, dt, o: cls(Dm, Sm, BPDN_LMBDA, device=d, dtype=dt,
                                    opt=cls.options(L=L, **o), **kw)

    def cm(cls, **kw):
        return lambda d, dt, o: cls(x0, S, D0=D0, device=d, dtype=dt,
                                    opt=cls.options(**o), **kw)
    return {"pgm.BPDN K=1": bp(tpgm.BPDN, D1, S1),
            f"pgm.BPDN K={BPDN_K}": bp(tpgm.BPDN, D, S),
            f"pgm.WeightedBPDN K={BPDN_K}": bp(tpgm.WeightedBPDN, D, S,
                                               W=Wt),
            "cmod.CnstrMOD": cm(tcmod.CnstrMOD),
            "pgm.CnstrMOD": cm(tpgm.CnstrMOD)}


def _ddl(cls, S, D0, Wt, dev, max_iter, dtype=torch.float32):
    kw = {"W": Wt} if cls is tdl.WeightedBPDNDictLearn else {}
    return cls(D0, S, DDL_LMBDA, max_iter=max_iter, dtype=dtype,
               device=dev, **kw)


DDL_CLASSES = (tdl.BPDNDictLearn, tdl.WeightedBPDNDictLearn)


def phase_dense_dl_parity(dev):
    """The dense FISTA models and both CnstrMODs, 10 iterations in
    float64, card against CPU; the two learners, DDL_PARITY_ITERS outer
    iterations on the patch problem."""
    errs = {}
    for name, make in dense_fista_models().items():
        errs[name] = f64_parity(name, dev, lambda d: make(
            d, torch.float64, dict(max_iter=PARITY_ITERS,
                                   rel_stop_tol=0.0)))
    S, D0, Wt = patch_problem()
    for cls in DDL_CLASSES:
        errs[cls.__name__] = learner_parity(
            cls.__name__, dev, lambda d: _ddl(cls, S, D0, Wt, d,
                                              DDL_PARITY_ITERS,
                                              torch.float64))
    return {"iterations": PARITY_ITERS,
            "outer_iterations": DDL_PARITY_ITERS, "dtype": "float64",
            "rel_err": errs, "tolerance": F64_PARITY}


def phase_dense_dl_solve(dev):
    """In float32 on the card: the dense FISTA models and both CnstrMODs
    to 1e-3 (500 iterations at most; iterations, objective, ms an
    iteration over three solves), and each learner DDL_ITERS outer
    iterations on the patch problem (ms an outer iteration, atoms of
    unit norm within UNIT_NORM); no kernel launched."""
    out = {}
    for name, make in dense_fista_models().items():
        o = dict(max_iter=BPDN_ITERS, rel_stop_tol=DENSE_TOL)
        make(dev, torch.float32, dict(max_iter=3)).solve()
        b = make(dev, torch.float32, o)
        wall, counts = _timed(b)
        its = b.getitstat()
        k = len(its)
        expect_launches(name, counts)
        X = b.state.X
        if not (np.all(np.isfinite(its._arr[:, 1:3]))
                and bool(torch.isfinite(X).all())):
            raise AssertionError(f"{name}: not finite")
        rec = {"iterations": k, "converged": k < BPDN_ITERS,
               "final_objective": float(its._arr[-1, 1]),
               "objective_name": its._names[1], "wall_s": wall,
               "ms_per_iter": 1e3 * wall / k, "launches": counts}
        rec["ms_per_iter_repeats"] = _repeat_ms(
            lambda: make(dev, torch.float32, o))
        if "CnstrMOD" in name:
            nrm = b.getdict().double().pow(2).sum(dim=0).sqrt()
            rec["max_norm_err"] = float((nrm - 1.0).abs().max())
        out[name] = rec
    S, D0, Wt = patch_problem()
    for cls in DDL_CLASSES:
        _ddl(cls, S, D0, Wt, dev, 2).solve()
        d = _ddl(cls, S, D0, Wt, dev, DDL_ITERS)
        wall, counts = _timed(d)
        expect_launches(cls.__name__, counts)
        its = d.getitstat()
        Dl = d.getdict().double()
        nrm = Dl.pow(2).sum(dim=0).sqrt().cpu().numpy()
        obj = its["XObjFun"]
        if not (np.all(np.isfinite(obj)) and bool(torch.isfinite(Dl).all())
                and np.abs(nrm - 1.0).max() <= UNIT_NORM):
            raise AssertionError(f"{cls.__name__}: atom norms "
                                 f"{nrm.min()}..{nrm.max()}, or not finite")
        out[cls.__name__] = {
            "outer_iterations": DDL_ITERS, "signals": S.shape[1],
            "wall_s": wall, "ms_per_outer_iter": 1e3 * wall / DDL_ITERS,
            "x_objective_first": float(obj[0]),
            "x_objective": float(obj[-1]),
            "d_dfid": float(its["DDFid"][-1]),
            "max_norm_err": float(np.abs(nrm - 1.0).max()),
            "launches": counts}
    return out


# ---------------------------------------------------------------------------
# The rest of the CSC models: ConvBPDNJoint, ConvBPDNProjL1,
# MultiDictConvBPDN, ConvBPDNInhib, CSC with TV, product-dictionary CSC,
# Plug-and-Play and the l1 spline, each problem of its example at
# 512x512; the float64 card-against-CPU checks on a REST_PARITY_N crop

REST_FAMILIES = ("csc_variants", "inhib", "csctv", "pdcsc", "ppp", "spline")
# the float64 card-against-CPU checks' side and iterations: at 512x512,
# or over 10 iterations, their CPU runs put the script past its time
# (PERF.md, 4; 128x128 since complex Robust PCA's phase came, where
# 256x256 took 51 s of a slow run)
REST_PARITY_N, REST_PARITY_ITERS = 128, 2
REST_REPEAT_ITERS = 30  # iterations of the two repeat solves that time ms
JOINT_MU = 0.02         # examples/csc_joint_color.py
PROJL1_DENSITY, PROJL1_NOISE, PROJL1_FRAC = 24 / (64 * 64 * 8), 0.01, 0.9
PROJL1_TOL = 1e-4       # examples/csc_constrained.py
INHIB_MU, INHIB_WHN, INHIB_GROUP = 0.5, 8, 8    # examples/csc_inhibition.py
INHIB_ITERS = 100       # a fixed count, as the example (the residuals
#                         stall: tests/test_torch_cbpdnin.py)
TV_MU = 0.02            # examples/csc_tv.py
PD_LMBDA, PD_JOINT_MU = 0.05, 0.02              # csc_product_dict.py
PDG_LMBDA, PDG_MU, PDG_MU2, PDG_RHO = 1.4, 9.0, 2e-2, 10.0
PDG_ITERS, PDG_FRC = 60, 0.2    # csc_impulse_pd_dct.py (a fixed count:
#                                 the dual residual stalls by design)
PPP_RHO, PPP_LAM, PPP_ITERS = 0.05, 0.02, 100   # ppp_denoise.py
PPPPGM_L, PPPPGM_TOL = 1.0, 1e-5                # ppp_pgm.py
SPLINE_LMBDA, SPLINE_ITERS, SPLINE_TOL = 0.1, 250, 5e-4
SPLINE_OUTLIERS = 20 / 64 ** 2  # misc_spline_demosaic.py's 20 of 64x64
# the reconstruction error below which the examples' CSC solves pass
# (examples/csc_multidict.py, csc_product_dict.py); inhibition is held
# to the same
REC_ERR = 0.8


def _box_blur(a, k, n):
    """``a``'s two leading axes circularly convolved with the k x k box."""
    h = np.ones((k, k)) / k ** 2
    hf = np.fft.rfft2(h, s=(n, n))
    hf = hf.reshape(hf.shape + (1,) * (a.ndim - 2))
    return np.fft.irfft2(np.fft.rfft2(a, axes=(0, 1)) * hf, s=(n, n),
                         axes=(0, 1))


def multidict_dict(D):
    """MultiDictConvBPDN's two dictionaries, the headline's filters and
    their 3x3 box blur, stacked on the channel axis as the model stacks
    them: (ND, ND, 2, M)."""
    return np.stack([D, _box_blur(D, 3, ND).astype(np.float32)], axis=2)


def _unit(img):
    return ((img - img.min()) / np.ptp(img)).astype(np.float32)


def _rec_err(rec, ref):
    return float(np.linalg.norm(rec - ref) / np.linalg.norm(ref))


def _csc_sum(D, X, n):
    """sum_m d_m * x_m, circular, for (ND, ND, M) filters and (n, n, M)
    maps."""
    return np.fft.irfft2((np.fft.rfft2(X, axes=(0, 1))
                          * np.fft.rfft2(D, s=(n, n), axes=(0, 1))).sum(-1),
                         s=(n, n))


def ppp_problem(n):
    """``tv_example``'s blurred square at n x n (the 5x5 box, noise 0.02)
    as Plug-and-Play problems, the data term by the DFT and a Tikhonov
    gradient smoother as the prior, written with the port's ops.fft:
    the clean and noisy images, the smoother's DFT-domain weight ``G``
    and, for each model, ``make(device, dtype, max_iter, tol)`` (PPP's
    also takes another ``prior``)."""
    from sporco_tpu_torch.models import ppp
    img, h, noisy, _ = tv_example(n)
    gr = np.zeros((n, n))
    gr[0, 0], gr[1, 0] = -1, 1
    gc = np.zeros((n, n))
    gc[0, 0], gc[0, 1] = -1, 1
    consts = {"A": np.fft.rfft2(h, s=(n, n)), "F": np.fft.rfft2(noisy),
              "G": np.abs(np.fft.rfft2(gr)) ** 2
              + np.abs(np.fft.rfft2(gc)) ** 2}

    def fns(d, dt):
        cdt = tsf.complex_dtype(tsf.torch_dtype(dt))
        A, F = (torch.as_tensor(consts[k]).to(d, cdt) for k in "AF")
        G = torch.as_tensor(consts["G"]).to(d, tsf.torch_dtype(dt))

        def f(x):
            return 0.5 * (abs(A * tsf.rfftn(x) - F) ** 2).sum() / x.numel()

        def proxf(x, rho):
            return tsf.irfftn((A.conj() * F + rho * tsf.rfftn(x))
                              / (abs(A) ** 2 + rho), (n, n))

        def prior(x, rho):
            return tsf.irfftn(tsf.rfftn(x) / (1.0 + (PPP_LAM / rho) * G),
                              (n, n))

        def gradf(x):
            return tsf.irfftn(A.conj() * (A * tsf.rfftn(x) - F), (n, n))
        return f, proxf, prior, gradf

    def opt(cls, it, tol, **kw):
        return cls.options(max_iter=it, rel_stop_tol=tol, **kw)

    def make_ppp(d, dt, it, tol, prior=None):
        f, proxf, tik, _ = fns(d, dt)
        return ppp.PPP((n, n), f, proxf, prior or tik, dtype=dt, device=d,
                       opt=opt(ppp.PPP, it, tol, rho=PPP_RHO))

    def make_pppc(d, dt, it, tol):
        _, proxf, prior, _ = fns(d, dt)
        return ppp.PPPConsensus((n, n), [proxf, prior], dtype=dt, device=d,
                                opt=opt(ppp.PPPConsensus, it, tol,
                                        rho=PPP_RHO))

    def make_pppg(d, dt, it, tol):
        f, _, prior, gradf = fns(d, dt)
        return ppp.PPPPGM((n, n), f, gradf, prior, dtype=dt, device=d,
                          opt=opt(ppp.PPPPGM, it, tol, L=PPPPGM_L))
    return {"img": img, "noisy": noisy, "G": consts["G"], "PPP": make_ppp,
            "PPPConsensus": make_pppc, "PPPPGM": make_pppg}


_REST = {}


def rest_problems(n):
    """The problems of this slice at n x n, from seeds: name -> (family,
    ``make(device, dtype, max_iter, tol)``, the launches a solve of k
    iterations must make, the quality gate ``gate(model) -> dict`` (an
    AssertionError where it fails), the iterations and tolerance of a
    whole solve).  Each family's problem is its example's, with the
    headline's filters (64 of 8x8) and images."""
    if (n, M) in _REST:
        return _REST[(n, M)]
    from sporco_tpu_torch.models import cbpdnin, cbpdntv, pdcsc
    from sporco_tpu_torch.models import spline
    from sporco_tpu_torch.ops import linalg as tla
    from sporco_tpu_torch.utils import signal as tsig
    D, S, _ = headline_problem(n=n)
    _, S3 = colour_problem(n=n)
    rng = np.random.default_rng(7)
    out = {}

    def opt(cls, max_iter, tol, **kw):
        return cls.options(max_iter=max_iter, rel_stop_tol=tol, **kw)

    def none(b):
        return {}

    def psnr_gate(label, ref, noisy, rec):
        got, base = psnr(ref, rec), psnr(ref, noisy)
        if not got > base:
            raise AssertionError(f"{label}: PSNR {got} not above the "
                                 f"input's {base}")
        return {"psnr": got, "psnr_input": base}

    # -- csc_variants
    S3n = S3 + 0.1 * rng.standard_normal(S3.shape).astype(np.float32)

    def joint_gate(b):
        return psnr_gate("ConvBPDNJoint", S3, S3n,
                         b.reconstruct().cpu().numpy())
    out["ConvBPDNJoint"] = ("csc_variants", lambda d, dt, it, tol:
                            tcbpdn.ConvBPDNJoint(
                                D, S3n, LMBDA, JOINT_MU, dimK=0, dtype=dt,
                                device=d, opt=opt(tcbpdn.ConvBPDNJoint, it,
                                                  tol)),
                            lambda k: {"rfft2_planar": k + 2,
                                       "irfft2_planar": k}, joint_gate,
                            MAX_ITER, REL_TOL)
    X0 = np.zeros((n, n, M))
    nnz = max(1, int(round(PROJL1_DENSITY * X0.size)))
    X0.ravel()[rng.choice(X0.size, nnz, replace=False)] = rng.uniform(
        1.0, 2.0, nnz)
    Sp = (_csc_sum(D, X0, n) + PROJL1_NOISE * rng.standard_normal(
        (n, n))).astype(np.float32)
    gamma = PROJL1_FRAC * float(np.abs(X0).sum())

    def projl1_gate(b):
        l1 = float(b.getmin().abs().sum())
        if not l1 <= gamma * (1 + 1e-5):
            raise AssertionError(f"ConvBPDNProjL1: ||Y||_1 {l1} over "
                                 f"gamma {gamma}")
        return {"l1": l1, "gamma": gamma}
    out["ConvBPDNProjL1"] = ("csc_variants", lambda d, dt, it, tol:
                             tcbpdn.ConvBPDNProjL1(
                                 D, Sp, gamma, dtype=dt, device=d,
                                 opt=opt(tcbpdn.ConvBPDNProjL1, it, tol)),
                             lambda k: {"rfft2_planar": k + 2,
                                        "irfft2_planar": k}, projl1_gate,
                             MAX_ITER, PROJL1_TOL)
    # the second view: the image and the filters under a 3x3 box blur
    Dmd = multidict_dict(D)
    S1 = _box_blur(S, 3, n).astype(np.float32)

    def multidict_gate(b):
        errs = [_rec_err(b.reconstruct(k).cpu().numpy().squeeze(), ref)
                for k, ref in enumerate((S, S1))]
        if not max(errs) < REC_ERR:
            raise AssertionError(f"MultiDictConvBPDN: errors {errs}")
        return {"rel_err_views": errs}
    out["MultiDictConvBPDN"] = ("csc_variants", lambda d, dt, it, tol:
                                tcbpdn.MultiDictConvBPDN(
                                    ConvBPDN, [Dmd[:, :, 0], Dmd[:, :, 1]],
                                    [S, S1], LMBDA, dtype=dt, device=d,
                                    opt=opt(ConvBPDN, it, tol)),
                                lambda k: {"csc_iter": k,
                                           "rfft2_planar": k + 3,
                                           "irfft2_planar": k + 1},
                                multidict_gate, MAX_ITER, REL_TOL)
    # -- inhib: 8 groups of 8 filters, lateral inhibition; the example
    # sets it beside ConvBPDN of the same lambda and iterations
    Wg = np.kron(np.eye(M // INHIB_GROUP), np.ones((1, INHIB_GROUP)))

    def inhib_gate(b):
        X = b.getmin()
        err = _rec_err(_csc_sum(D, X.cpu().numpy().reshape(n, n, M), n), S)
        plain = ConvBPDN(D, S, LMBDA, device=X.device, opt=opt(
            ConvBPDN, INHIB_ITERS, 0.0))
        plain.solve()
        nz = int((X.abs() > 1e-3).sum())
        nz_plain = int((plain.getmin().abs() > 1e-3).sum())
        if not (err < REC_ERR and nz < nz_plain):
            raise AssertionError(
                f"ConvBPDNInhib: error {err}, {nz} active coefficients "
                f"(ConvBPDN {nz_plain})")
        return {"rel_err": err, "nonzeros": nz,
                "nonzeros_convbpdn": nz_plain}
    out["ConvBPDNInhib"] = ("inhib", lambda d, dt, it, tol:
                            cbpdnin.ConvBPDNInhib(
                                D, S, Wg=Wg, Whn=INHIB_WHN, lmbda=LMBDA,
                                mu=INHIB_MU, dtype=dt, device=d,
                                opt=opt(cbpdnin.ConvBPDNInhib, it, tol)),
                            lambda k: {"rfft2_planar": 2 * k + 2,
                                       "irfft2_planar": 2 * k}, inhib_gate,
                            INHIB_ITERS, 0.0)
    # -- csctv (the example prints its solves and checks nothing)
    for name in ("ConvBPDNScalarTV", "ConvBPDNVectorTV", "ConvBPDNRecTV"):
        cls = getattr(cbpdntv, name)
        fwd = 4 if name == "ConvBPDNRecTV" else 3
        out[name] = ("csctv", lambda d, dt, it, tol, cls=cls: cls(
            D, S, LMBDA, TV_MU, dtype=dt, device=d, opt=opt(cls, it, tol)),
            lambda k, fwd=fwd: {"rfft2_planar": fwd * k + 3,
                                "irfft2_planar": 4 * k}, none, MAX_ITER,
            REL_TOL)
    # -- pdcsc: the colour image in [0, 1]; B from the PCA of its pixels
    # (or the channel DCT); the plain forms on its high-pass part, the
    # l1 fidelity forms on its salt-and-pepper corruption with an impulse
    # filter carrying the smooth part
    imc = _unit(S3)
    pix = torch.as_tensor(imc.reshape(-1, 3).T.astype(np.float64))
    Bpca = tla.pca(pix)[0].numpy().astype(np.float32)
    # the orthonormal DCT-II basis of the three channels, atoms in columns
    Bdct = tsf._dct_matrix(3, torch.float32, "cpu").T.numpy()
    _, sh = tsig.tikhonov_filter(imc.transpose(2, 0, 1), 5.0)
    sh = sh.numpy().transpose(1, 2, 0)
    spn = tsig.spnoise(imc, PDG_FRC, u=rng.random(imc.shape)).numpy()
    imp = np.zeros((ND, ND, 1), np.float32)
    imp[0, 0, 0] = 1.0
    Di = np.concatenate([D, imp], axis=-1)
    wl1 = np.ones((1, 1, 1, 1, M + 1), np.float32)
    wl1[..., -1] = 0.0
    wgrd = np.zeros(M + 1, np.float32)
    wgrd[-1] = 1.0

    def pd_rec(b):
        return b.reconstruct()[0, :, 0].cpu().numpy().transpose(1, 2, 0)

    def pd_gate(b):
        err = _rec_err(pd_rec(b), sh)
        if not err < REC_ERR:
            raise AssertionError(f"product dictionary: error {err}")
        return {"rel_err": err}

    def pdg_gate(b):
        return psnr_gate("product dictionary l1", imc, spn, pd_rec(b))
    for name, B, kw in (("ConvProdDictBPDN", Bpca, {}),
                        ("ConvProdDictBPDNJoint", Bpca,
                         {"mu": PD_JOINT_MU})):
        cls = getattr(pdcsc, name)
        out[name] = ("pdcsc", lambda d, dt, it, tol, cls=cls, B=B, kw=kw:
                     cls(D, B, sh, PD_LMBDA, dimK=0, dtype=dt, device=d,
                         opt=opt(cls, it, tol), **kw),
                     lambda k: {"rfft2_planar": k + 2, "irfft2_planar": k},
                     pd_gate, MAX_ITER, REL_TOL)
    for name, B, kw in (("ConvProdDictL1L1Grd", Bdct, {}),
                        ("ConvProdDictL1L1GrdJoint", Bpca,
                         {"mu2": PDG_MU2})):
        cls = getattr(pdcsc, name)
        out[name] = ("pdcsc", lambda d, dt, it, tol, cls=cls, B=B, kw=kw:
                     cls(Di, B, spn, PDG_LMBDA, mu=PDG_MU, dimK=0, wl1=wl1,
                         wgrd=wgrd, dtype=dt, device=d,
                         opt=opt(cls, it, tol, rho=PDG_RHO), **kw),
                     lambda k: {"rfft2_planar": 3 * k + 2,
                                "irfft2_planar": 3 * k},
                     pdg_gate, PDG_ITERS, 0.0)
    # -- ppp
    pp = ppp_problem(n)

    def ppp_gate(b):
        return psnr_gate("PPP", pp["img"], pp["noisy"],
                         b.getmin().cpu().numpy())
    for name, want, tol in (
            ("PPP", lambda k: {"rfft2_planar": 3 * k,
                               "irfft2_planar": 2 * k}, REL_TOL),
            ("PPPConsensus", lambda k: {"rfft2_planar": 2 * k,
                                        "irfft2_planar": 2 * k}, REL_TOL),
            ("PPPPGM", lambda k: {"rfft2_planar": 3 * k,
                                  "irfft2_planar": 2 * k}, PPPPGM_TOL)):
        out[name] = ("ppp", pp[name], want, ppp_gate, PPP_ITERS, tol)
    # -- spline: cos x cos y with outliers, DFidWeight 0 on them
    x = np.cos(np.linspace(0, np.pi, n))[np.newaxis, :]
    U = x * x.T
    V = rng.standard_normal((n, n))
    L = max(1, int(round(SPLINE_OUTLIERS * V.size)))
    V[np.abs(V) < np.sort(np.abs(V).ravel())[V.size - L]] = 0
    Ssp = (U + V).astype(np.float32)
    Wdf = (V == 0).astype(np.float32)

    def spline_gate(b):
        fit = float(np.mean((b.getmin().cpu().numpy() - U) ** 2))
        base = float(np.mean((Ssp - U) ** 2))
        if not fit < base:
            raise AssertionError(f"SplineL1: fit mse {fit} not below the "
                                 f"input's {base}")
        return {"fit_mse": fit, "input_mse": base}
    out["SplineL1"] = ("spline", lambda d, dt, it, tol: spline.SplineL1(
        Ssp, SPLINE_LMBDA, Wdf=Wdf, dtype=dt, device=d,
        opt=opt(spline.SplineL1, it, tol)), lambda k: {}, spline_gate,
        SPLINE_ITERS, SPLINE_TOL)
    _REST[(n, M)] = out
    return out


REST_PROFILED = ("ConvBPDNJoint", "ConvBPDNScalarTV", "ConvProdDictL1L1Grd",
                 "PPP")


def rest_profiles(dev, run_phase):
    """``--profile``'s phases of the last slice: a float32 solve of
    REST_REPEAT_ITERS iterations of each model of REST_PROFILED."""
    probs = rest_problems(N)
    for name in REST_PROFILED:
        make = probs[name][1]
        run_phase(f"{name}_profile", lambda: phase_profile(
            dev, lambda: make(dev, "float32", REST_REPEAT_ITERS, 0.0)))


def _model(b):
    """The model a wrapper holds (MultiDictConvBPDN's ConvBPDN)."""
    return getattr(b, "cbpdn", b)


def multidict_f32_parity(dev, make):
    """MultiDictConvBPDN in float32, 10 iterations on the fused driver:
    ``csc_iter`` at Cd = 2 on the card against its plain version on the
    CPU, with ``clr_parity``'s tolerances."""
    label = "MultiDictConvBPDN float32"
    k = PARITY_ITERS
    runs = []
    for d in (dev, "cpu"):
        b = make(d, "float32", k, 0.0)
        if d is dev:
            counts = _timed(b)[1]
            expect_launches(label, counts, csc_iter=k, rfft2_planar=k + 3,
                            irfft2_planar=k + 1)
        else:
            b.solve()
        m = _model(b)
        runs.append((b.getitstat(), {"Y": m.state.Y.cpu().numpy(),
                                     "X": m.state.X.cpu().numpy()}))
    return compare_runs(label, runs, ("ObjFun", "DFid", "RegL1", "Rho",
                                      "PrimalRsdl", "DualRsdl"), PARITY)


def phase_rest_parity(dev, family):
    """Each model of ``family``, REST_PARITY_ITERS iterations in float64
    on the REST_PARITY_N crop, card against CPU (rows 1e-6; X, Y and every
    block within 1e-8 of their scale); for ``csc_variants`` also
    MultiDictConvBPDN's fused float32 solve at N x N through ``csc_iter``
    (``multidict_f32_parity``)."""
    errs = {}
    for name, (fam, make, *_rest) in rest_problems(REST_PARITY_N).items():
        if fam != family:
            continue
        errs[name] = f64_parity(name, dev, lambda d: _model(make(
            d, "float64", REST_PARITY_ITERS, 0.0)), iters=REST_PARITY_ITERS)
    out = {"iterations": REST_PARITY_ITERS, "dtype": "float64",
           "side": REST_PARITY_N, "rel_err": errs, "tolerance": F64_PARITY}
    if family == "csc_variants":
        out["multidict_float32"] = {
            "iterations": PARITY_ITERS, "side": N, "tolerance": PARITY,
            "rel_err": multidict_f32_parity(
                dev, rest_problems(N)["MultiDictConvBPDN"][1])}
    return out


def _rest_record(b, wall, counts, max_iter):
    its = b.getitstat()
    k = len(its)
    names = its._names
    arr = its._arr
    nobj = len(_model(b).STAT_NAMES)
    cols = [i for i in range(1, 1 + nobj) if names[i] != "XSlvRelRes"]
    if not (np.all(np.isfinite(arr[:, cols]))
            and all(bool(torch.isfinite(v).all()) for v in _tree_leaves(
                _model(b).state.X, _model(b).state.Y))):
        raise AssertionError(f"{type(b).__name__}: not finite")
    loop = generic_loop(type(b).__name__, b, k)
    return {"iterations": k, "converged": k < max_iter,
            "final_objective": float(arr[-1, 1]),
            "objective_name": names[1], "wall_s": wall,
            "ms_per_iter": 1e3 * wall / k, "launches": counts,
            "host_reads": loop["host_reads"], "route": loop["route"],
            "device_loop": loop}


def phase_rest_solve(dev, family):
    """Each model of ``family`` at N x N in float32 to its example's
    tolerance (or a fixed count): iterations, objective, ms an iteration
    (this solve's and two more of REST_REPEAT_ITERS iterations each), the
    launches predicted from the code (``rest_problems``) and the quality
    gate; ``ppp`` also runs ``host_prior`` once."""
    out = {}
    for name, (fam, make, want, gate, max_iter, tol) in rest_problems(
            N).items():
        if fam != family:
            continue
        make(dev, "float32", 3, 0.0).solve()
        b = make(dev, "float32", max_iter, tol)
        wall, counts = _timed(b)
        rec = _rest_record(b, wall, counts, max_iter)
        expect_launches(name, counts, **want(rec["iterations"]))
        reps = []
        for _ in range(2):
            r = make(dev, "float32", REST_REPEAT_ITERS, 0.0)
            w, _ = _timed(r)
            reps.append(1e3 * w / len(r.getitstat()))
        rec["ms_per_iter_repeats"] = reps
        rec["repeat_iterations"] = REST_REPEAT_ITERS
        rec.update(gate(b))
        out[name] = rec
    if family == "ppp":
        out["host_prior"] = _host_prior_run(dev, ppp_problem(N))
    return out


def _host_prior_run(dev, pp):
    """PPP with its prior as a numpy function through ``host_prior`` (each
    call a round trip through the host: the same Tikhonov smoother by
    ``numpy.fft`` in float64), 10 iterations, against the prior on the
    card: X within 1e-4 of its scale; the transforms left on the card are
    the data prox's and f's (2 forward, 1 inverse an iteration)."""
    from sporco_tpu_torch.models import ppp
    k = PARITY_ITERS
    b = pp["PPP"](dev, "float32", k, 0.0)
    b.solve()

    def numpy_prior(x):
        xf = np.fft.rfft2(x) / (1.0 + (PPP_LAM / PPP_RHO) * pp["G"])
        return np.fft.irfft2(xf, s=x.shape).astype(x.dtype)
    h = pp["PPP"](dev, "float32", k, 0.0, prior=ppp.host_prior(numpy_prior))
    wall, counts = _timed(h)
    expect_launches("host_prior", counts, rfft2_planar=2 * k,
                    irfft2_planar=k)
    Xd, Xh = b.getmin(), h.getmin()
    err = float((Xd - Xh).abs().max() / Xd.abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"host_prior: X differs by {err:.3e}")
    return {"iterations": k, "rel_err_vs_device_prior": err,
            "ms_per_iter": 1e3 * wall / k, "launches": counts}


def phase_profile(dev, make_model):
    """A solve under ``torch.profiler``: device busy time (the sum of
    every kernel's and copy's time on the card) against the solve's wall
    time, and the device time by kernel.  The profiler's own host
    overhead lengthens the wall time, so the idle share is an upper
    bound."""
    from torch.profiler import ProfilerActivity, profile as tprof
    b = make_model()
    torch.cuda.synchronize()
    device_loop.LAST.clear()
    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        b.solve()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # device-side entries only (kernels, copies): an operator's own row
    # repeats the device time of the kernels it launched
    on_dev = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    top = sorted(on_dev, key=dev_us, reverse=True)[:16]
    k = b.j if hasattr(b, "j") else int(b.state.k)
    # the device loop's host reads
    loop = dict(device_loop.LAST) if device_loop.LAST.get(
        "live") == k else {}
    return {"iterations": k, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "device_ms_per_iter": busy_ms / k,
            "wall_ms_per_iter": wall_ms / k,
            "host_reads": loop.get("host_reads"),
            "top": [{"name": e.key[:70], "device_ms": dev_us(e) / 1e3,
                     "count": e.count} for e in top]}


# ---------------------------------------------------------------------------
# parallel/ on torch.distributed and ParConvBPDN: every distributed path
# at world size 1 over NCCL (one card), in one process group

PAR_NGRP = 16           # ParConvBPDN's filter groups (its default)
PAR_MAX_ITER = 1000     # no AutoRho: the masked solve needs more than 500
PAR_MASK_MISSING, PAR_MASK_LMBDA = 0.3, 2e-2    # examples/csc_parallel.py
PAR_MESH_ITERS = 10     # the mesh= model against mesh=None, float32
PAR_MESH_ROWS = 1e-5
CNS_SHARDED_ITERS = 10  # the world-size-1 sharded consensus against the
CNS_SHARDED_D = 1e-5    # unsharded loop: D of its scale, float32
SPATIAL_X = 2e-4        # the row-sharded TV deconvolution's X of scale
SPATIAL_ROWS = 10       # cbpdn_nsharded's first rows held at PARITY
GRID_FN_MIN = (0.3, 0.0)


@contextlib.contextmanager
def dist_world(dev):
    """A world of one rank for the distributed phases, initialised in
    this process (``tcp://127.0.0.1`` on a free port) and destroyed
    after: NCCL on the card, with no fallback; gloo only where ``dev`` is
    the CPU (``tools/chip_smoke_cpu.py``).  Yields its 1 x 1 mesh."""
    import socket
    import torch.distributed as dist
    from sporco_tpu_torch.parallel import launch
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    cpu = torch.device(dev).type == "cpu"
    launch.initialize(f"tcp://127.0.0.1:{port}", 1, 0,
                      device="cpu" if cpu else None,
                      local_rank=None if cpu else 0)
    try:
        want = "gloo" if cpu else "nccl"
        if dist.get_backend() != want:
            raise AssertionError(f"process group on {dist.get_backend()}, "
                                 f"not {want}")
        yield launch.global_mesh()
    finally:
        dist.destroy_process_group()


def par_problems():
    """name -> (D, S, W, lmbda, the clean image): ParConvBPDN on the
    headline, and ``examples/csc_parallel.py``'s masked problem at N x N
    (its smooth image through PAR_MASK_MISSING of the pixels, at its
    lmbda) with the data pack's 64 learned 8x8 filters (the example takes
    16 of the pack's 32: the headline's random filters cannot inpaint
    its smoothed noise)."""
    from sporco_tpu_torch.utils.util import convdicts
    D, S, lmbda = headline_problem()
    x = np.linspace(-1, 1, N, dtype=np.float32)
    img = (0.5 + 0.45 * np.sin(4 * np.pi * np.outer(x, x))).astype(
        np.float32)
    W = (np.random.default_rng(12345).random(img.shape)
         >= PAR_MASK_MISSING).astype(np.float32)
    Dp = convdicts()["G:8x8x64"][..., :M].astype(np.float32)
    return {"headline": (D, S, None, lmbda, S),
            "masked": (Dp, W * img, W, PAR_MASK_LMBDA, img)}


def _par(D, S, W, lmbda, dev, max_iter, rel_stop_tol=REL_TOL,
         dtype=torch.float32, mesh=None):
    from sporco_tpu_torch.models.parcbpdn import ParConvBPDN
    return ParConvBPDN(D, S, lmbda, W=W, ngrp=PAR_NGRP, dtype=dtype,
                       opt=ParConvBPDN.options(max_iter=max_iter,
                                               rel_stop_tol=rel_stop_tol),
                       device=None if mesh is not None else dev, mesh=mesh)


def _par_arrays(b):
    return {name: b.state[i].cpu().numpy()
            for i, name in ((0, "Y0"), (2, "Y1"), (4, "X"), (5, "DX"))}


def par_rows(label, runs, rows_tol, arr_tol, zero):
    """Two ParConvBPDN runs (``[(itstat, arrays), ...]``, the second the
    reference): every stats row within ``rows_tol`` (``_rel_rows``), every
    array within ``arr_tol`` of its scale."""
    (ig, ag), (ic, ac) = runs
    if len(ig) != len(ic):
        raise AssertionError(f"{label}: {len(ig)} against {len(ic)} "
                             "iterations")
    errs = {name: _rel_rows(getattr(ig, name), getattr(ic, name), zero)
            for name in ig._names[1:]}
    bad = {k: v for k, v in errs.items() if not v <= rows_tol}
    for name in ag:
        errs[name] = float(np.abs(ag[name] - ac[name]).max()
                           / max(np.abs(ac[name]).max(), 1e-30))
        if not errs[name] <= arr_tol:
            bad[name] = errs[name]
    if bad:
        raise AssertionError(f"{label}: {bad} past {rows_tol:.0e} (rows), "
                             f"{arr_tol:.0e} (arrays)")
    return errs


def phase_par_parity(dev, mesh):
    """ParConvBPDN in float64 on the REST_PARITY_N crop of the headline,
    REST_PARITY_ITERS iterations, card against CPU (F64_PARITY, as the
    ``<family>_parity`` phases); then the mesh= model (its filter groups on the
    world-size-1 "filter" axis, the sums through NCCL) against mesh=None
    on the card, float32, PAR_MESH_ITERS iterations at full size: rows
    within PAR_MESH_ROWS."""
    D, S, _, lmbda, _ = par_problems()["headline"]
    n = REST_PARITY_N
    runs = []
    reads = {}
    for d in (dev, "cpu"):
        b = _par(D, S[:n, :n], None, lmbda, d, REST_PARITY_ITERS, 0.0,
                 torch.float64)
        b.solve()
        if d is dev:
            loop_reads("ParConvBPDN float64", REST_PARITY_ITERS)
            reads["float64"] = exact_reads("ParConvBPDN float64",
                                           REST_PARITY_ITERS)
        runs.append((b.getitstat(), _par_arrays(b)))
    f64 = par_rows("ParConvBPDN float64", runs, F64_PARITY["rows"],
                   F64_PARITY["X"], F64_PARITY["zero"])
    runs = []
    for m in (mesh, None):
        b = _par(D, S, None, lmbda, dev, PAR_MESH_ITERS, 0.0, mesh=m)
        wall, counts = _timed(b)
        label = "ParConvBPDN mesh" if m else "ParConvBPDN"
        expect_launches(label, counts,
                        rfft2_planar=2 * PAR_MESH_ITERS + 1,
                        irfft2_planar=2 * PAR_MESH_ITERS)
        loop_reads(label, PAR_MESH_ITERS)
        reads["mesh" if m else "unsharded"] = exact_reads(label,
                                                          PAR_MESH_ITERS)
        runs.append((b.getitstat(), _par_arrays(b)))
    mesh_errs = par_rows("ParConvBPDN mesh= against mesh=None", runs,
                         PAR_MESH_ROWS, PARITY["X"], 0.0)
    return {"float64": {"iterations": REST_PARITY_ITERS, "side": n,
                        "rel_err": f64, "tolerance": F64_PARITY},
            "mesh": {"iterations": PAR_MESH_ITERS, "side": N,
                     "rel_err": mesh_errs, "rows_tolerance": PAR_MESH_ROWS},
            "host_reads": reads}


def phase_par_solve(dev):
    """ParConvBPDN (PAR_NGRP groups) in float32 to REL_TOL on the
    headline and masked through PAR_MASK_MISSING of its pixels
    (``examples/csc_parallel.py``): iterations, objective, ms an
    iteration; ``rfft2_planar`` 2k + 1 and ``irfft2_planar`` 2k launches
    (Y0 - U0 and Y1 - U1, X and DX an iteration; D once a solve); the
    reconstruction error below REC_ERR, and for the masked problem the
    reconstruction's PSNR above the masked input's."""
    out = {}
    for name, (D, S, W, lmbda, clean) in par_problems().items():
        _par(D, S, W, lmbda, dev, 3).solve()
        b = _par(D, S, W, lmbda, dev, PAR_MAX_ITER)
        wall, counts = _timed(b)
        its = b.getitstat()
        k = len(its)
        expect_launches(f"ParConvBPDN {name}", counts,
                        rfft2_planar=2 * k + 1, irfft2_planar=2 * k)
        loop = loop_reads(f"ParConvBPDN {name}", k)
        exact_reads(f"ParConvBPDN {name}", k)
        rec = b.reconstruct().cpu().numpy()
        if not (np.all(np.isfinite(its._arr)) and np.all(np.isfinite(rec))):
            raise AssertionError(f"ParConvBPDN {name}: not finite")
        r = {"iterations": k, "converged": k < PAR_MAX_ITER,
             "final_objective": float(its.ObjFun[-1]), "wall_s": wall,
             "ms_per_iter": 1e3 * wall / k, "launches": counts,
             "host_reads": loop["host_reads"],
             "captured": loop["captured"],
             "rec_err": _rec_err(rec, clean)}
        if not r["rec_err"] < REC_ERR:
            raise AssertionError(f"ParConvBPDN {name}: reconstruction "
                                 f"error {r['rec_err']:.3f}")
        if W is not None:
            r["psnr_input_db"] = psnr(clean, S)
            r["psnr_db"] = psnr(clean, rec)
            if not r["psnr_db"] > r["psnr_input_db"]:
                raise AssertionError(
                    f"ParConvBPDN masked: PSNR {r['psnr_db']:.2f} dB not "
                    f"above the input's {r['psnr_input_db']:.2f}")
        out[name] = r
    return out


def phase_cns_sharded(dev, mesh, D0, S, lmbda):
    """``launch.consensus_cdl`` on the world-size-1 mesh (the consensus
    mean an NCCL all-reduce) against the unsharded loop on the card,
    CNS_SHARDED_ITERS outer iterations in float32: D within
    CNS_SHARDED_D of its scale and the same launches (the kernel stage:
    ``csc_iter`` once, 4 forward and 2 inverse transforms an outer
    iteration); then ms an outer iteration of each over CNS_ITERS more."""
    from sporco_tpu_torch.parallel import launch
    out, Ds = {}, {}
    for label in ("sharded", "unsharded"):
        d = (launch.consensus_cdl(D0, S, lmbda, mesh=mesh,
                                  max_iter=CNS_SHARDED_ITERS)
             if label == "sharded" else tcns.ConvBPDNDictLearn_Consensus(
                 D0, S, lmbda, max_iter=CNS_SHARDED_ITERS, device=dev))
        if _cns_route(d) != "kernel":
            raise AssertionError(f"consensus {label}: took the "
                                 f"{_cns_route(d)} stage")
        torch.cuda.synchronize()
        reset_launches()
        d.step(CNS_SHARDED_ITERS)
        torch.cuda.synchronize()
        counts = launches()
        expect_launches(f"consensus {label}", counts,
                        csc_iter=CNS_SHARDED_ITERS,
                        rfft2_planar=4 * CNS_SHARDED_ITERS,
                        irfft2_planar=2 * CNS_SHARDED_ITERS)
        Ds[label] = d.getdict().cpu().numpy()
        reset_launches()
        t0 = time.perf_counter()
        d.step(CNS_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        timed = launches()
        expect_launches(f"consensus {label}, timed", timed,
                        csc_iter=CNS_ITERS, rfft2_planar=4 * CNS_ITERS,
                        irfft2_planar=2 * CNS_ITERS)
        out[label] = {"launches": counts, "timed_iterations": CNS_ITERS,
                      "timed_launches": timed,
                      "ms_per_iter": 1e3 * wall / CNS_ITERS,
                      "objective": d.evaluate()[0]}
    err = float(np.abs(Ds["sharded"] - Ds["unsharded"]).max()
                / np.abs(Ds["unsharded"]).max())
    if not err <= CNS_SHARDED_D:
        raise AssertionError(f"sharded consensus D differs from the "
                             f"unsharded loop's by {err:.3e}")
    out["D_rel_err"] = err
    out["iterations"] = CNS_SHARDED_ITERS
    return out


def phase_spatial(dev, mesh, D, S, lmbda):
    """The row-sharded solvers at world size 1 (their transforms and sums
    through NCCL): ``cbpdn_nsharded`` on the headline against
    ``ConvBPDN(fused=False)`` on the card (iterations within one, the
    first SPATIAL_ROWS stats rows at PARITY's tolerances, the final
    objectives within OBJ_AGREE) and ``tvl2deconv_nsharded`` against
    ``TVL2Deconv`` on ``tv_problems()``'s deconvolution (iterations
    within one, X within SPATIAL_X of its scale); ms an iteration of
    each.  No kernel of the port runs in the sharded solvers."""
    from sporco_tpu_torch.parallel import spatial
    out = {}
    opt = ConvBPDN.options(max_iter=MAX_ITER, rel_stop_tol=REL_TOL)
    c = ConvBPDN(D, S, lmbda, opt=opt, fused=False, device=dev)
    wall_c, _ = _timed(c)
    ic = c.getitstat()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    X, stats, k = spatial.cbpdn_nsharded(D, S, lmbda, mesh, opt=opt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_launches("cbpdn_nsharded", launches())
    loop_reads("cbpdn_nsharded", k)
    reads_c = exact_reads("cbpdn_nsharded", k)
    names = ("ObjFun", "DFid", "RegL1", "PrimalRsdl", "DualRsdl", "Rho")
    cols = (1, 2, 3, 4, 5, 8)
    n = min(SPATIAL_ROWS, k, len(ic))
    errs = {}
    for name, j in zip(names, cols):
        ref = getattr(ic, name)[:n]
        errs[name] = float(np.max(np.abs(stats[:n, j] - ref) / np.abs(ref)))
        if not errs[name] <= PARITY[name]:
            raise AssertionError(f"cbpdn_nsharded {name} differs by "
                                 f"{errs[name]:.3e}")
    agree = abs(float(stats[-1, 1]) - float(ic.ObjFun[-1])) \
        / abs(float(ic.ObjFun[-1]))
    if abs(k - len(ic)) > 1 or not agree <= OBJ_AGREE or \
            not bool(torch.isfinite(X).all()):
        raise AssertionError(f"cbpdn_nsharded: {k} iterations, objective "
                             f"{stats[-1, 1]} against {len(ic)}, "
                             f"{ic.ObjFun[-1]}")
    out["cbpdn"] = {"iterations": k, "reference_iterations": len(ic),
                    "host_reads": reads_c,
                    "final_objective": float(stats[-1, 1]),
                    "objective_rel_diff": agree, "rel_err": errs,
                    "ms_per_iter": 1e3 * wall / k,
                    "reference_ms_per_iter": 1e3 * wall_c / len(ic)}
    cls, (h, noisy, lm), okw, _ = tv_problems()["TVL2Deconv"]
    b = cls(h, noisy, lm, opt=cls.options(**okw), device=dev)
    wall_b, _ = _timed(b)
    kb = len(b.getitstat())
    Xb = b.getmin().cpu().numpy().squeeze()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    Xt, kt, r, s = spatial.tvl2deconv_nsharded(h, noisy, lm, mesh,
                                               opt=cls.options(**okw))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_launches("tvl2deconv_nsharded", launches())
    loop_reads("tvl2deconv_nsharded", kt)
    reads_t = exact_reads("tvl2deconv_nsharded", kt)
    xe = float(np.abs(Xt.cpu().numpy() - Xb).max() / np.abs(Xb).max())
    if abs(kt - kb) > 1 or not xe <= SPATIAL_X:
        raise AssertionError(f"tvl2deconv_nsharded: {kt} iterations "
                             f"against {kb}, X differs by {xe:.3e}")
    out["tvl2deconv"] = {"iterations": kt, "reference_iterations": kb,
                         "host_reads": reads_t,
                         "X_rel_err": xe, "ms_per_iter": 1e3 * wall / kt,
                         "reference_ms_per_iter": 1e3 * wall_b / kb}
    return out


def grid_fn(p):
    """``tests/parallel/_launch_child.py``'s function: least at (0.3,
    0)."""
    return (p[0] - 0.3) ** 2 + abs(p[1])


def phase_grid_search(mesh):
    """``launch.grid_search`` at world size 1 (its slots exchanged by an
    NCCL all-gather): it finds GRID_FN_MIN with value 0."""
    from sporco_tpu_torch.parallel import launch
    grid = (np.linspace(0, 1, 11), np.array([-1.0, 0.0, 2.0]))
    prm, val, vals = launch.grid_search(grid_fn, grid)
    if not (abs(prm[0] - GRID_FN_MIN[0]) < 1e-12
            and prm[1] == GRID_FN_MIN[1] and abs(val) < 1e-12
            and vals.shape == (11, 3)):
        raise AssertionError(f"grid search found {prm}, {val}")
    return {"best": list(prm), "value": val, "points": int(vals.size)}


def fft_entry(name, fft, generic, replaces, route=None):
    """A FFT kernel's entry, its time from the call the solves make:
    ``route`` names the timing of that call where it is not the planar
    entry's (the inverse's is ``irfftn`` on a complex64 spectrum, through
    ``irfft2_spectrum``), and the planar entry's time is kept beside."""
    t = fft["headline"]
    ms = t[route or name]["ms"]
    return {"name": name, "route": "cuda",
            "source": "sporco_tpu_torch/csrc/fft2_planar.cu",
            "replaces": replaces, "launches": generic["launches"][name],
            "max_abs_err": fft["max_abs_err"][name], "ms": ms,
            "kernel_ms": ms, "planar_ms": t[name]["ms"],
            "plain_ms": t[name]["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t[name]["library_ms"]}


def geometry_entry(kern):
    """A kernel's numbers at one of the colour geometries."""
    out = {key: kern[key] for key in (
        "geometry", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
        "bound_as_built_ms", "bound_fp32_ms", "max_abs_err", "pass_ms")}
    if "un_rule" in kern:
        out["un_rule"] = kern["un_rule"]
        out["A_bits_as_cublas"] = kern["adjoint"]["kernel_A_bits_as_cublas"]
    return out


def kernel_entry(name, kern, solve, replaces, source=None):
    out = {"name": name, "route": "cuda",
           "source": source or f"sporco_tpu_torch/csrc/{name}.cu",
           "replaces": replaces, "launches": solve["launches"][name],
           "max_abs_err": kern["max_abs_err"], "ms": kern["kernel_ms"],
           "kernel_ms": kern["kernel_ms"], "plain_ms": kern["plain_ms"],
           "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
           "library_ms": None}
    for key in ("pass_ms", "bound_as_built_ms", "bound_fp32_ms"):
        if key in kern:
            out[key] = kern[key]
    if "grid" in kern and "vs_float64" in kern["grid"][0]:
        # the largest error against float64 over the grid, by output
        out["vs_float64"] = {
            who: {o: max(g["vs_float64"][who][o] for g in kern["grid"]
                         if o in g["vs_float64"][who])
                  for o in kern["grid"][-1]["vs_float64"][who]}
            for who in ("kernel", "plain")}
    return out


def dictlrn_launches(summary, csc, pgm, ffts):
    """Add to the kernels line's entries their launches on the masked,
    online and patch dictionary learning paths: online CDL's fused x-step
    (``csc_iter``), the masked learner's fused FISTA x-step
    (``pgm_iter``), and the FFT kernels in the two-block CSC, masked
    learner and online solves, by model."""
    def by_model(phase, name):
        return {label: rec["launches"][name]
                for label, rec in summary[phase].items()
                if isinstance(rec, dict) and "launches" in rec}
    csc["online_launches"] = by_model("online_solve", "csc_iter")[
        "OnlineConvBPDNDictLearn"]
    pgm["mdl_launches"] = by_model("mdl_solve", "pgm_iter")["pgm/pgm"]
    for entry in ffts:
        for phase, key in (("maskdcpl_solve", "maskdcpl_launches"),
                           ("mdl_solve", "mdl_launches"),
                           ("online_solve", "online_launches")):
            entry[key] = by_model(phase, entry["name"])


def rest_launches(summary, csc, ffts):
    """Add to the kernels line's entries their launches in this slice's
    solves: ``csc_iter`` in MultiDictConvBPDN's fused colour solve, the
    FFT kernels in every model's solve, by model."""
    csc["multidict_launches"] = summary["csc_variants_solve"][
        "MultiDictConvBPDN"]["launches"]["csc_iter"]
    for entry in ffts:
        entry["csc_rest_launches"] = {
            model: rec["launches"][entry["name"]]
            for family in REST_FAMILIES
            for model, rec in summary[f"{family}_solve"].items()
            if isinstance(rec, dict) and "launches" in rec}


def par_launches(summary, csc, ffts):
    """Add to the kernels line's entries their launches in the parallel
    slice's solves: ``csc_iter`` and the FFT kernels in the world-size-1
    sharded consensus (CNS_SHARDED_ITERS outer iterations), the FFT
    kernels in ParConvBPDN's solves."""
    sharded = summary["cns_sharded"]["sharded"]["launches"]
    csc["sharded_consensus_launches"] = sharded["csc_iter"]
    for entry in ffts:
        entry["sharded_consensus_launches"] = sharded[entry["name"]]
        entry["parcbpdn_launches"] = {
            name: rec["launches"][entry["name"]]
            for name, rec in summary["par_solve"].items()
            if isinstance(rec, dict) and "launches" in rec}


def jacobi_entry(summary):
    """The kernels line's entry of ``jac_round``, a kernel of the port's
    that has no TPU counterpart: its numbers for one SVD of 512x512
    float32 (the full Robust PCA's x-step: ``ms`` the captured SVD's
    replay, ``jac_round``'s launches with ``jac_sweep_end``,
    ``jac_norms`` and ``jac_finish``; ``plain_ms`` its plain version,
    ``jacobi_svd_plain``, on the card; ``library_ms``
    ``torch.linalg.svd``; ``bound_ms`` the larger of its bytes and its
    sweeps' FP64 operations, ``jacobi_bound_ms``),
    its launches in the two Robust PCA solves of ``rpca_solve``,
    ``shapes``: each ``svd_qr`` case's ms beside ``torch.linalg.svd``'s
    with its geometry, and ``complex_form``: the complex form's ms,
    bound, library ms and launches (its entry,
    ``jacobi_complex_entry``)."""
    svd = summary["svd_qr"]["svd"]
    head = svd["float32 full"]
    solves = {label: summary["rpca_solve"][label]["launches"]["jac_round"]
              for label in ("randomized", "full")}
    return {"name": "jac_round", "route": "cuda",
            "source": "sporco_tpu_torch/csrc/jacobi_svd.cu",
            "replaces": "none: no TPU kernel (the JAX package's "
                        "prox_nuclear, sporco_tpu/ops/prox.py:176-221, "
                        "leaves its SVD to XLA)",
            "tpu_kernel": False, "launches": sum(solves.values()),
            "rpca_launches": solves, "max_abs_err": head["max_abs_err"],
            "ms": head["ms"], "plain_ms": head["jacobi_plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["plain_ms"], "shape": head["shape"],
            "sweeps": head["sweeps"], "geometry": head["geometry"],
            "shapes": {name: {key: rec[key] for key in (
                "ms", "plain_ms", "bound_ms", "C", "w", "route",
                "blocks_per_round", "launches_per_sweep", "sweeps")}
                for name, rec in svd.items()},
            "complex_form": {key: jacobi_complex_entry(summary)[key]
                             for key in ("ms", "bound_ms", "bound_by",
                                         "library_ms", "launches")}}


def jacobi_complex_entry(summary):
    """The kernels line's entry of the complex form of ``jac_round``
    (``jac_round<w, SH, true>``, launched by ``jac_round_z_launch``): its
    numbers for one SVD of 512x512 complex64 (the complex full Robust PCA's
    x-step; the keys as ``jacobi_entry``'s), its launches in the two
    complex Robust PCA solves of ``rpca_complex``, and each shape of that
    phase beside ``torch.linalg.svd``."""
    svd = summary["rpca_complex"]["svd"]
    head = svd["complex64 full"]
    solves = {label: summary["rpca_complex"][label]["launches"]["jac_round"]
              for label in ("randomized", "full")}
    return {"name": "jac_round (complex form)", "route": "cuda",
            "source": "sporco_tpu_torch/csrc/jacobi_svd.cu",
            "replaces": "none: no TPU kernel (the JAX package's "
                        "prox_nuclear, sporco_tpu/ops/prox.py:176-221, "
                        "leaves its SVD to XLA, which takes complex input)",
            "tpu_kernel": False, "launches": sum(solves.values()),
            "rpca_launches": solves, "max_abs_err": head["max_abs_err"],
            "ms": head["ms"], "plain_ms": head["jacobi_plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["plain_ms"], "shape": head["shape"],
            "sweeps": head["sweeps"], "geometry": head["geometry"],
            "shapes": {name: {key: rec.get(key) for key in (
                "ms", "plain_ms", "jacobi_plain_ms", "bound_ms", "bound_by",
                "C", "w", "route", "blocks_per_round", "launches_per_sweep",
                "sweeps")}
                for name, rec in svd.items()}}


def kernels_line(summary):
    """The ``{"kernels": [...]}`` line from the phases' results: each
    kernel's headline numbers and main-path launches; ``csc_iter`` and
    ``pgm_iter`` also their numbers at the colour geometries and their
    launches in the fused colour solves."""
    csc = kernel_entry("csc_iter", summary["kernel"], summary["solve"],
                       "sporco_tpu/ops/pallas_csc_iter.py:276")
    # the consensus loop's form (emit_fwd=False) and its launches
    cns = geometry_entry(summary["cns_kernel"])
    cns["full_ms"] = summary["cns_kernel"]["full_ms"]
    cns["full_bound_ms"] = summary["cns_kernel"]["full_bound_ms"]
    cns["host_ms"] = summary["cns_kernel"]["host_ms"]
    csc["consensus"] = cns
    csc["consensus_launches"] = \
        summary["cns_solve"]["kernel"]["launches"]["csc_iter"]
    csc["cdl_launches"] = summary["cdl_solve"]["launches"]["csc_iter"]
    pgm = kernel_entry("pgm_iter", summary["pgm_kernel"],
                       summary["pgm_solve"],
                       "sporco_tpu/ops/pallas_csc_iter.py:409")
    fused_launches = {
        "colour l1": summary["clr_solve"]["l1"]["fused"]["launches"],
        "colour elastic":
            summary["clr_solve"]["elastic"]["fused"]["launches"],
        "colour FISTA": summary["clr_pgm_solve"]["fused"]["launches"],
        "folded l1": summary["cfold_solve"]["admm"]["fused"]["launches"],
        "folded FISTA":
            summary["cfold_solve"]["fista"]["fused"]["launches"]}
    for entry in (csc, pgm):
        name = entry["name"]
        entry["colour_geometries"] = {
            label: geometry_entry(kern[name])
            for label, kern in summary["clr_kernel"].items()
            if isinstance(kern, dict) and name in kern}
        entry["colour_launches"] = {
            label: counts[name] for label, counts in fused_launches.items()
            if counts[name]}
    ffts = [fft_entry("rfft2_planar", summary["fft"], summary["generic"],
                      "sporco_tpu/ops/pallas_fft.py:402"),
            fft_entry("irfft2_planar", summary["fft"], summary["generic"],
                      "sporco_tpu/ops/pallas_fft.py:433", route="irfftn")]
    for entry in ffts:
        # at 128x128 over the consensus loop's planes, and its launches
        name = entry["name"]
        entry["cdl_128"] = {
            key: {**t[name], "bound_ms": t["bound_ms"],
                  "bound_by": t["bound_by"],
                  "max_abs_err": t["max_abs_err"][name]}
            for key, t in summary["cns_kernel"]["fft"].items()}
        entry["consensus_launches"] = \
            summary["cns_solve"]["kernel"]["launches"][name]
        # the TV deconvolution solves' transforms of X
        entry["tv_deconv_launches"] = {
            model: summary["tv_solve"][model]["launches"][name]
            for model in ("TVL2Deconv", "TVL1Deconv")}
        # the line-search FISTA solves' on the graph route (their trials
        # in a WHILE node), BT_ITERS iterations each
        entry["bt_launches"] = {
            bt: summary["bt_solve"][bt]["graph"]["launches"][name]
            for bt in ("standard", "robust")}
        # ConvCnstrMOD's CG d-step on the graph route
        entry["ccmod_cg_launches"] = \
            summary["ccmod_cg_solve"]["graph"]["launches"][name]
    # the forms this slice added, as entries of their own: the AMS tail
    # (launches in the fused cbpdnmsk solve; cbpdngrdmsk's beside) and the
    # "mixed" forward product (launches in the mixed fused solves)
    ams = kernel_entry("admm_tail", summary["ams_tail_kernel"],
                       summary["ams_solve"],
                       "sporco_tpu/ops/pallas_csc_tail.py:105",
                       source="sporco_tpu_torch/csrc/csc_tail.cu")
    ams["name"] = "admm_tail (AMS form)"
    ams["plain_form_kernel_ms"] = \
        summary["ams_tail_kernel"]["plain_form_kernel_ms"]
    ams["gradreg_launches"] = \
        summary["ams_solve"]["gradreg"]["fused"]["launches"]["admm_tail"]
    mixed = []
    for name, line in (("csc_iter", 276), ("pgm_iter", 409)):
        entry = kernel_entry(name, summary["mixed_kernel"][name],
                             summary["mixed_solve"],
                             f"sporco_tpu/ops/pallas_csc_iter.py:{line}")
        entry["name"] = f"{name} (mixed form)"
        entry["max_abs_err"] = summary["mixed_kernel"][name]["max_abs_err"]
        for key in ("high_ms", "r1_vs_float64_of_bf16_operands"):
            entry[key] = summary["mixed_kernel"][name][key]
        mixed.append(entry)
    pgm["cdl_pgm_launches"] = summary["cdl_pgm_solve"]["launches"]["pgm_iter"]
    csc["handover_launches"] = \
        summary["dictlrn_handover"]["launches"]["csc_iter"]
    dictlrn_launches(summary, csc, pgm, ffts)
    rest_launches(summary, csc, ffts)
    par_launches(summary, csc, ffts)
    return {"kernels": [
        csc, pgm, *ffts,
        kernel_entry("admm_tail", summary["tail_kernel"],
                     summary["gradreg"],
                     "sporco_tpu/ops/pallas_csc_tail.py:105",
                     source="sporco_tpu_torch/csrc/csc_tail.cu"),
        ams, *mixed, jacobi_entry(summary), jacobi_complex_entry(summary)]}


def main(argv):
    signal.signal(signal.SIGALRM, _over_budget)
    signal.alarm(BUDGET_S)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    summary = {}

    def run_phase(name, fn):
        PHASE["name"] = name
        t0 = time.perf_counter()
        out = fn()
        out = {"phase": name, "seconds": time.perf_counter() - t0, **out}
        emit(out)
        return out

    smi = nvidia_smi()
    run_phase("device", lambda: {
        "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "accel": {"device_name": accel.device_name(),
                  "memory_info": list(accel.memory_info())}})

    def build():
        _nvcc.build(_nvcc.KERNELS)
        out = {"nvcc": _nvcc.find_nvcc()}
        for name in _nvcc.KERNELS:
            info = _nvcc.BUILD_INFO[name]
            out[name] = {
                "build_s": info["seconds"], "cached": info["cached"],
                "ptxas": [ln for ln in info["log"].splitlines()
                          if "registers" in ln or "spill" in ln]}
        for name in ("csc_iter", "pgm_iter"):
            out[name]["sass"] = check_split_build(name)
        return out
    run_phase("build", build)

    D, S, lmbda = headline_problem()
    summary["kernel"] = run_phase("kernel", lambda: phase_kernel(dev, D))
    run_phase("parity", lambda: phase_parity(dev, D, S, lmbda))
    # the fused solves at bench.py's FFT precision: glue on torch.fft
    with fft_precision("high"):
        summary["solve"] = run_phase("solve",
                                     lambda: phase_solve(dev, D, S, lmbda))
    summary["pgm_kernel"] = run_phase("pgm_kernel",
                                      lambda: phase_pgm_kernel(dev, D))
    run_phase("pgm_parity", lambda: phase_pgm_parity(dev, D, S, lmbda))
    with fft_precision("high"):
        summary["pgm_solve"] = run_phase(
            "pgm_solve", lambda: phase_pgm_solve(dev, D, S, lmbda))
    with fft_precision("highest"):
        summary["fft"] = run_phase("fft_kernel",
                                   lambda: phase_fft_kernel(dev))
    run_phase("generic_parity",
              lambda: phase_generic_parity(dev, D, S, lmbda))
    summary["generic"] = run_phase(
        "generic_solve",
        lambda: phase_generic_solve(dev, D, S, lmbda, summary["solve"]))
    run_phase("pgm_generic_solve",
              lambda: phase_pgm_generic_solve(dev, D, S, lmbda))
    summary["cond_node"] = run_phase("cond_node",
                                     lambda: phase_cond_node(dev))
    summary["bt_solve"] = run_phase(
        "bt_solve", lambda: phase_bt_solve(dev, D, S, lmbda))
    summary["tail_kernel"] = run_phase("tail_kernel",
                                       lambda: phase_tail_kernel(dev))
    Dg, gkw = gradreg_problem(D)
    run_phase("gradreg_parity",
              lambda: phase_gradreg_parity(dev, Dg, S, gkw))
    run_phase("gradreg_layout", lambda: phase_gradreg_layout(dev, D, S))
    summary["gradreg"] = run_phase(
        "gradreg_solve", lambda: phase_gradreg_solve(dev, Dg, S, gkw))
    run_phase("elastic_solve", lambda: phase_elastic_solve(dev, D, S))
    run_phase("wl1_spatial_solve",
              lambda: phase_wl1_spatial_solve(dev, D, S))
    Dc, S3 = colour_problem()
    summary["clr_kernel"] = run_phase(
        "clr_kernel", lambda: phase_clr_kernel(dev, D, Dc))
    run_phase("clr_parity", lambda: phase_clr_parity(dev, D, Dc, S3))
    summary["clr_solve"] = run_phase(
        "clr_solve", lambda: phase_clr_solve(dev, Dc, S3))
    summary["clr_pgm_solve"] = run_phase(
        "clr_pgm_solve", lambda: phase_clr_pgm_solve(dev, Dc, S3))
    summary["cfold_solve"] = run_phase(
        "cfold_solve", lambda: phase_cfold_solve(dev, D, S3))
    D0c, Sc, lc = cdl_problem()
    summary["cns_kernel"] = run_phase("cns_kernel",
                                      lambda: phase_cns_kernel(dev, D0c))
    run_phase("cns_parity", lambda: phase_cns_parity(dev, D0c, Sc, lc))
    summary["cns_solve"] = run_phase(
        "cns_solve", lambda: phase_cns_solve(dev, D0c, Sc, lc))
    summary["cdl_solve"] = run_phase(
        "cdl_solve", lambda: phase_cdl_solve(dev, D0c, Sc, lc))
    W, Sm = ams_problem(S)
    summary["ams_tail_kernel"] = run_phase(
        "ams_tail_kernel", lambda: phase_ams_tail_kernel(dev, W))
    run_phase("ams_parity", lambda: phase_ams_parity(dev, D, Sm, W))
    summary["ams_solve"] = run_phase(
        "ams_solve", lambda: phase_ams_solve(dev, D, Sm, W))
    summary["mixed_kernel"] = run_phase(
        "mixed_kernel", lambda: phase_mixed_kernel(dev, D))
    with fft_precision("high"):
        summary["mixed_solve"] = run_phase(
            "mixed_solve", lambda: phase_mixed_solve(
                dev, D, S, lmbda, summary["solve"], summary["pgm_solve"]))
    summary["cdl_pgm_solve"] = run_phase(
        "cdl_pgm_solve", lambda: phase_cdl_pgm_solve(dev, D0c, Sc, lc))
    run_phase("bpdn_parity", lambda: phase_bpdn_parity(dev))
    summary["bpdn_solve"] = run_phase("bpdn_solve",
                                      lambda: phase_bpdn_solve(dev))
    run_phase("tv_parity", lambda: phase_tv_parity(dev))
    summary["tv_solve"] = run_phase("tv_solve", lambda: phase_tv_solve(dev))
    run_phase("rpca_parity", lambda: phase_rpca_parity(dev))
    summary["rpca_solve"] = run_phase("rpca_solve",
                                      lambda: phase_rpca_solve(dev))
    summary["svd_qr"] = run_phase("svd_qr", lambda: phase_svd_qr(dev))
    summary["rpca_complex"] = run_phase("rpca_complex",
                                        lambda: phase_rpca_complex(dev))
    summary["dictlrn_handover"] = run_phase(
        "dictlrn_handover",
        lambda: phase_dictlrn_handover(dev, D, S, lmbda))
    run_phase("maskdcpl_parity",
              lambda: phase_maskdcpl_parity(dev, D, S, W, Sm))
    summary["maskdcpl_solve"] = run_phase(
        "maskdcpl_solve", lambda: phase_maskdcpl_solve(dev, D, S, W, Sm))
    run_phase("mdl_parity", lambda: phase_mdl_parity(dev, D0c, Sc, lc))
    summary["mdl_solve"] = run_phase(
        "mdl_solve", lambda: phase_mdl_solve(dev, D0c, Sc, lc))
    summary["ccmod_cg_solve"] = run_phase(
        "ccmod_cg_solve", lambda: phase_ccmod_cg_solve(dev, D0c, Sc))
    imgs, Wo = online_samples()
    summary["online_solve"] = run_phase(
        "online_solve", lambda: phase_online_solve(dev, D, imgs, Wo))
    run_phase("dense_dl_parity", lambda: phase_dense_dl_parity(dev))
    summary["dense_dl_solve"] = run_phase(
        "dense_dl_solve", lambda: phase_dense_dl_solve(dev))
    for family in REST_FAMILIES:
        run_phase(f"{family}_parity",
                  lambda: phase_rest_parity(dev, family))
        summary[f"{family}_solve"] = run_phase(
            f"{family}_solve", lambda: phase_rest_solve(dev, family))
    with dist_world(dev) as mesh:
        run_phase("par_parity", lambda: phase_par_parity(dev, mesh))
        summary["par_solve"] = run_phase("par_solve",
                                         lambda: phase_par_solve(dev))
        summary["cns_sharded"] = run_phase(
            "cns_sharded",
            lambda: phase_cns_sharded(dev, mesh, D0c, Sc, lc))
        summary["spatial"] = run_phase(
            "spatial", lambda: phase_spatial(dev, mesh, D, S, lmbda))
        run_phase("grid_search", lambda: phase_grid_search(mesh))
    if "--profile" in argv:
        def admm(**kw):
            return lambda: ConvBPDN(D, S, lmbda, opt=ConvBPDN.options(
                max_iter=MAX_ITER, rel_stop_tol=REL_TOL), device=dev, **kw)
        with fft_precision("high"):
            run_phase("profile", lambda: phase_profile(dev, admm()))
            run_phase("pgm_profile", lambda: phase_profile(
                dev, lambda: tpgm.ConvBPDN(D, S, lmbda, opt=pgm_options(),
                                           device=dev)))
        run_phase("generic_profile",
                  lambda: phase_profile(dev, admm(fused=False)))
        run_phase("gradreg_profile", lambda: phase_profile(
            dev, lambda: ConvBPDNGradReg(
                Dg, S, LMBDA, device=dev, **gkw,
                opt=admm_options(ConvBPDNGradReg))))
        run_phase("ams_profile", lambda: phase_profile(
            dev, lambda: _ams_model("l1", D, Sm, W, dev).cbpdn))
        run_phase("cns_profile", lambda: phase_profile(
            dev, lambda: tcns.ConvBPDNDictLearn_Consensus(
                D0c, Sc, lc, max_iter=CNS_ITERS, device=dev)))
        for name, make in dense_profile_models(dev).items():
            run_phase(name, lambda: phase_profile(dev, make))
        cls, args, kw, _ = two_block_models(D, S, W, Sm)["ConvBPDNMaskDcpl"]
        run_phase("maskdcpl_profile", lambda: phase_profile(
            dev, lambda: cls(*args, device=dev, **kw, opt=cls.options(
                max_iter=MAX_ITER, rel_stop_tol=REL_TOL))))
        Wc = mdl_mask(Sc)
        for xm, dm in (("admm", "cns"), ("pgm", "pgm")):
            run_phase(f"mdl_{xm}_{dm}_profile", lambda: phase_profile(
                dev, lambda: _mdl(D0c, Sc, Wc, lc, xm, dm, dev, 1)))
        rest_profiles(dev, run_phase)
    PHASE["name"] = "kernels"
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit(kernels_line(summary))
    elapsed = time.perf_counter() - t_start
    if elapsed > BUDGET_S:
        raise RuntimeError(f"over the time budget: {elapsed:.0f} s")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except Exception:
        print(f"chip_smoke: phase {PHASE['name']!r} failed",
              file=sys.stderr)
        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.exit(rc)
