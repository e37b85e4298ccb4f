"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed S]

Drives mrhyde_tpu_torch's thermal, cdr, thermal-advection, linear and
crystal elasticity and Navier-Stokes main paths (2D p1 quads, 3D hex,
2D p2 quads; element blocks, per-block physics, periodic and Exodus
meshes), the rest of its physics modules, those of vector and trace
bases (mixed, hybridized and weak Galerkin porous flow, maxwell,
maxwells_fp, hybridized shallow water, Euler's HDG form), decks whose
coefficients read the Parameters sublist, the analyses, the multiscale
subgrid method (the Subgrid sublist: batched Dirichlet-to-Neumann fine
solves on the card), decks with `Solver: shards` (DOF- and
element-sharded Newton solves, all shards stacked on the card), and its
module sets (NS + thermal with the Boussinesq term, NS + cdr, thermal +
cdr, coefficients that read the state; 2D p1 quads, 3D hex, 2D p2
quads; affine sets through mode "state"), with Neumann, Flux and
weak-Dirichlet boundary terms and at quadratures up to 6 (hex) and 8
(2D p1), steady and transient, and its solver layer (multigrid, AMG,
Chebyshev, element-Schwarz, BiCGStab),
through
`Problem(cfg).run()` on the card, after building
its CUDA kernels from the sources in this checkout (one nvcc per source,
the deck-generated module-set kernels among them, all in parallel) and
holding each against its plain torch version. Phases (one JSON line
each):

  1 device   card name and power limit; exits non-zero without CUDA
  2 build    nvcc build of mrhyde_tpu_torch/ops/csrc/*.cu and of the
             set_node_* and set_elem_* sources generated for phases
             3f, 3g and 3h and decks 34-43, 46-49, 51 and 52
             (functions/codegen.py; each library holds mode "full" and
             mode "state"), in
             seconds, with ptxas's report
  3 kernels  against their plain versions at 1024x1024 and 1000x777, in
             f64 (max |diff| <= 1e-12 max|plain|) and f32 (<= 1e-5
             max|plain|), with the median of 20 CUDA-event timings each:
             thermal_node_state steady (kappa scalar, kappa = 1 + 0.5 x
             y) and transient at DIRK-2,2 stage-1 coefficients (alpha_u
             = 0.5, alpha_t = 40; m = 2 with kappa = 1, m = 1 + 0.5 x
             with kappa = 1 + 0.5 x y); thermal_node_full steady and
             transient (kappa = 1 + e*e; seeded random u, beta_u, beta_t)
  4 gold     kappa = 1, NX=NY=40, direct solve: L2(e) = 0.00102776
             (rtol 2e-5; the reference deck's gold)
  5 default  kappa = 1, NX=NY=1024, nonlinear TOL 1e-10, default solver
             (GMRES + Jacobi): L2(e) = 1.56873e-06 (rtol 1e-4)
  6 nonlin   kappa = 1 + e*e with its manufactured source, NX=NY=256
             (512 before), CG, nonlinear TOL 1e-10: the JAX package's
             L2(e) (rtol 1e-4)
  7 transient_gold_nx40   the reference's 2D transient deck: NX=NY=40,
             BWE, 20 steps to t=1, direct: L2(e) = 0.00509256 at t=0.9
             and 0.00118468 at t=1.0 (rtol 2e-5; the reference's gold)
  8 transient_dirk22      the same manufactured deck at NX=NY=DIRK_N (512),
             DIRK-2,2, 8 steps to t=0.4, nonlinear TOL 1e-10, default
             solver (GMRES + Jacobi): L2(e) at t=0.4 (rtol 1e-4)
  9 transient_nonlinear_bdf2_nx256   kappa = 1 + e*e at 256^2 (512^2
             before) with its manufactured transient source, CG,
             nonlinear TOL 1e-10,
             BDF2 after one BWE/BDF1 startup step, 4 steps to t=0.2:
             L2(e) at t=0.2 (rtol 1e-4)
 10 ode_bdf2 the ODE BDF2 deck of tests/test_ode_integrators.py (general
             path, HVOL): L2(q) = 0.00106624 at t=1.0 (rtol 2e-5)
 3b kernels  ns_node_full against its plain version at 1024x256 and
             1000x243 on the channel [0,5]x[0,1], f64 and f32 (the same
             bounds), residual and rows each: PSPG steady with viscosity 1
             and 0.1 + 0.01 x, PSPG+SUPG at DIRK-2,2 stage-1 alphas (0.5,
             200) with seeded u_dot; CUDA-event medians of 20 (plain: its
             one check call)
 11 ns_channel_gold_nx50   the reference's NS channel, 50x10, PSPG,
             direct: L2 ux/pr/uy = 0.00198075 / 0.0148536 / 0.000169464
             (rtol 2e-5; the reference's gold)
 12 ns_channel_direct_nx128   the same at 128x32, nonlinear TOL 1e-8,
             direct (12,771 DOFs): the JAX package's L2 (rtol 1e-4)
 13 ns_startup_dirk22_nx128, _nx256   the channel started from rest at
             128x32 (12,771 DOFs) and 256x64 (50,115), PSPG+SUPG,
             DIRK-2,2, 2 steps of 0.01 (cut from 4), nonlinear TOL 1e-8,
             default solver (GMRES + Jacobi): the JAX package's L2
             ux/pr/uy at t=0.02 (rtol 1e-6: every stage's Newton solve
             converges)
 3c kernels  thermal_elem_state and thermal_elem_full (the element
             kernels) against their plain versions on hex at 128^3 and
             127x100x77 and on p2 quads at 1024^2 and 1000x777, f64 and
             f32 (the same bounds): steady with kappa = 1 and kappa = 1 +
             0.5 x y (z), and at DIRK-2,2 stage-1 alphas with kappa = m =
             1 (the decks' stage) and with kappa = 1 + 0.5 x y (z), m =
             1 + 0.5 x; "full" with kappa = 1 + e*e steady and at that
             stage (seeded u, beta_u, beta_t); CUDA-event medians of 20
             (plain: its one check call)
 14 hex_gold_nx10   the reference's thermal/3D_verification, 10^3 hex,
             direct: L2(e) = 0.0116656 (rtol 2e-5; the reference's gold)
 15 hex_default_nx32   the same at 32^3 (35,937 DOFs; cut from 64^3, then
             48^3 and 40^3), nonlinear TOL 1e-10, GMRES + Jacobi (HEX_DECKS)
 16 hex_nonlinear_nx32   kappa = 1 + e*e with its manufactured source,
             32^3, CG, TOL 1e-10
 17 hex_transient_dirk22_nx32   u = sin(2 pi t) S3, IC 0, DIRK-2,2, 8
             steps to t=0.4, TOL 1e-10, GMRES + Jacobi
 18 hex_transient_nonlinear_bdf2_nx32   kappa = 1 + e*e, BDF2 after one
             BWE/BDF1 startup step, 4 steps to t=0.2, CG
 19 p2_default_nx256   p2 quads (quadrature 4), kappa = 1, 256^2
             (263,169 DOFs), TOL 1e-10, GMRES + Jacobi
 20 p2_nonlinear_nx128   p2, kappa = 1 + e*e, 128^2, CG
             (15-20: the JAX package's L2 at rtol 1e-4)
 3d kernels_advect   the four thermal kernels' advection (ADVECT) cases
             against their plain versions at phases 3 and 3c's shapes,
             f64 and f32 (the same bounds): "state" and "full", steady
             and at DIRK-2,2 stage-1 alphas with m = 1, the velocity (2,
             1[, 0.5]) scalar and the rotating field per qp; CUDA-event
             medians of 20 (plain: its one check call)
 21 cdr_gold_nx40   the reference's cdr/2D_manufactured (v = (2, 1),
             reaction 0.5 c^2), direct: L2(c) = 0.00101714 (rtol 2e-5)
 22-29 CDR_DECKS   cdr 256^2 (512^2 before; v = (2, 1), reaction 0),
             the same with reaction 2 c (linear in c: JAX's affine split,
             thermal_node_state), its nonlinear twin
             (reaction 0.5 c^2), the rotating-field
             DIRK-2,2 deck at 512^2 (density 2, 4 steps to t = 0.2; 8 to
             0.4 before), thermal 'include advection' 256^2, cdr hex 32^3
             and nonlinear 32^3 (40^3 before), cdr p2 128^2 and
             nonlinear 128^2; GMRES + Jacobi, TOL 1e-10, the JAX
             package's L2 at rtol 1e-4 (tools/jax_references.py)
 3e kernels_ns_elem   ns_elem_full (the B1 Navier-Stokes kernel) against
             its plain version on the channel: hex 64^3 and 31x23x15 on
             [0,5]x[0,1]x[0,1], p2 512x128 and 250x61 on [0,5]x[0,1],
             f64 and f32 (the same bounds), residual and rows each, the
             three cases of phase 3b; CUDA-event medians of 20 (plain:
             its one call)
 30-33 NS_ELEM_DECKS   the channel on hex p1 (uz = 0 on the walls too)
             and on p2 quads (quadrature 4): ns3d_channel_direct_nx20
             (20x4x4, PSPG, steady, direct, TOL 1e-8, rtol 1e-4),
             ns3d_startup_dirk22_nx64 (64x16x16, 75,140 DOFs, the start-up
             of phase 13, rtol 1e-6), p2ns_channel_direct_nx64 (64x16,
             12,771 DOFs, rtol 1e-4), p2ns_startup_dirk22_nx128 (128x32,
             50,115 DOFs, rtol 1e-6): the JAX package's L2 of every
             variable (tools/jax_references.py)
 3f kernels_set   set_node_full (the module-set kernel, one source
             generated per deck) against its plain version at 1024x256
             and 1000x243, f64 and f32 (the same bounds), residual and
             rows each: NS + thermal PSPG steady; NS + thermal advected
             by (ux, uy), PSPG+SUPG at DIRK-2,2 stage-1 alphas with
             seeded u_dot; NS + cdr (velocity (ux, uy), source ux 1 + 0.1
             c^2) at that stage; thermal + cdr with kappa = 1 + e*c; cdr
             with the velocity (c, 1); CUDA-event medians of 20 (plain:
             its one check call)
 34 boussinesq_gold_nx8_beta1, _beta0   the JAX package's Boussinesq deck
             (tests/test_flow.py:63-98), direct: max |ux| equals JAX's to
             rtol 1e-8 at beta = 1 and is below 1e-3 of it at beta = 0
 35-37 SET_DECKS   boussinesq_cavity_startup_nx64 (the differentially
             heated cavity from rest, Ra = 1e3, Pr = 0.71, DIRK-2,2, 1
             step of 0.01 (cut from 4, then 2; at 64^2 since PR 21, 128^2
             before), GMRES + Jacobi: L2 of ux, uy and e),
             ns_cdr_startup_nx256 (the channel start-up with cdr
             advected by (ux, uy) and source ux 1 + 0.1 c^2: ux, uy, pr,
             c) and ns_channel_visc_nonlinear_direct_nx128 (viscosity 1 +
             0.1 ux^2, direct): the JAX package's L2 at rtol 1e-6 (NS +
             cdr: 1e-4, the agreement its capped GMRES solves leave in
             L2(pr))
 3g kernels_set_elem   set_elem_full (the element-tile module-set
             kernel, one source generated per deck) against its plain
             version at hex 64^3 and 31x23x15, p2 512x128 and 250x61, f64
             and f32 (the same bounds), residual rows and Jacobian rows
             each: NS + thermal PSPG steady (hex, nd 40), NS + cdr
             PSPG+SUPG at DIRK-2,2 stage-1 alphas (hex, 40), NS + thermal
             advected PSPG+SUPG at that stage (p2, 36), NS with viscosity
             1 + 0.1 ux^2 (hex, 32), thermal + cdr with kappa = 1 + e*c
             (p2, 18), cdr with the velocity (c, 1, 0.5) (hex, 8);
             CUDA-event medians of 20 (plain: its one check call)
 38-43 SET_ELEM_DECKS   ns3d_cdr_startup_dirk22_nx64 (the hex start-up
             of deck 31 with cdr in the set, 93,925 DOFs),
             ns3d_thermal_channel_direct_nx20 and
             p2ns_thermal_channel_direct_nx64 (mixed convection: NS +
             thermal advected by the flow, e = 1 bottom / 0 top, direct),
             ns3d_channel_visc_nonlinear_direct_nx20 (viscosity 1 + 0.1
             ux^2), thermal_cdr_p2_nx128 (kappa = 1 + e*c, 132,098 DOFs)
             and cdr_hex_state_velocity_nx32 (velocity (c, 1, 0.5)): the
             JAX package's L2 of every variable at rtol 1e-6
 3h kernels_state   set_node_state and set_elem_state (mode "state" of
             an affine set, from the u grid alone; each deck's generated
             source) against their plain versions: thermal + cdr with
             constant coefficients, steady and at DIRK-2,2 stage-1 alphas
             (0.5, 40), and steady with kappa = 1 + 0.5 x (2D p1 and
             hex), on 2D p1 1024^2 and 1000x777, hex 64^3 and 31x23x15,
             p2 512^2 and 250x161, f64 and f32 (the same bounds);
             CUDA-event medians of 20 (plain: its one check call)
 3i kernels_quadrature   ns_elem_full and set_elem_full (NS + thermal) on
             hex 31x23x15 at quadrature 6 (Q = 64; 8 elements per block
             in f64), set_node_full (viscosity 1 + 0.1 ux^2) and
             ns_node_full (PSPG) on 2D p1 1000x243 at quadrature 8 (Q =
             25), and thermal_node_state (kappa = 1 + 0.5 x y) on 1000x777
             at quadrature 4 (Q = 9, its runtime-Q instance), steady, f64
             and f32, against their plain versions (the same bounds)
 44 thermal_mixed_neumann_gold_nx40   the JAX package's
             test_mixed_dirichlet_neumann deck (e = 0 left and right, the
             Neumann flux of the true solution top and bottom), direct:
             its gold 0.00102733 (rtol 2e-5)
 45-47 BOUNDARY_DECKS   the same at 512^2 (CG), kappa = 1 + e*e with
             `use weak Dirichlet` at 256^2 (GMRES; 512^2 before PR 18),
             hex 40^3 with Neumann
             on the top and bottom faces: the JAX package's L2 (rtol 1e-6)
 48-51 AFFINE_SET_DECKS   thermal + cdr with constant coefficients, a
             Neumann flux on e and a Flux condition on c at the top:
             512^2 steady, 256^2 DIRK-2,2 (4 steps of 0.05), hex 48^3, p2
             128^2; the JAX package's L2 of both fields (rtol 1e-6)
 52-54 QUADRATURE_DECKS   the hex channel 20x5x5 and mixed convection on
             it at quadrature 6, the 128x32 channel with viscosity 1 +
             0.1 ux^2 at quadrature 8: the JAX package's L2 (rtol 1e-6)
 3j precond  the solver layer's preconditioners (Jacobi, Chebyshev,
             element-Schwarz, SIMPLE with the pressure dofs masked,
             StructuredMG's and AggregationAMG's V-cycles) on the card
             against the host, from the same Jacobian (assembled on the
             card at a seeded state, copied to the host) and the same
             seeded v: kappa = 1 + e*e at 64^2 (thermal_node_full's SoA
             rows) and the channel start-up at 128x32 (ns_node_full's,
             at a BWE stage), f64, max |card - host| <= 1e-12 max |host|;
             each variant's build and apply ms, the hierarchies' set-up s
 55-61 SOLVER_DECKS   decks of the earlier phases with the reference's
             solver keys: thermal + cdr 512^2 (deck 48) and cdr 256^2
             with the ILUT smoother (StructuredMG), cdr hex 32^3 with it
             (StructuredMG in 3D), cdr p2 128^2 with it (StructuredMG
             refuses p2: AggregationAMG), kappa = 1 + e*e 256^2 (deck 6)
             with CHEBYSHEV inside CG, the channel start-up 128x32 (deck
             13) with SCHWARZ, cdr 256^2 with Belos BiCGStab: the JAX
             package's L2 for the same deck (rtol 1e-6); the multigrid
             hierarchy is built in set-up (hierarchy_s), and the phase
             `solvers` lists each deck beside the Jacobi deck of the
             same problem
 62-67 MESH_DECKS   multiblock_gold_nx10 (the reference's
             thermal/2D_multiblock: 2x2 blocks of 10x10, one L2 per block,
             gold 0.000513878 each) and multiblock_nx256 (256 per block
             per direction, 263,169 DOFs, GMRES; 512 before PR 18), both on
             thermal_node_state; per_block_thermal_cdr_nx128 (the JAX
             package's per-block physics deck, thermal and cdr on two
             blocks of 128x64, direct, 33,410 DOFs); cdr_periodic_gold_nx40
             (the reference's cdr/periodic, gold at t = 0, 0.1, 1.0) and
             cdr_periodic_nx256 (2 steps); exodus_hex_nx32 (hex thermal
             read from an Exodus file that write_exodus writes, point
             Dirichlet conditions on two nodesets): the JAX package's L2
             of every label at rtol 1e-6 (multiblock_nx256 1e-4: the
             solves' f64 floor), the golds at 2e-5; all but the multi-block decks on the general
             path, no kernel
 68-72 SOLID_DECKS   le_manufactured_gold_nx40 (the reference's
             le/2D_manufactured, gold L2(dx), L2(dy)) and
             le_manufactured_nx512 (526,338 DOFs, StructuredMG under
             GMRES), le_hex_manufactured_nx32 (107,811 DOFs, CG),
             crystal_rotated_nx256 (64 grains' rotations from mesh data
             files written from --seed, CG), thermoelastic_transient_nx128
             (thermal and linear elasticity in one set, 4 BWE steps):
             the JAX package's L2 (rtol 1e-6; le_manufactured_nx512
             1e-5, the f64 floor), general path
 73-96 PHYSICS_DECKS   the rest of the physics modules, on the general
             path as in the JAX package, each held to the JAX package's
             L2 of every label at every recorded time (rtol 1e-6; a
             field exact to round-off, |L2| <= 1e-12) and to its gold:
             73-80 the reference decks at the reference's size:
             burgers_backtracking_gold_nx100 (1D, L2(u) 0.354012 /
             0.329584 / 0.313885 / 0.291375 at t = 0 / 0.001 / 0.002 /
             0.004), helmholtz_gold_nx100 (0.000517267 / 0.000222348),
             ks_wave_nx10 (1D periodic, 20 BWE steps),
             shallowwater_droptest_gold_nx40 (L2(H) 1.00321, L2(Hv)
             0.0121219 at rtol 2e-4),
             phasefield_3phi_gold_nx100 (the legacy first-qp sampling,
             six golds), vdns_channel_gold_nx50 (ux / pr / uy 0.0019421
             / 0.0128887 / 8.18291e-05), porous_verification_gold_nx40
             (L2 0.00102776, L2-grad 0.201394, L2-face 0.0017603 at
             2e-4) and hartmann_analytic_nx500 (the analytic solution's
             1.126126e-06 / 1.062206e-06 at 1e-4); golds at 2e-5 where
             not said;
             81-94 full width: burgers_2d_evisc_supg_nx256 (entropy
             viscosity and SUPG, v = (1, 0.5), 4 BWE steps),
             helmholtz_nx512 (GMRES + StructuredMG, 526,338 DOFs),
             shallowwater_droptest_nx256 (5 DIRK-1,2 steps),
             phasefield_consistent_nx256 (legacy sampling off, 198,147),
             vdns_channel_stab_nx128x32 (PSPG + SUPG + GRADDIV, 4 BWE
             steps from rest, direct: 128x32, not 256x64, see
             vdns_deck), porous_compressible_nx256 (compressibility
             0.1, permeability 1 + 0.5 sin(2 pi x), 4 steps, multigrid;
             256^2, not 512^2, for the script's time),
             ks_periodic_2d_nx64 (periodic in x and y, 4 steps, direct:
             64^2, not 128^2, see ks_deck), shallowice_nx256,
             hartmann_channel_nx256x64 (Neumann on b), llamas_nx256,
             phasesolidification_3d_nx32, inc_sat_wells_nx256x64 (a rate
             well, DIRK-2,2), physics_test_nx256, cns_pulse_2d_nx128
             (slip walls, DIRK-1,2); no fused provider, no launch;
             95 params_thermal_nonlinear_nx256   kappa = k0 + k1 e e from
             two inactive parameters: thermal_node_full;
             96 params_ns_channel_nx128   viscosity and source ux the
             active parameter nu = 0.5, direct: ns_node_full
 97-108 VECTOR_DECKS (phase `vector_decks`)   the modules of vector and
             trace bases, on the general path as in the JAX package (no
             fused provider, no launch), each held to the JAX package's
             L2 of every label at every recorded time (rtol 1e-6; 1e-4
             where each Krylov solve stops at its cap) and to its golds:
             97-101 the reference decks at the reference's size, direct:
             porous_mixed_gold_nx8 (RT0 u, p0 p: L2(p) 0.158697, L2(u)
             1.02259 at 2e-5, L2-div(u) 12.390539 at 1e-4),
             porous_mixed_hybrid_gold_nx8 (broken RT0 u, HFACE lambda:
             the same L2(p), L2(u)), porous_weak_galerkin_gold_nx10 (pint
             0.127469, L2-face(pbndry) 1.2962, u and t 0.814028),
             maxwell_nonzero_ic_hex_nx8 (HCURL E, HDIV B, L2-projected
             initial state, one DIRK-1,2 step: L2(E) 0.0692758 / 0.0743729,
             L2(B) 0.0976523 / 0.101339 at t = 0 / 0.01) and
             maxwells_fp_3d_gold_nx5 (the eight L2 of 'test: 2'), all at
             2e-5 where not said;
             102-108 full width: porous_mixed_schwarz_nx256 (131,584 RT0
             plus 65,536 p0 DOFs, GMRES + element-Schwarz, Newton to 1e-9
             over capped solves, rtol 1e-4),
             porous_mixed_hybrid_direct_nx64 (a dense solve of 28,800
             DOFs: no Krylov solve converges it in the JAX package beyond
             64^2), porous_weak_galerkin_gmres_nx256 (721,408 DOFs,
             GMRES without a preconditioner),
             maxwell_hex_gmres_nx32 (104,544 edge plus 101,376
             face DOFs, 4 DIRK-1,2 steps, GMRES + Jacobi),
             maxwells_fp_hex_direct_nx14 (a dense solve of 27,000 DOFs:
             GMRES stalls on it with Jacobi and with element-Schwarz),
             swe_hybridized_nx512 (789,507 DOFs, Far-field sides, 5
             DIRK-1,2 steps) and euler_hdg_maxev_nx128 (the
             contact-advection pulse on 128x32, 132,352 DOFs, max-EV
             stabilization, 4 DIRK-1,2 steps); the line `vector_decks`
             lists each deck's set-up, solve and assembly times and its
             stages, Newton and Krylov iterations
    analysis_decks   forward + adjoint, ROL, a discretized field, UQ +
             DCI and the NS + cdr multi-set start-up (128x32 since PR 21)
109-115 MULTISCALE_DECKS (phase `multiscale_decks`)   Subgrid decks
             through make_problem(cfg).run(), no fused provider and no
             launch: the reference's 2D_verification_multiscale gold
             deck (4x4, refinements 2: golds 0.198706 / 0.042848 at their
             printed precision, JAX at 1e-9), the same at 256^2 and
             refinements 3 (65,536 fine problems of 81 DOFs, JAX at
             1e-6), its transient DIRK-3,3 twin at 128^2 and refinements
             2 (4 steps, JAX at 1e-6), the BWE gold (10x10, 5 steps), the
             multimodel gold (40x40), the 3D hex gold (10^3) and the
             asynchronous regression (10x10, 4 substeps): each deck's
             set-up and solve s, peak device memory, and at full width
             the ms per residual_contribution and jacobian_contribution
             (CUDA events, median of 3)
    sharded_decks   SHARDED_DECKS, each through make_problem(cfg).run()
             unsharded and with `Solver: shards` (every shard stacked on
             the card, StackedComm; the sharded path is the general
             path's vmap(jacfwd), no launch): kappa = 1 + e*e at 256^2 on
             4 shards (CG), the NS start-up at 256x64 on 8 (GMRES(60) x
             4), the 2x2-block deck at 256 per block on 4 (CG), the
             multiscale gold deck on 4 (DOF scheme) and on 8 (the
             element-sharded scheme), the field-parameter boundary-group
             deck at 128^2 on 8 (CG); each label of the sharded run
             against the unsharded run's (1e-10; the NS start-up: ux
             1e-8, uy 1e-6, pr 2e-3) and against the JAX package's
             (sharded for NS and the field deck) or the golds; both runs'
             set-up and solve s and counts

The reference L2 values are the JAX package's, computed in f64 on the
CPU, or the reference's golds. Each deck runs one assembly before its
solve timer (reported as warmup_s). Kernel launch counts are reset just
before each deck's Problem.run() and read just after it, before the
assembly timing; so are the calls of the assembler's fused provider. A
fused deck must launch its kernel exactly once per fused res_and_jac
call (each Newton iteration and each stage's converged check), plus,
for the state kernel in a transient deck, twice per stage (the coord
part on the beta_u and beta_t grids), and the other kernels never: phases
4, 5, 7 and 8 run thermal_node_state, 6 and 9 thermal_node_full, 11-13
ns_node_full (once per fused res_and_jac call, no thermal kernel), 14,
15, 17 and 19 thermal_elem_state, 16, 18 and 20 thermal_elem_full,
each of 21-29 the kernel its CDR_DECKS entry names, 30-33
ns_elem_full (once per fused res_and_jac call, no other kernel; the
2D p1 NS decks 11-13 never launch it), 34-37 set_node_full and 38-43
set_elem_full (once per fused res_and_jac call, no other kernel); a
boundary deck launches the kernel of its deck without boundary terms
(44 and 45 thermal_node_state, 46 thermal_node_full, 47
thermal_elem_state; the boundary terms are the general path's), each
affine set deck its state kernel once per fused res_and_jac call and no
"full" kernel (48 and 49 set_node_state, 50 and 51 set_elem_state; their
coord part is plain torch, once per stage), 52-54 ns_elem_full,
set_elem_full and set_node_full at Q = 64, 64 and 25, and each solver
deck the kernel of the deck it comes from (55 set_node_state, 56 and 61
thermal_node_state, 57 and 58 thermal_elem_state, 59 thermal_node_full,
60 ns_node_full), 62 and 63 thermal_node_state, 64-72 none, 73-94 none,
95 thermal_node_full, 96 ns_node_full, 97-108 none, 109-115 none and
the sharded runs of phase sharded_decks none. The
`kernels` line
reports the sums over the decks (ten kernels: the eight of the earlier
phases and set_node_state, set_elem_state), each kernel's error, times
and bound (bytes or operations, whichever is larger; see `bound`) at
its quoted
case, for the four thermal kernels the same of their advection case
with the launches of decks 21-29 ("advect"), for set_elem_full each
phase 3g case ("cases", f64 at the divisible shape), for
thermal_elem_state each of its phase 3c cases ("cases", f64 at hex 128^3
and p2 1024^2), for the two state kernels each of their phase 3h cases
("cases"), and for ns_elem_full,
set_elem_full, set_node_full, ns_node_full and thermal_node_state their
phase 3i case ("quadrature").
Any failure raises; the last line of a passing run is {"ok": true,
"device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


S_TRUE = "sin(2*pi*x)*sin(2*pi*y)"
SOURCE = "8*(pi*pi)*sin(2*pi*x)*sin(2*pi*y)"
# the source of kappa = 1 + u^2 for the same true solution
SOURCE_NL = (f"8*(pi*pi)*{S_TRUE}*(1+({S_TRUE})^2) - 8*(pi*pi)*{S_TRUE}*"
             "((cos(2*pi*x)*sin(2*pi*y))^2+(sin(2*pi*x)*cos(2*pi*y))^2)")
# transient: u = T S with T = sin(2 pi t), S = S_TRUE
T_TIME = "sin(2*pi*t)"
SOURCE_T = ("(8*(pi*pi)*sin(2*pi*t)+2*pi*cos(2*pi*t))"
            "*sin(2*pi*x)*sin(2*pi*y)")
# u_t - div((1 + u^2) grad u) for the same u, S and T substituted as text
SOURCE_T_NL = (
    "2*pi*cos(2*pi*t)*S + 8*(pi*pi)*T*S*(1+(T*S)^2) - 8*(pi*pi)*T*T*T*S*"
    "((cos(2*pi*x)*sin(2*pi*y))^2+(sin(2*pi*x)*cos(2*pi*y))^2)"
).replace("S", S_TRUE).replace("T", T_TIME)
# mesh of the DIRK-2,2 deck, and the JAX package's f64 CPU L2(e) at t=0.4
# (512², not 1024²: the JAX CPU run that gives the reference takes 6.4
# minutes at 512² and grows ~10x per halving of h)
DIRK_N, DIRK_L2 = 512, 0.000966998
# the JAX package's f64 CPU L2(e) of the nonlinear steady deck and at
# t=0.2 of the nonlinear BDF2 deck, at 256² (512² until the boundary and
# affine-set decks came in: 6.27492e-06 and 0.000532754; the BDF2 error
# falls 4x per halving of h and dt: 2.01e-3, 4.80e-4, 1.17e-4 at 32², 64²,
# 128² with 4, 8, 16 steps)
NONLINEAR_L2 = 2.5099636346396307e-05
BDF2_NL_L2 = 0.0005499555253604403


def deck(n, kappa="1.0", source=SOURCE, solver=None):
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Functions": {"thermal source": source, "thermal diffusion": kappa},
        "Physics": {"modules": "thermal",
                    "Dirichlet conditions": {"e": {"all boundaries": 0.0}}},
        "Discretization": {"order": {"e": 1}, "quadrature": 2},
        "Solver": dict({"solver": "steady-state"}, **(solver or {})),
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e": S_TRUE}},
    }


def transient_deck(n, solver, kappa="1.0", source=SOURCE_T):
    """The reference's 2D transient thermal deck (IC 0, Dirichlet 0,
    u = sin(2 pi t) S_TRUE) with the given transient Solver keys."""
    cfg = deck(n, kappa, source, dict({"solver": "transient"}, **solver))
    cfg["Physics"]["Initial conditions"] = {"e": "0.0"}
    cfg["Postprocess"]["True solutions"] = {"e": f"{T_TIME}*{S_TRUE}"}
    return cfg


def nonlinear_deck(n):
    """kappa = 1 + e*e with its manufactured source, CG."""
    return deck(n, "1.0 + e*e", SOURCE_NL,
                {"nonlinear TOL": 1e-10, "Belos solver": "CG"})


def bdf2_nonlinear_deck(n):
    """kappa = 1 + e*e with its manufactured transient source, CG, BDF2
    after one BWE/BDF1 startup step, 4 steps to t=0.2."""
    return transient_deck(n, {
        "transient Butcher tableau": "BWE", "transient BDF order": 2,
        "transient startup Butcher tableau": "BWE",
        "transient startup BDF order": 1, "transient startup steps": 1,
        "final time": 0.2, "number of steps": 4, "nonlinear TOL": 1e-10,
        "Belos solver": "CG"}, "1.0 + e*e", SOURCE_T_NL)


def ode_bdf2_deck():
    """tests/test_ode_integrators.py's BDF2 deck: q' = -q, q(0) = 1."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": 2, "NY": 2},
        "Functions": {"ODE source": "-1.0*q"},
        "Physics": {"modules": "ODE", "Initial conditions": {"q": "1.0"}},
        "Discretization": {"order": {"q": 1}, "quadrature": 1},
        "Solver": {"solver": "transient", "transient BDF order": 2,
                   "transient Butcher tableau": "BWE",
                   "transient startup Butcher tableau": "DIRK-1,2",
                   "transient startup BDF order": 1,
                   "transient startup steps": 2, "workset size": 1,
                   "nonlinear TOL": 1e-7, "max nonlinear iters": 2,
                   "final time": 1.0, "number of steps": 10,
                   "use direct solver": True},
        "Postprocess": {"compute errors": True,
                        "True solutions": {"q": "1.0*exp(-1.0*t)"}},
    }


def quad_tables(N0, N1, device, dtype, lx=1.0, ly=1.0, quadrature=2):
    """Reference-quad tables of a uniform N0 x N1 grid on the box [0, lx]
    x [0, ly] (p1, at the given quadrature), and the quadrature-point
    offsets inside an element."""
    import numpy as np
    from mrhyde_tpu_torch.assembly.discretization import Discretization
    from mrhyde_tpu_torch.mesh.structured import box_mesh
    from mrhyde_tpu_torch.ops.fused_p1 import QuadTables
    disc = Discretization(box_mesh("quad", nx=1, ny=1, xmax=lx / N0,
                                   ymax=ly / N1), [("e", "HGRAD", 1)],
                          quadrature)
    key = ("HGRAD", 1)
    tab = QuadTables(disc.basis_vals[key], disc.basis_grads[key][0],
                     disc.wts[0], device, dtype)
    return tab, np.asarray(disc.ip[0])


# DIRK-2,2 stage 1 at dt = 0.05: alpha_u = A11/b1, alpha_t = 1/(dt b1)
DIRK22_STAGE1 = (0.5, 40.0)


def qp_inputs(N0, N1, tab, q_off, device, dtype, gen):
    """Seeded random node grids u, beta_u, beta_t, and per-qp (E, Q)
    tensors: kappa = 1 + 0.5 x y, m = 1 + 0.5 x; for kappa = 1 + e*e
    with source SOURCE_NL the tensors S, a seeded dS/de, K, dK/de at u
    (steady),
    and at u_eval = alpha_u u + beta_u, u_dot = alpha_t u + beta_t with
    m = 1 (S = u_dot - f; DIRK-2,2 stage-1 alphas) for the transient
    full kernel. Returns (u, kxy, mx, steady full inputs, (u_eval,
    transient full inputs))."""
    import math
    u, bu, bt = (torch.rand((N0 + 1, N1 + 1), generator=gen, device=device,
                            dtype=dtype) - 0.5 for _ in range(3))
    ii = torch.arange(N0, device=device, dtype=dtype)[:, None, None]
    jj = torch.arange(N1, device=device, dtype=dtype)[None, :, None]
    qx = torch.as_tensor(q_off[:, 0], device=device, dtype=dtype)
    qy = torch.as_tensor(q_off[:, 1], device=device, dtype=dtype)
    x = (ii / N0 + qx).expand(N0, N1, tab.Q)
    y = (jj / N1 + qy).expand(N0, N1, tab.Q)
    kxy = (1.0 + 0.5 * x * y).reshape(-1, tab.Q).contiguous()
    mx = (1.0 + 0.5 * x).reshape(-1, tab.Q).contiguous()

    def at_qps(g):
        corners = [g[:N0, :N1], g[1:, :N1], g[1:, 1:], g[:N0, 1:]]
        return torch.stack([sum(tab.phi[c][q] * corners[c]
                                for c in range(4))
                            for q in range(tab.Q)], dim=-1)
    s = torch.sin(2 * math.pi * x) * torch.sin(2 * math.pi * y)
    gx = torch.cos(2 * math.pi * x) * torch.sin(2 * math.pi * y)
    gy = torch.sin(2 * math.pi * x) * torch.cos(2 * math.pi * y)
    f = 8 * math.pi ** 2 * s * (1 + s * s) - 8 * math.pi ** 2 * s * (
        gx * gx + gy * gy)

    def full_inputs(uq, S):
        # dS/de is 0 for this source; a seeded one checks its column term
        dS = torch.rand(uq.shape, generator=gen, device=device,
                        dtype=dtype) - 0.5
        return [t.reshape(-1, tab.Q).contiguous()
                for t in (S, dS, 1.0 + uq * uq, 2.0 * uq)]
    au, at = DIRK22_STAGE1
    ue = (au * u + bu).contiguous()
    ueq, udq = at_qps(ue), at_qps(at * u + bt)
    return (u, kxy, mx, full_inputs(at_qps(u), -f),
            (ue, full_inputs(ueq, udq - f)))


def cuda_ms(fn, reps=20, warm=True):
    """Median of `reps` CUDA-event timings of fn(), after a warm-up call
    (warm=False: the caller's last call of fn was one)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timed(fn):
    """(fn(), its CUDA-event time in ms): one call."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def max_err(out, ref):
    """(max |out - ref|, max |ref|) over a tensor or a tuple of them."""
    if isinstance(ref, tuple):
        pairs = [max_err(o, r) for o, r in zip(out, ref)]
        return max(p[0] for p in pairs), max(p[1] for p in pairs)
    return (float((out - ref).abs().max()), float(ref.abs().max()))


KERNEL_SHAPES = ((1024, 1024), (1000, 777))


def phase_kernels(device):
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    summary = {}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for N0, N1 in KERNEL_SHAPES:
            gen = torch.Generator(device=device).manual_seed(1234)
            tab, ip0 = quad_tables(N0, N1, device, dtype)
            u, kxy, mx, (S, dS, K, dK), (ue, tr) = qp_inputs(
                N0, N1, tab, ip0, device, dtype, gen)
            st2 = fp.Stage(*DIRK22_STAGE1, 2.0)
            stx = fp.Stage(*DIRK22_STAGE1, mx)
            st1 = fp.Stage(*DIRK22_STAGE1, 1.0)
            work = (N0, N1, tab.Q, dtype)
            cases = [
                ("thermal_node_state", "kappa=1.0",
                 lambda: fp.thermal_node_state(u, 1.0, tab),
                 lambda: fp.thermal_node_state_plain(u, 1.0, tab),
                 thermal_work("state", *work, 1.0, None)),
                ("thermal_node_state", "kappa=1+0.5xy",
                 lambda: fp.thermal_node_state(u, kxy, tab),
                 lambda: fp.thermal_node_state_plain(u, kxy, tab),
                 thermal_work("state", *work, kxy, None)),
                ("thermal_node_state", "dirk22 kappa=1.0 m=2.0",
                 lambda: fp.thermal_node_state(u, 1.0, tab, st2),
                 lambda: fp.thermal_node_state_plain(u, 1.0, tab, st2),
                 thermal_work("state", *work, 1.0, st2)),
                ("thermal_node_state", "dirk22 kappa=1+0.5xy m=1+0.5x",
                 lambda: fp.thermal_node_state(u, kxy, tab, stx),
                 lambda: fp.thermal_node_state_plain(u, kxy, tab, stx),
                 thermal_work("state", *work, kxy, stx)),
                ("thermal_node_full", "kappa=1+e*e",
                 lambda: fp.thermal_node_full(u, S, dS, K, dK, tab),
                 lambda: fp.thermal_node_full_plain(u, S, dS, K, dK, tab),
                 thermal_work("full", *work, None, None, (S, dS, K, dK))),
                ("thermal_node_full", "dirk22 kappa=1+e*e m=1.0",
                 lambda: fp.thermal_node_full(ue, *tr, tab, st1),
                 lambda: fp.thermal_node_full_plain(ue, *tr, tab, st1),
                 thermal_work("full", *work, None, st1, tr)),
            ]
            for name, label, kern, plain, (nbytes, nflops) in cases:
                ref, plain_ms = timed(plain)
                out = kern()
                torch.cuda.synchronize()
                err, scale = max_err(out, ref)
                ok = err <= rtol * scale
                rec = {"phase": "kernels", "kernel": name, "case": label,
                       "dtype": str(dtype).replace("torch.", ""),
                       "shape": [N0, N1], "max_abs_err": err,
                       "max_abs_plain": scale, "rtol": rtol, "ok": ok,
                       "ms": cuda_ms(kern), "plain_ms": plain_ms,
                       **bound(nbytes, nflops, dtype)}
                emit(rec)
                if not ok:
                    raise SystemExit(f"{name} {label} disagrees with its "
                                     f"plain version: {rec}")
                # the summary line quotes the f64 1024x1024 transient
                # cases (the varying-coefficient one for the state kernel)
                if dtype == torch.float64 and (N0, N1) == KERNEL_SHAPES[0] \
                        and label in ("dirk22 kappa=1+0.5xy m=1+0.5x",
                                      "dirk22 kappa=1+e*e m=1.0"):
                    summary[name] = rec
    return summary


# ----------------------------------------------------------------------
# Navier-Stokes
# ----------------------------------------------------------------------

# the reference's NS channel (navierstokes/channel, 50x10; bench.py:49-62
# sizes it NY = NX/4): [0,5]x[0,1], Poiseuille flow ux = 0.5 y (1-y)
# driven by source ux = 1
NS_TRUE = {"ux": "0.5*y*(1.0-y)", "uy": "0.0", "pr": "0.0"}
# the JAX package's f64 CPU L2 (ux, pr, uy) of the 128x32 direct deck
NS_DIRECT_128 = (1.88440e-4, 2.86955e-3, 1.22447e-5)
# the start-up deck at n x n/4: (rtol, the JAX package's f64 CPU L2 (ux,
# pr, uy) at t = 0.02). At 128x32 every GMRES solve converges
# (1,500 iterations each); at 256x64 every one stops at its 2,000-iteration
# cap, but each stage's Newton solve still converges in two steps
# (||r||/||r0|| <= 2e-11), so at both sizes the two packages agree to
# rounding. (The 512x128 deck, whose stages 6-8 stall above the tolerance
# in both packages, left the script to make room for the B1
# Navier-Stokes decks: it took 43.7 s of solve; its reference is in
# ROADMAP.md, with the t = 0.04 ones of these two.)
NS_STARTUP = {
    128: (1e-6, {0.02: (0.167438940563, 1.85237941387e-3,
                        2.16197800775e-5)}),
    256: (1e-6, {0.02: (0.16743666533719045, 0.00041739961509650926,
                        4.619296516076629e-06)}),
}
# DIRK-2,2 stage 1 at dt = 0.01: alpha_u = A11/b1, alpha_t = 1/(dt b1)
NS_STAGE1 = (0.5, 200.0)


def ns_deck(nx, ny, solver, supg=False):
    """The NS channel deck with PSPG (and SUPG), at rest initially."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "xmin": 0.0,
                 "xmax": 5.0, "ymin": 0.0, "ymax": 1.0, "NX": nx,
                 "NY": ny},
        "Physics": {"modules": "navier stokes", "usePSPG": True,
                    "useSUPG": supg,
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "ux": {"bottom": 0.0, "top": 0.0},
                        "uy": {"bottom": 0.0, "top": 0.0}},
                    "Initial conditions": {"scalar data": True, "ux": 0.0,
                                           "uy": 0.0, "pr": 0.0}},
        "Discretization": {"order": {"ux": 1, "uy": 1, "pr": 1},
                           "quadrature": 2},
        "Solver": dict({"solver": "steady-state"}, **solver),
        "Postprocess": {"compute errors": True,
                        "True solutions": dict(NS_TRUE)},
        "Functions": {"source ux": "1.0"},
    }


# the start-up from rest: DIRK-2,2, 2 steps of 0.01 (4 until the
# affine-set and boundary decks came in; the t = 0.02 references are the
# 4-step runs'), nonlinear TOL 1e-8, the default linear solver (GMRES +
# Jacobi)
NS_STARTUP_SOLVER = {"solver": "transient",
                     "transient Butcher tableau": "DIRK-2,2",
                     "final time": 0.02, "number of steps": 2,
                     "nonlinear TOL": 1e-8}


def ns_startup_deck(nx):
    """The channel started from rest, PSPG+SUPG (NS_STARTUP_SOLVER)."""
    return ns_deck(nx, nx // 4, NS_STARTUP_SOLVER, supg=True)


def ns_elem_deck(mesh, nx, solver, supg=False):
    """The channel deck on hex p1 (nx x nx/4 x nx/4 on [0,5]x[0,1]x[0,1],
    uz = 0 on the no-slip walls too) or on p2 quads (nx x nx/4,
    quadrature 4): the B1 Navier-Stokes decks."""
    cfg = ns_deck(nx, nx // 4, solver, supg)
    phys = cfg["Physics"]
    if mesh == "hex":
        cfg["Mesh"].update({"dimension": 3, "element type": "hex",
                            "zmin": 0.0, "zmax": 1.0, "NZ": nx // 4})
        phys["Dirichlet conditions"]["uz"] = {"bottom": 0.0, "top": 0.0}
        phys["Initial conditions"]["uz"] = 0.0
        cfg["Discretization"]["order"]["uz"] = 1
        cfg["Postprocess"]["True solutions"]["uz"] = "0.0"
    else:
        cfg["Discretization"] = {"order": {"ux": 2, "uy": 2, "pr": 2},
                                 "quadrature": 4}
    return cfg


def ns_elem_startup_deck(mesh, nx):
    """ns_startup_deck's start-up on hex or p2 (ns_elem_deck)."""
    return ns_elem_deck(mesh, nx, NS_STARTUP_SOLVER, supg=True)


NS_DIRECT = {"use direct solver": True, "nonlinear TOL": 1e-8}
# name -> (deck function of nx, nx on the card, rtol, {held time: the JAX
# package's f64 CPU L2 per variable}); tools/jax_references.py runs the
# same deck functions through the JAX package for those references
# (set-up / solve s there: 0.09 / 6.4, 3.2 / 162, 0.5 / 46, 0.8 / 376)
NS_ELEM_DECKS = {
    # 20x5x5 hex, 3,024 DOFs
    "ns3d_channel_direct_nx20": (
        lambda n: ns_elem_deck("hex", n, NS_DIRECT), 20, 1e-4,
        {0.0: {"ux": 0.00793801228220015, "uy": 0.0007936004272299433,
               "uz": 0.0029675811517704924, "pr": 0.042924342437798815}}),
    # 64x16x16 hex, 75,140 DOFs, 16,384 elements
    "ns3d_startup_dirk22_nx64": (
        lambda n: ns_elem_startup_deck("hex", n), 64, 1e-6,
        {0.02: {"ux": 0.16744823526484015, "uy": 8.381002276679228e-05,
                "uz": 4.405179646999185e-05, "pr": 0.0068351997434308535}}),
    # 64x16 p2, 12,771 DOFs
    "p2ns_channel_direct_nx64": (
        lambda n: ns_elem_deck("p2", n, NS_DIRECT), 64, 1e-4,
        {0.0: {"ux": 0.00023598676601114437, "uy": 5.4147272316409495e-05,
               "pr": 0.007146123290226088}}),
    # 128x32 p2, 50,115 DOFs
    "p2ns_startup_dirk22_nx128": (
        lambda n: ns_elem_startup_deck("p2", n), 128, 1e-6,
        {0.02: {"ux": 0.16743590729451366, "uy": 1.9943851165782234e-05,
                "pr": 0.001385678830385292}}),
}


def boussinesq_deck(n, beta=1.0):
    """The JAX package's Boussinesq test (tests/test_flow.py:63-98):
    navier stokes + thermal on n x n p1 quads, PSPG, steady, direct;
    source uy -1 and rho beta (e - T_ambient) source_d in each momentum
    equation, e = 1 on the left and 0 on the right."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Physics": {"modules": "navier stokes,thermal",
                    "usePSPG": True, "beta": beta, "T_ambient": 0.0,
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "ux": {"all boundaries": 0.0},
                        "uy": {"all boundaries": 0.0},
                        "e": {"left": 1.0, "right": 0.0}}},
        "Functions": {"source uy": "-1.0", "source ux": "0.0",
                      "thermal source": "0.0"},
        "Discretization": {"order": {"ux": 1, "uy": 1, "pr": 1, "e": 1},
                           "quadrature": 2},
        "Solver": {"solver": "steady-state", "use direct solver": True,
                   "max nonlinear iters": 8, "nonlinear TOL": 1e-10},
        "Postprocess": {"compute errors": False},
    }


# the differentially heated cavity's Rayleigh and Prandtl numbers (de Vahl
# Davis 1983): beta = Ra Pr multiplies the buoyancy of source uy = -1
CAVITY_RA, CAVITY_PR = 1.0e3, 0.71
# the start-up's first step of 0.01 (of 4, then 2 before), for the
# script's time: Newton runs to its cap in every stage (below)
CAVITY_SOLVER = dict(NS_STARTUP_SOLVER, **{"final time": 0.01,
                                           "number of steps": 1})


def cavity_deck(n):
    """The differentially heated square cavity started from rest: n x n p1
    quads on the unit square, no-slip walls, e = 1 on the left and 0 on
    the right, adiabatic top and bottom; thermal advected by (ux, uy),
    viscosity Pr, thermal diffusion 1; PSPG+SUPG, DIRK-2,2, 1 step of
    0.01 (CAVITY_SOLVER), the default solver. No true solution: the L2
    lines are the fields' norms."""
    zero = {v: "0.0" for v in ("ux", "uy", "pr", "e")}
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Physics": {"modules": "navier stokes,thermal", "usePSPG": True,
                    "useSUPG": True, "include advection": True,
                    "beta": CAVITY_RA * CAVITY_PR, "T_ambient": 0.0,
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "ux": {"all boundaries": 0.0},
                        "uy": {"all boundaries": 0.0},
                        "e": {"left": 1.0, "right": 0.0}},
                    "Initial conditions": dict(
                        {"scalar data": True},
                        **{v: 0.0 for v in zero})},
        "Functions": {"source uy": "-1.0", "viscosity": str(CAVITY_PR),
                      "thermal diffusion": "1.0", "advection x": "ux",
                      "advection y": "uy"},
        "Discretization": {"order": {v: 1 for v in zero}, "quadrature": 2},
        "Solver": dict(CAVITY_SOLVER),
        "Postprocess": {"compute errors": True, "True solutions": zero},
    }


def add_cdr(cfg):
    """A p1 channel deck with cdr in the set: c = 1 on the left, diffusion
    0.01, advected by the flow (ux, uy[, uz]), reaction 0; NS forced by
    source ux 1 + 0.1 c^2 (the reference's
    Multiphysics/NavierStokes-CDR/Fully-Coupled couplings)."""
    phys = cfg["Physics"]
    phys["modules"] = "navier stokes,cdr"
    phys["Dirichlet conditions"]["c"] = {"left": 1.0}
    phys["Initial conditions"]["c"] = 0.0
    cfg["Discretization"]["order"]["c"] = 1
    cfg["Functions"].update({"source ux": "1.0 + 0.1*c^2",
                             "diffusion": "0.01", "xvel": "ux",
                             "yvel": "uy", "reaction": "0.0"})
    if cfg["Mesh"]["dimension"] == 3:
        cfg["Functions"]["zvel"] = "uz"
    cfg["Postprocess"]["True solutions"]["c"] = "0.0"
    return cfg


def ns_cdr_deck(nx):
    """The channel start-up (ns_startup_deck at nx x nx/4) with cdr in the
    set (add_cdr)."""
    return add_cdr(ns_startup_deck(nx))


def ns_visc_deck(nx):
    """The channel at nx x nx/4, PSPG, steady, direct, with the viscosity
    1 + 0.1 ux^2 (an NS coefficient that reads the state)."""
    cfg = ns_deck(nx, nx // 4, NS_DIRECT)
    cfg["Functions"]["viscosity"] = "1.0 + 0.1*ux*ux"
    return cfg


# the Boussinesq deck's reference: the JAX package's max |ux| at beta = 1
# (f64, CPU; tools/jax_references.py boussinesq_gold_nx8; 8.3e-18 at
# beta = 0)
BOUSSINESQ_MAXU = 0.0037584716736223547
# name -> (deck function of n, n on the card, rtol, {held time: the JAX
# package's f64 CPU L2 per variable}), as NS_ELEM_DECKS; every assembly
# of these decks is one set_node_full launch. The cavity's pressure is
# determined up to a constant (no-slip on every wall), which each
# package's Krylov solves pick: its L2 is no check.
SET_DECKS = {
    # 16,900 DOFs, 1 step (CAVITY_SOLVER), 26 s of JAX CPU solve; cut in
    # PR 21 from 128^2 (66,564 DOFs; 11.9 s on the card, where Newton ran
    # to its cap of 10 with every GMRES solve at its 2,000 cap in both
    # packages) for the script's time; here the stages converge (4 Newton
    # steps, 4,411 GMRES iterations on the CPU) and the packages agree to
    # 2e-16 on the CPU
    "boussinesq_cavity_startup_nx64": (
        cavity_deck, 64, 1e-6,
        {0.01: {"ux": 0.21035198500862695, "uy": 0.339908966048016,
                "e": 0.23604467525209932}}),
    # 66,820 DOFs; 316 s of JAX CPU solve. Each stage's Newton solve
    # meets its TOL in two steps, but every GMRES solve stops at its
    # 2,000 cap, and L2(pr), the least determined field, agrees to 6e-5
    # (ux, uy and c to 2e-9): rtol 1e-4
    "ns_cdr_startup_nx256": (
        ns_cdr_deck, 256, 1e-4,
        {0.02: {"ux": 0.16742995154868626, "uy": 4.618762002178137e-06,
                "pr": 0.0007769102912303964, "c": 0.10692664402300237}}),
    # 12,771 DOFs; 34 s of JAX CPU solve
    "ns_channel_visc_nonlinear_direct_nx128": (
        ns_visc_deck, 128, 1e-6,
        {0.0: {"ux": 0.00025861804009831747, "uy": 1.2241599309508333e-05,
               "pr": 0.0028695719608056725}}),
}


def thermal_cdr_deck(n, mesh="p1"):
    """thermal + cdr on n x n p1 (or p2, quadrature 4) quads, steady:
    kappa = 1 + e c (the set's density reads both variables), cdr
    advected by (2, 1)."""
    cfg = deck(n, kappa="1.0 + e*c", solver={"nonlinear TOL": 1e-10})
    cfg["Physics"]["modules"] = "thermal,cdr"
    cfg["Physics"]["Dirichlet conditions"]["c"] = {"all boundaries": 0.0}
    cfg["Discretization"]["order"]["c"] = 1
    if mesh == "p2":
        cfg["Discretization"] = {"order": {"e": 2, "c": 2}, "quadrature": 4}
    cfg["Functions"].update({"source": CDR_SOURCE, "xvel": "2.0",
                             "yvel": "1.0", "reaction": "0.0"})
    cfg["Postprocess"]["True solutions"]["c"] = S_TRUE
    return cfg


def cdr_state_velocity_deck(n):
    """cdr on n x n p1 quads, steady, with the velocity (c, 1): a
    coefficient that reads the state."""
    return cdr_deck(n, vel=("c", "1.0"))


# phase 3f: name -> (deck function of n, box, stage alphas or None, time
# step); each case's weak form and row classes come from its deck at 4 x
# 4, its element size from the shape
SET_KERNEL_CASES = {
    "ns+thermal pspg steady": (lambda n: boussinesq_deck(n), (1.0, 1.0),
                               None, 1.0),
    "ns+thermal advected pspg+supg dirk22 stage 1": (
        cavity_deck, (1.0, 1.0), NS_STAGE1, 0.01),
    "ns+cdr velocity (ux, uy), source 1 + 0.1 c^2, dirk22 stage 1": (
        ns_cdr_deck, (5.0, 1.0), NS_STAGE1, 0.01),
    "thermal+cdr kappa = 1 + e*c steady": (thermal_cdr_deck, (1.0, 1.0),
                                           None, 1.0),
    "cdr velocity (c, 1) steady": (cdr_state_velocity_deck, (1.0, 1.0),
                                   None, 1.0),
}
SET_SHAPES = ((1024, 256), (1000, 243))


def set_case(name, h):
    """(SetForm at element size h, SetScalars, jac_idx, Stage or None) of
    a phase 3f case, from its deck at 4 x 4 on the CPU."""
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    from mrhyde_tpu_torch.ops.fused_set import SetForm, SetScalars
    from mrhyde_tpu_torch.problem import Problem
    build, _box, alphas, dt = SET_KERNEL_CASES[name]
    fused = Problem(build(4), device="cpu", dtype=torch.float64) \
        .assembler.fused_provider()
    f = fused.form
    form = SetForm(f.modules, f.fm, f.variables, f.params, h, f.transient)
    sc = SetScalars(0.0125, dt, ())
    au, at = alphas or (1.0, 0.0)
    jac_idx = fused._classify(sc, au, at, alphas is None)[0]
    return form, sc, jac_idx, None if alphas is None else Stage(au, at,
                                                                None)


def set_inputs(nv, dims, lat, device, dtype, gen, stage):
    """Seeded u_eval (and, at a stage, u_dot) grids of nv variables on an
    element grid of `dims` read through lattice `lat`."""
    shape = (nv,) + tuple(lat.stride * n + 1 for n in dims)
    ue = torch.rand(shape, generator=gen, device=device, dtype=dtype) - 0.5
    if stage is None:
        return ue.contiguous(), None
    ud = torch.rand(shape, generator=gen, device=device, dtype=dtype) - 0.5
    return ue.contiguous(), (200.0 * ud).contiguous()


def phase_set_kernels(device, shapes=SET_SHAPES):
    """set_node_full (each case's generated kernel) against its plain
    version (residual and rows each within rtol of its max |plain|),
    with CUDA-event medians of 20 (kernel), the plain version's one check
    call and the bound of each case."""
    import math
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops.fused_p1 import QUAD_P1
    summary = None
    for name, (_build, box, _alphas, _dt) in SET_KERNEL_CASES.items():
        for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            for i, (N0, N1) in enumerate(shapes):
                gen = torch.Generator(device=device).manual_seed(4321)
                tab, ip0 = quad_tables(N0, N1, device, dtype, *box)
                form, sc, jac_idx, stage = set_case(
                    name, math.sqrt(sum(tab.wts)))
                geo = ((0.0, 0.0), (box[0] / N0, box[1] / N1), ip0)
                ue, ud = set_inputs(len(form.variables), (N0, N1),
                                    QUAD_P1, device, dtype, gen, stage)
                args = (form, ue, ud, sc, tab, geo, jac_idx, stage)
                ref, plain_ms = timed(lambda: fs.set_node_full_plain(*args))
                out = fs.set_node_full(*args)
                torch.cuda.synchronize()
                errs = [max_err(o, r) for o, r in zip(out, ref)]
                err = max(e for e, _ in errs)
                ok = all(e <= rtol * sc_ for e, sc_ in errs)
                nbytes, nflops = set_work(N0, N1, dtype, *args)
                rec = {"phase": "kernels_set", "kernel": "set_node_full",
                       "case": name, "dtype": str(dtype).replace(
                           "torch.", ""), "shape": [N0, N1],
                       "variables": list(form.variables),
                       "jac_rows": len(jac_idx), "max_abs_err": err,
                       "max_abs_err_res": errs[0][0],
                       "max_abs_plain_res": errs[0][1],
                       "max_abs_err_jac": errs[1][0],
                       "max_abs_plain_jac": errs[1][1], "rtol": rtol,
                       "ok": ok,
                       "ms": cuda_ms(lambda: fs.set_node_full(*args)),
                       "plain_ms": plain_ms,
                       **bound(nbytes, nflops, dtype)}
                rec["share"] = rec["bound_ms"] / rec["ms"]
                emit(rec)
                if not ok:
                    raise SystemExit(f"set_node_full {name} disagrees with "
                                     f"its plain version: {rec}")
                if dtype == torch.float64 and i == 0 and summary is None:
                    summary = rec
    return summary


def ns_rows(pspg, supg, transient, visc_varies, mesh="p1",
            quadrature=None):
    """The provider's row classification (jac_idx) of a channel call with
    these switches on p1 quads, hex or p2 quads (at another quadrature
    where given), from a small deck's probe on the CPU."""
    from mrhyde_tpu_torch.ops.fused_ns import NSForm
    from mrhyde_tpu_torch.problem import Problem
    solver = {"solver": "transient"} if transient else {}
    cfg = ns_deck(4, 1, solver, supg) if mesh == "p1" \
        else ns_elem_deck(mesh, 4, solver, supg)
    if quadrature is not None:
        cfg = with_quadrature(cfg, quadrature)
    cfg["Physics"]["usePSPG"] = pspg
    if visc_varies:
        cfg["Functions"]["viscosity"] = "0.1 + 0.01*x"
    fused = Problem(cfg, device="cpu", dtype=torch.float64) \
        .assembler.fused_provider()
    coeffs = (1.0, torch.zeros((1, 1)) if visc_varies else 1.0, 1.0) \
        + (0.0,) * (fused.dim - 1)
    form = NSForm(pspg, supg, 1.0, 0.01 if transient else 1.0, transient)
    au, at = NS_STAGE1 if transient else (1.0, 0.0)
    return fused._classify(coeffs, form, au, at, not transient)[0]


def ns_inputs(N0, N1, tab, q_off, device, dtype, gen):
    """Seeded u_eval and u_dot grids (3, N0+1, N1+1) of the channel, and
    the viscosity 0.1 + 0.01 x at the quadrature points, (E, Q)."""
    ue, ud = ((torch.rand((3, N0 + 1, N1 + 1), generator=gen, device=device,
                          dtype=dtype) - 0.5) for _ in range(2))
    ii = torch.arange(N0, device=device, dtype=dtype)[:, None, None]
    qx = torch.as_tensor(q_off[:, 0], device=device, dtype=dtype)
    x = (ii * (5.0 / N0) + qx).expand(N0, N1, tab.Q)
    visc = (0.1 + 0.01 * x).reshape(-1, tab.Q).contiguous()
    return ue.contiguous(), (200.0 * ud).contiguous(), visc


NS_SHAPES = ((1024, 256), (1000, 243))


def phase_ns_kernels(device):
    """ns_node_full against its plain version (residual and rows each
    within rtol of its max |plain|), with CUDA-event medians of 20
    (kernel), the plain version's one check call and the bound of each
    case."""
    import math
    from mrhyde_tpu_torch.ops import fused_ns as fn
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    rows = {"steady": ns_rows(True, False, False, False),
            "steady_x": ns_rows(True, False, False, True),
            "stage": ns_rows(True, True, True, False)}
    summary = None
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for N0, N1 in NS_SHAPES:
            gen = torch.Generator(device=device).manual_seed(4321)
            tab, ip0 = quad_tables(N0, N1, device, dtype, 5.0, 1.0)
            h = math.sqrt(sum(tab.wts))
            ue, ud, visc = ns_inputs(N0, N1, tab, ip0, device, dtype, gen)
            steady = fn.NSForm(True, False, h, 1.0, False)
            stage = fn.NSForm(True, True, h, 0.01, True)
            st1 = Stage(*NS_STAGE1, None)
            cases = [
                ("pspg steady nu=1.0", (ue, None, (1.0, 1.0, 1.0, 0.0), tab,
                                        steady, rows["steady"])),
                ("pspg steady nu=0.1+0.01x",
                 (ue, None, (1.0, visc, 1.0, 0.0), tab, steady,
                  rows["steady_x"])),
                ("pspg+supg dirk22 stage 1",
                 (ue, ud, (1.0, 1.0, 1.0, 0.0), tab, stage, rows["stage"],
                  st1)),
            ]
            for label, args in cases:
                ref, plain_ms = timed(lambda: fn.ns_node_full_plain(*args))
                out = fn.ns_node_full(*args)
                torch.cuda.synchronize()
                errs = [max_err(o, r) for o, r in zip(out, ref)]
                err = max(e for e, _ in errs)
                ok = all(e <= rtol * sc for e, sc in errs)
                nbytes, nflops = ns_work(N0, N1, tab.Q, dtype, args)
                rec = {"phase": "kernels", "kernel": "ns_node_full",
                       "case": label, "dtype": str(dtype).replace(
                           "torch.", ""), "shape": [N0, N1],
                       "jac_rows": len(args[5]), "max_abs_err": err,
                       "max_abs_err_res": errs[0][0],
                       "max_abs_plain_res": errs[0][1],
                       "max_abs_err_jac": errs[1][0],
                       "max_abs_plain_jac": errs[1][1], "rtol": rtol,
                       "ok": ok, "ms": cuda_ms(lambda: fn.ns_node_full(*args)),
                       "plain_ms": plain_ms,
                       **bound(nbytes, nflops, dtype)}
                emit(rec)
                if not ok:
                    raise SystemExit(f"ns_node_full {label} disagrees with "
                                     f"its plain version: {rec}")
                if dtype == torch.float64 and (N0, N1) == NS_SHAPES[0] \
                        and label == "pspg+supg dirk22 stage 1":
                    summary = rec
    return summary


# ----------------------------------------------------------------------
# 3D hex (p1) and 2D p2 quads: the element kernels (B1)
# ----------------------------------------------------------------------

# the reference's thermal/3D_verification: u = S3 on the unit cube
S3_TRUE = "sin(2*pi*x)*sin(2*pi*y)*sin(2*pi*z)"
SOURCE3 = f"12*(pi*pi)*{S3_TRUE}"
GRAD3_SQ = ("(cos(2*pi*x)*sin(2*pi*y)*sin(2*pi*z))^2"
            "+(sin(2*pi*x)*cos(2*pi*y)*sin(2*pi*z))^2"
            "+(sin(2*pi*x)*sin(2*pi*y)*cos(2*pi*z))^2")
# -div((1 + u^2) grad u) for u = S3
SOURCE3_NL = (f"12*(pi*pi)*{S3_TRUE}*(1+({S3_TRUE})^2) - 8*(pi*pi)*"
              f"{S3_TRUE}*({GRAD3_SQ})")
SOURCE3_T = f"(12*(pi*pi)*sin(2*pi*t)+2*pi*cos(2*pi*t))*{S3_TRUE}"
# u_t - div((1 + u^2) grad u) for u = T S3, substituted as text
SOURCE3_T_NL = (
    "2*pi*cos(2*pi*t)*S + 12*(pi*pi)*T*S*(1+(T*S)^2) - 8*(pi*pi)*T*T*T*S*"
    "(G)").replace("G", GRAD3_SQ).replace("S", S3_TRUE).replace("T", T_TIME)
# the JAX package's f64 CPU L2 of the B1 decks (ROADMAP's reference
# tables): hex at 32^3 (35,937 DOFs; tools/jax_references.py, set-up /
# solve s on the CPU: 4.5 / 5.0, 3.9 / 12.4, 4.7 / 11.4, 4.1 / 42.0, 4.5 /
# 8.5, 4.6 / 12.0); p2 at 256^2 and 128^2 (their error falls 8.0x per
# halving of h from 64^2, so it is no solver noise)
HEX_L2_32 = {"default": 0.0011361342397550054,
             "nonlinear": 0.0011364671465841482,
             "dirk22": 6.107586383239649e-05,
             "bdf2_nonlinear": 0.0013206434845336704,
             "cdr": 0.001129821797273883,
             "cdr_nonlinear": 0.0011299338099397037}
P2_DEFAULT_L2 = 5.029830565509573e-08
P2_NL_L2 = 4.023729085365165e-07
BDF2_SOLVER = {"transient Butcher tableau": "BWE", "transient BDF order": 2,
               "transient startup Butcher tableau": "BWE",
               "transient startup BDF order": 1,
               "transient startup steps": 1, "final time": 0.2,
               "number of steps": 4, "nonlinear TOL": 1e-10,
               "Belos solver": "CG"}


def hex_deck(n, kappa="1.0", source=SOURCE3, solver=None):
    """thermal/3D_verification on an n^3 hex mesh (Dirichlet 0)."""
    cfg = deck(n, kappa, source, solver)
    cfg["Mesh"].update({"dimension": 3, "element type": "hex", "NZ": n})
    cfg["Postprocess"]["True solutions"] = {"e": S3_TRUE}
    return cfg


def hex_transient_deck(n, solver, kappa="1.0", source=SOURCE3_T):
    """The 3D analogue of the 2D transient deck: IC 0, u = T S3."""
    cfg = hex_deck(n, kappa, source, dict({"solver": "transient"}, **solver))
    cfg["Physics"]["Initial conditions"] = {"e": "0.0"}
    cfg["Postprocess"]["True solutions"] = {"e": f"{T_TIME}*{S3_TRUE}"}
    return cfg


def p2_deck(n, kappa="1.0", source=SOURCE, solver=None):
    """The 2D deck with p2 variables, quadrature 4."""
    cfg = deck(n, kappa, source, solver)
    cfg["Discretization"] = {"order": {"e": 2}, "quadrature": 4}
    return cfg


# ----------------------------------------------------------------------
# convection-diffusion-reaction (cdr) and thermal with advection: the
# scalar advection-diffusion-reaction weak form on B2 (2D p1) and B1 (hex,
# p2), u = S (steady) or T S (transient), Dirichlet 0
# ----------------------------------------------------------------------

SX = "2*pi*cos(2*pi*x)*sin(2*pi*y)"
SY = "2*pi*sin(2*pi*x)*cos(2*pi*y)"
S3X = "2*pi*cos(2*pi*x)*sin(2*pi*y)*sin(2*pi*z)"
S3Y = "2*pi*sin(2*pi*x)*cos(2*pi*y)*sin(2*pi*z)"
S3Z = "2*pi*sin(2*pi*x)*sin(2*pi*y)*cos(2*pi*z)"
# -div grad S + (2, 1) . grad S, and 0.5 S^2 for the reaction 0.5*c*c
CDR_SOURCE = f"8*(pi*pi)*{S_TRUE} + 2.0*{SX} + 1.0*{SY}"
CDR_SOURCE_NL = f"{CDR_SOURCE} + 0.5*{S_TRUE}*{S_TRUE}"
CDR3_SOURCE = (f"12*(pi*pi)*{S3_TRUE} + 2.0*{S3X} + 1.0*{S3Y} "
               f"+ 0.5*{S3Z}")
CDR3_SOURCE_NL = f"{CDR3_SOURCE} + 0.5*{S3_TRUE}*{S3_TRUE}"
# the rotating field about the square's centre, and c_t + b . grad c -
# 0.5 div grad c for c = T S (density 2: kappa = D / (rho cp) = 0.5)
ROT_V = ("-4.0*(y-0.5)", "4.0*(x-0.5)")
CDR_ROT_SOURCE = (f"2*pi*cos(2*pi*t)*{S_TRUE} + {T_TIME}*(4*(pi*pi)*"
                  f"{S_TRUE} + ({ROT_V[0]})*{SX} + ({ROT_V[1]})*{SY})")


def cdr_gold_deck():
    """The reference's cdr/2D_manufactured (tests/test_cdr_burgers.py:
    14-32): 40^2, v = (2, 1), reaction 0.5 c^2, direct."""
    return {
        "Mesh": {"dimension": 2, "shape": "quad", "NX": 40, "NY": 40},
        "Functions": {
            "source": "(8*(pi*pi)+0.5*sin(2*pi*x)*sin(2*pi*y))"
                      "*sin(2*pi*x)*sin(2*pi*y)"
                      " + 2.0*2*pi*cos(2*pi*x)*sin(2*pi*y)"
                      " + 1.0*2*pi*sin(2*pi*x)*cos(2*pi*y)",
            "xvel": "2.0", "yvel": "1.0",
            "reaction": "0.5*c*c", "SUPG tau": "0.0",
        },
        "Physics": {"modules": "cdr",
                    "Dirichlet conditions": {"c": {"all boundaries": "0.0"}},
                    "Initial conditions": {"c": "0.0"}},
        "Discretization": {"order": {"c": 1}, "quadrature": 2},
        "Solver": {"solver": "steady-state", "nonlinear TOL": 1e-7,
                   "max nonlinear iters": 4},
        "Postprocess": {"compute errors": True,
                        "True solutions": {"c": S_TRUE}},
    }


def cdr_deck(n, source=CDR_SOURCE, reaction="0.0", vel=("2.0", "1.0"),
             mesh="p1", solver=None):
    """A steady cdr deck: n^2 p1 quads, n^3 hex (three velocity
    components) or n^2 p2 quads (quadrature 4); nonlinear TOL 1e-10."""
    dim = 3 if mesh == "hex" else 2
    fs = {"source": source, "reaction": reaction}
    fs.update(zip(("xvel", "yvel", "zvel"), vel))
    cfg = {
        "Mesh": {"dimension": dim, "element type": "hex" if dim == 3
                 else "quad", "NX": n, "NY": n},
        "Functions": fs,
        "Physics": {"modules": "cdr",
                    "Dirichlet conditions": {"c": {"all boundaries": 0.0}}},
        "Discretization": {"order": {"c": 2 if mesh == "p2" else 1},
                           "quadrature": 4 if mesh == "p2" else 2},
        "Solver": dict({"solver": "steady-state", "nonlinear TOL": 1e-10},
                       **(solver or {})),
        "Postprocess": {"compute errors": True,
                        "True solutions": {"c": S3_TRUE if dim == 3
                                           else S_TRUE}},
    }
    if dim == 3:
        cfg["Mesh"]["NZ"] = n
    return cfg


def cdr_rotating_deck(n):
    """c = T S in the rotating field, density 2, IC 0, DIRK-2,2, 4 steps
    of 0.05 to t = 0.2 (8 to t = 0.4 before the boundary and affine-set
    decks came in)."""
    cfg = cdr_deck(n, CDR_ROT_SOURCE, vel=ROT_V, solver={
        "solver": "transient", "transient Butcher tableau": "DIRK-2,2",
        "final time": 0.2, "number of steps": 4})
    cfg["Functions"]["density"] = "2.0"
    cfg["Physics"]["Initial conditions"] = {"c": "0.0"}
    cfg["Postprocess"]["True solutions"] = {"c": f"{T_TIME}*{S_TRUE}"}
    return cfg


def thermal_advection_deck(n):
    """Thermal with 'include advection', b = (2, 1), kappa = 1."""
    cfg = deck(n, source=CDR_SOURCE, solver={"nonlinear TOL": 1e-10})
    cfg["Physics"]["include advection"] = True
    cfg["Functions"].update({"advection x": "2.0", "advection y": "1.0"})
    return cfg


# the source of c = S_TRUE with the reaction 2 c, linear in c: the affine
# split (JAX's _detect_affine) on thermal_node_state
CDR_SOURCE_AFFINE = f"{CDR_SOURCE} + 2.0*{S_TRUE}"


# name -> (deck builder of the mesh size, size on the card, time of the
# held L2, variable, kernel mode, the JAX package's f64 CPU L2 there).
# tools/jax_references.py runs the same builders through the JAX package
# for those references.
CDR_DECKS = {
    # a reaction linear in c: mode "state", the coord part plain torch
    "cdr_affine_reaction_nx256": (
        lambda n: cdr_deck(n, CDR_SOURCE_AFFINE, "2.0*c"), 256, 0.0, "c",
        "state", 2.4237378117849184e-05),
    # cut from 1024^2 (the JAX CPU reference ran over 20 minutes there),
    # then from 512^2 (with thermal_advection) when the boundary and
    # affine-set decks came in; 23 / 31 / 23 s of JAX CPU solve at 256^2
    "cdr_nx256": (cdr_deck, 256, 0.0, "c", "state",
                  2.484336406366297e-05),
    "cdr_nonlinear_nx256": (
        lambda n: cdr_deck(n, CDR_SOURCE_NL, "0.5*c*c"), 256, 0.0, "c",
        "full", 2.4837909950684728e-05),
    # 4 steps to t = 0.2 since the affine-set and boundary decks came in
    # (8 to t = 0.4 before); 348 s of JAX CPU solve
    "cdr_transient_rotating_nx512": (cdr_rotating_deck, 512, 0.2, "c",
                                     "state", 0.001394676944195696),
    "thermal_advection_nx256": (thermal_advection_deck, 256, 0.0, "e",
                                "state", 2.4843364063663086e-05),
    # cut from 64^3, then 48^3 and 40^3, for the script's time (HEX_L2_32)
    "cdr_hex_nx32": (
        lambda n: cdr_deck(n, CDR3_SOURCE, vel=("2.0", "1.0", "0.5"),
                           mesh="hex"), 32, 0.0, "c", "elem_state",
        HEX_L2_32["cdr"]),
    "cdr_hex_nonlinear_nx32": (
        lambda n: cdr_deck(n, CDR3_SOURCE_NL, "0.5*c*c",
                           ("2.0", "1.0", "0.5"), "hex"), 32, 0.0, "c",
        "elem_full", HEX_L2_32["cdr_nonlinear"]),
    # cut from 256^2 for the script's time (66,049 DOFs; its JAX CPU
    # set-up / solve: 1.3 / 21 s)
    "cdr_p2_nx128": (lambda n: cdr_deck(n, mesh="p2"), 128, 0.0, "c",
                     "elem_state", 4.023602960516559e-07),
    "cdr_p2_nonlinear_nx128": (
        lambda n: cdr_deck(n, CDR_SOURCE_NL, "0.5*c*c", mesh="p2"), 128,
        0.0, "c", "elem_full", 4.023603034380792e-07),
}


# the hex decks of kappa = 1, kappa = 1 + e*e, DIRK-2,2 and the nonlinear
# BDF2 as CDR_DECKS holds its decks, at 32^3: cut for the script's time
# (96^3, 80^3, 64^3, 48^3 and 40^3 before; 5-6 s of host set-up each at
# 40^3), with their JAX references at 32^3 (HEX_L2_32)
HEX_DECKS = {
    "hex_default_nx32": (
        lambda n: hex_deck(n, solver={"nonlinear TOL": 1e-10}), 32, 0.0,
        "e", "elem_state", HEX_L2_32["default"]),
    "hex_nonlinear_nx32": (
        lambda n: hex_deck(n, "1.0 + e*e", SOURCE3_NL,
                           {"nonlinear TOL": 1e-10, "Belos solver": "CG"}),
        32, 0.0, "e", "elem_full", HEX_L2_32["nonlinear"]),
    "hex_transient_dirk22_nx32": (
        lambda n: hex_transient_deck(n, {
            "transient Butcher tableau": "DIRK-2,2", "final time": 0.4,
            "number of steps": 8, "nonlinear TOL": 1e-10}),
        32, 0.4, "e", "elem_state", HEX_L2_32["dirk22"]),
    "hex_transient_nonlinear_bdf2_nx32": (
        lambda n: hex_transient_deck(n, BDF2_SOLVER, "1.0 + e*e",
                                     SOURCE3_T_NL),
        32, 0.2, "e", "elem_full", HEX_L2_32["bdf2_nonlinear"]),
}


ELEM_SHAPES = (("hex", (128, 128, 128)), ("hex", (127, 100, 77)),
               ("p2", (1024, 1024)), ("p2", (1000, 777)))


def elem_tables(mesh, dims, device, dtype, lengths=(1.0, 1.0, 1.0),
                quadrature=None):
    """(QuadTables, Lattice, qp offsets) of a uniform hex (p1, quadrature
    2) or quad (p2, quadrature 4) grid of `dims` elements on the box
    [0, lengths] (at another quadrature where given)."""
    import numpy as np
    from mrhyde_tpu_torch.assembly.discretization import Discretization
    from mrhyde_tpu_torch.mesh.structured import box_mesh
    from mrhyde_tpu_torch.ops.fused_elem import basis_lattice
    from mrhyde_tpu_torch.ops.fused_p1 import QuadTables
    cell, order, quad = ("hex", 1, 2) if mesh == "hex" else ("quad", 2, 4)
    quad = quadrature or quad
    size = dict(zip(("xmax", "ymax", "zmax"),
                    (a / n for a, n in zip(lengths, dims))))
    disc = Discretization(box_mesh(cell, **size), [("e", "HGRAD", order)],
                          quad)
    key = ("HGRAD", order)
    tab = QuadTables(disc.basis_vals[key], disc.basis_grads[key][0],
                     disc.wts[0], device, dtype)
    return tab, basis_lattice(cell, order), np.asarray(disc.ip[0])


def qp_xyz(dims, q_off, Q, device, dtype, lengths=(1.0, 1.0, 1.0)):
    """x, y[, z] at the quadrature points of a uniform grid of `dims`
    elements on the box [0, lengths], each (E, Q)."""
    import math
    dim, E = len(dims), math.prod(dims)
    xs = []
    for a in range(dim):
        view = [1] * dim + [Q]
        view[a] = dims[a]
        idx = torch.arange(dims[a], device=device, dtype=dtype)
        off = torch.as_tensor(q_off[:, a], device=device, dtype=dtype)
        xs.append((idx.reshape(view[:dim] + [1]) * lengths[a] / dims[a]
                   + off.reshape([1] * dim + [Q]))
                  .expand(*dims, Q).reshape(E, Q))
    return xs


def elem_inputs(dims, tab, lat, q_off, device, dtype, gen):
    """Seeded random grids u, beta_u, beta_t; per-qp (E, Q) kappa = 1 +
    0.5 x y (z) and m = 1 + 0.5 x; for kappa = 1 + e*e with its
    manufactured source f the tensors S, a seeded dS/de, K, dK/de at u
    (steady)
    and at u_eval = alpha_u u + beta_u, u_dot = alpha_t u + beta_t with m
    (S = m u_dot - f; DIRK-2,2 stage-1 alphas). Returns (u, kxy, m,
    steady full inputs, (u_eval, transient full inputs))."""
    import math
    from mrhyde_tpu_torch.ops.fused_elem import corner_values
    shape = tuple(lat.stride * n + 1 for n in dims)
    u, bu, bt = (torch.rand(shape, generator=gen, device=device,
                            dtype=dtype) - 0.5 for _ in range(3))
    dim = len(dims)
    xs = qp_xyz(dims, q_off, tab.Q, device, dtype)
    kxy = (1.0 + 0.5 * math.prod(xs)).contiguous()
    mx = (1.0 + 0.5 * xs[0]).contiguous()
    sins = [torch.sin(2 * math.pi * x) for x in xs]
    s = math.prod(sins)
    g2 = sum((torch.cos(2 * math.pi * xs[a])
              * math.prod(sins[b] for b in range(dim) if b != a)) ** 2
             for a in range(dim))
    f = 4 * math.pi ** 2 * dim * s * (1 + s * s) - 8 * math.pi ** 2 * s * g2

    def at_qps(g):
        uc = corner_values(g, lat)
        return torch.stack([sum(tab.phi[c][q] * uc[c]
                                for c in range(tab.nc))
                            for q in range(tab.Q)], dim=-1)

    def full_inputs(uq, S):
        # dS/de is 0 for this source; a seeded one checks its column term
        dS = torch.rand(uq.shape, generator=gen, device=device,
                        dtype=dtype) - 0.5
        return [t.contiguous() for t in (S, dS, 1.0 + uq * uq, 2.0 * uq)]
    au, at = DIRK22_STAGE1
    ue = (au * u + bu).contiguous()
    ueq, udq = at_qps(ue), at_qps(at * u + bt)
    return (u, kxy, mx, full_inputs(at_qps(u), -f),
            (ue, full_inputs(ueq, mx * udq - f)))


def phase_elem_kernels(device):
    """thermal_elem_state and thermal_elem_full against their plain
    versions (within rtol of max |plain|, rows and Jacobian rows each),
    hex and p2, f64 and f32, with CUDA-event medians of 20 (plain: its
    one check call) and the bound of each case."""
    from mrhyde_tpu_torch.ops import fused_elem as fe
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    summary = {}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for mesh, dims in ELEM_SHAPES:
            gen = torch.Generator(device=device).manual_seed(2468)
            tab, lat, q_off = elem_tables(mesh, dims, device, dtype)
            u, kxy, mx, full, (ue, tr) = elem_inputs(
                dims, tab, lat, q_off, device, dtype, gen)
            stx = Stage(*DIRK22_STAGE1, mx)
            xy = "xyz" if mesh == "hex" else "xy"
            work = (u, dims, tab, dtype)
            st1 = Stage(*DIRK22_STAGE1, 1.0)
            cases = [
                ("thermal_elem_state", "kappa=1.0", (u, 1.0, tab, lat),
                 elem_work("state", *work, 1.0, None)),
                ("thermal_elem_state", f"kappa=1+0.5{xy}",
                 (u, kxy, tab, lat), elem_work("state", *work, kxy, None)),
                # the decks' stage (hex_transient_dirk22_nx32)
                ("thermal_elem_state", "dirk22 kappa=1.0 m=1.0",
                 (u, 1.0, tab, lat, st1), elem_work("state", *work, 1.0,
                                                    st1)),
                ("thermal_elem_state", f"dirk22 kappa=1+0.5{xy} m=1+0.5x",
                 (u, kxy, tab, lat, stx), elem_work("state", *work, kxy,
                                                    stx)),
                ("thermal_elem_full", "kappa=1+e*e", (u, *full, tab, lat),
                 elem_work("full", *work, None, None, full)),
                ("thermal_elem_full", "dirk22 kappa=1+e*e m=1+0.5x",
                 (ue, *tr, tab, lat, stx), elem_work("full", *work, None,
                                                     stx, tr)),
            ]
            for name, label, args, (nbytes, nflops) in cases:
                kern = getattr(fe, name)
                plain = getattr(fe, name + "_plain")
                ref, plain_ms = timed(lambda: plain(*args))
                out = kern(*args)
                torch.cuda.synchronize()
                pairs = [max_err(o, r) for o, r in
                         (zip(out, ref) if isinstance(ref, tuple)
                          else [(out, ref)])]
                err = max(e for e, _ in pairs)
                ok = all(e <= rtol * sc for e, sc in pairs)
                rec = {"phase": "kernels", "kernel": name, "case": label,
                       "mesh": mesh, "dtype": str(dtype).replace(
                           "torch.", ""), "shape": list(dims),
                       "max_abs_err": err,
                       "max_abs_plain": max(sc for _, sc in pairs),
                       "rtol": rtol, "ok": ok,
                       "ms": cuda_ms(lambda: kern(*args)),
                       "plain_ms": plain_ms,
                       **bound(nbytes, nflops, dtype)}
                emit(rec)
                if not ok:
                    raise SystemExit(f"{name} {label} disagrees with its "
                                     f"plain version: {rec}")
                # the summary line quotes the f64 128^3 hex transient
                # cases with kappa and m per qp, and lists every f64 case
                # of thermal_elem_state at the divisible shapes
                if dtype == torch.float64 and (mesh, dims) \
                        == ELEM_SHAPES[0] and label.startswith("dirk22") \
                        and "m=1+0.5x" in label:
                    summary[name] = rec
                if dtype == torch.float64 and name == "thermal_elem_state" \
                        and (mesh, dims) in (ELEM_SHAPES[0], ELEM_SHAPES[2]):
                    summary.setdefault("thermal_elem_state cases",
                                       []).append(rec)
    return summary


# the B1 Navier-Stokes kernel on the channel [0,5]x[0,1](x[0,1])
# the non-divisible shapes are cut from 61x47x29 and 500x121 (PR 6) for
# the script's time: the plain version takes 0.3-1.0 s a call there
NS_ELEM_SHAPES = (("hex", (64, 64, 64)), ("hex", (31, 23, 15)),
                  ("p2", (512, 128)), ("p2", (250, 61)))
CHANNEL = (5.0, 1.0, 1.0)


def ns_elem_inputs(mesh, dims, device, dtype, gen, quadrature=None):
    """(tables, lattice, h, seeded u_eval and u_dot grid stacks (dim + 1,
    *grid), the viscosity 0.1 + 0.01 x at the qps (E, Q)) of a hex or p2
    element grid of the channel (at another quadrature where given)."""
    import math
    tab, lat, q_off = elem_tables(mesh, dims, device, dtype, CHANNEL,
                                  quadrature)
    shape = (tab.dim + 1,) + tuple(lat.stride * n + 1 for n in dims)
    ue, ud = ((torch.rand(shape, generator=gen, device=device, dtype=dtype)
               - 0.5) for _ in range(2))
    x = qp_xyz(dims, q_off, tab.Q, device, dtype, CHANNEL)[0]
    visc = (0.1 + 0.01 * x).contiguous()
    h = math.fsum(tab.wts) ** (1.0 / tab.dim)
    return tab, lat, h, ue.contiguous(), (200.0 * ud).contiguous(), visc


def phase_ns_elem_kernels(device, shapes=NS_ELEM_SHAPES):
    """ns_elem_full against its plain version (residual and rows each
    within rtol of its max |plain|) on hex and p2, f64 and f32, with
    CUDA-event medians of 20 (kernel) and the bound of each case: PSPG
    steady with viscosity 1 and 0.1 + 0.01 x, PSPG+SUPG at
    DIRK-2,2 stage-1 alphas (0.5, 200) with seeded u_dot; each record
    gives the share of the bound the kernel reaches. The plain version's
    time is that of its one call, the check's (CUDA events). Returns the
    quoted case: f64, hex 64^3, the stage."""
    from mrhyde_tpu_torch.ops import fused_ns as fn
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    rows = {(mesh, key): ns_rows(True, key == "stage", key == "stage",
                                 key == "steady_x", mesh)
            for mesh in ("hex", "p2")
            for key in ("steady", "steady_x", "stage")}
    summary = None
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for mesh, dims in shapes:
            gen = torch.Generator(device=device).manual_seed(8642)
            tab, lat, h, ue, ud, visc = ns_elem_inputs(mesh, dims, device,
                                                       dtype, gen)
            src = (1.0,) + (0.0,) * (tab.dim - 1)
            steady = fn.NSForm(True, False, h, 1.0, False)
            stage = fn.NSForm(True, True, h, 0.01, True)
            st1 = Stage(*NS_STAGE1, None)
            cases = [
                ("pspg steady nu=1.0", (ue, None, (1.0, 1.0, *src), tab,
                                        lat, steady, rows[mesh, "steady"])),
                ("pspg steady nu=0.1+0.01x",
                 (ue, None, (1.0, visc, *src), tab, lat, steady,
                  rows[mesh, "steady_x"])),
                ("pspg+supg dirk22 stage 1",
                 (ue, ud, (1.0, 1.0, *src), tab, lat, stage,
                  rows[mesh, "stage"], st1)),
            ]
            for label, args in cases:
                ref, plain_ms = timed(lambda: fn.ns_elem_full_plain(*args))
                out = fn.ns_elem_full(*args)
                torch.cuda.synchronize()
                errs = [max_err(o, r) for o, r in zip(out, ref)]
                del out, ref
                err = max(e for e, _ in errs)
                ok = all(e <= rtol * sc for e, sc in errs)
                nbytes, nflops = ns_elem_work(dims, dtype, args)
                rec = {"phase": "kernels_ns_elem", "kernel": "ns_elem_full",
                       "case": label, "mesh": mesh,
                       "dtype": str(dtype).replace("torch.", ""),
                       "shape": list(dims), "jac_rows": len(args[6]),
                       "max_abs_err": err, "max_abs_err_res": errs[0][0],
                       "max_abs_plain_res": errs[0][1],
                       "max_abs_err_jac": errs[1][0],
                       "max_abs_plain_jac": errs[1][1], "rtol": rtol,
                       "ok": ok,
                       "ms": cuda_ms(lambda: fn.ns_elem_full(*args)),
                       "plain_ms": plain_ms,
                       **bound(nbytes, nflops, dtype)}
                rec["share"] = rec["bound_ms"] / rec["ms"]
                emit(rec)
                if not ok:
                    raise SystemExit(f"ns_elem_full {label} disagrees with "
                                     f"its plain version: {rec}")
                if dtype == torch.float64 and (mesh, dims) == shapes[0] \
                        and label == "pspg+supg dirk22 stage 1":
                    summary = rec
    return summary


# ----------------------------------------------------------------------
# module sets and state-reading coefficients on 3D hex and 2D p2 quads:
# the element-tile kernel B1 through the generated set_elem_full
# ----------------------------------------------------------------------

def ns_thermal_channel_deck(mesh, nx):
    """Mixed convection in the channel (ns_elem_deck: hex nx x nx/4 x
    nx/4 or p2 nx x nx/4, PSPG, steady, direct): NS + thermal with the
    Boussinesq term (beta 1, T_ambient 0, source uy -1) and the flow's
    source ux 1; thermal advected by (ux, uy[, uz]), e = 1 on the bottom
    and 0 on the top wall (true e = 1 - y)."""
    cfg = ns_elem_deck(mesh, nx, NS_DIRECT)
    phys = cfg["Physics"]
    phys.update({"modules": "navier stokes,thermal", "beta": 1.0,
                 "T_ambient": 0.0, "include advection": True})
    phys["Dirichlet conditions"]["e"] = {"bottom": 1.0, "top": 0.0}
    phys["Initial conditions"]["e"] = 0.0
    cfg["Discretization"]["order"]["e"] = 2 if mesh == "p2" else 1
    cfg["Functions"].update({"source ux": "1.0", "source uy": "-1.0",
                             "advection x": "ux", "advection y": "uy"})
    if mesh == "hex":
        cfg["Functions"]["advection z"] = "uz"
    cfg["Postprocess"]["True solutions"]["e"] = "1.0-y"
    return cfg


def ns_elem_visc_deck(nx):
    """The hex channel (ns_elem_deck, PSPG, steady, direct) with the
    viscosity 1 + 0.1 ux^2."""
    cfg = ns_elem_deck("hex", nx, NS_DIRECT)
    cfg["Functions"]["viscosity"] = "1.0 + 0.1*ux*ux"
    return cfg


# name -> (deck function of n, n on the card, rtol, {held time: the JAX
# package's f64 CPU L2 per variable}), as SET_DECKS; every assembly of
# these decks is one set_elem_full launch. tools/jax_references.py runs
# the same deck functions through the JAX package for those references.
SET_ELEM_DECKS = {
    # the full-width deck: the hex start-up of NS_ELEM_DECKS with cdr in
    # the set, 64x16x16 (93,925 DOFs, 16,384 elements, nd = 40); 165 s of
    # JAX CPU solve
    "ns3d_cdr_startup_dirk22_nx64": (
        lambda n: add_cdr(ns_elem_startup_deck("hex", n)), 64, 1e-6,
        {0.02: {"ux": 0.16742864601145643, "uy": 8.380799346010581e-05,
                "pr": 0.006630702844891716, "uz": 4.2494223866583694e-05,
                "c": 0.1657996392173004}}),
    # mixed convection, 20x5x5 hex (3,780 DOFs, nd = 40); 6.3 s
    "ns3d_thermal_channel_direct_nx20": (
        lambda n: ns_thermal_channel_deck("hex", n), 20, 1e-6,
        {0.0: {"ux": 0.10599156192928649, "uy": 0.015255381043264049,
               "pr": 0.29369837310744434, "uz": 0.012059791939267333,
               "e": 0.0014663276774370387}}),
    # the same on 64x16 p2 quads (17,028 DOFs, nd = 36); 115 s
    "p2ns_thermal_channel_direct_nx64": (
        lambda n: ns_thermal_channel_deck("p2", n), 64, 1e-6,
        {0.0: {"ux": 0.1030206482202709, "uy": 0.006632863120563855,
               "pr": 0.32817749457768447, "e": 0.0005212417638041555}}),
    # viscosity 1 + 0.1 ux^2, 20x5x5 hex (3,024 DOFs, nd = 32); 5.0 s
    "ns3d_channel_visc_nonlinear_direct_nx20": (
        ns_elem_visc_deck, 20, 1e-6,
        {0.0: {"ux": 0.007999975536123395, "uy": 0.000793521893887483,
               "pr": 0.042929445662579405, "uz": 0.00296556133492944}}),
    # thermal + cdr, kappa = 1 + e c, p2 128^2 (132,098 DOFs, nd = 18);
    # 111 s
    "thermal_cdr_p2_nx128": (
        lambda n: thermal_cdr_deck(n, "p2"), 128, 1e-6,
        {0.0: {"e": 0.0683409929255726, "c": 4.023602960223766e-07}}),
    # cdr with the velocity (c, 1, 0.5), hex 32^3 (35,937 DOFs, nd = 8;
    # 48^3 until the boundary and affine-set decks came in); 10 s
    "cdr_hex_state_velocity_nx32": (
        lambda n: cdr_deck(n, CDR3_SOURCE, vel=("c", "1.0", "0.5"),
                           mesh="hex"), 32, 1e-6,
        {0.0: {"c": 0.029737103155455098}}),
}


# ----------------------------------------------------------------------
# boundary terms (Neumann, Flux, weak Dirichlet) on the fused kernels,
# affine module sets through mode "state" (set_node_state,
# set_elem_state), and the set and NS element kernels at any quadrature
# ----------------------------------------------------------------------

# d S / dy, the outward flux of S on the top wall (y = 1) and minus it on
# the bottom (y = 0); the same of S3 in 3D
NEUMANN_TOP = "2*pi*sin(2*pi*x)*cos(2*pi*y)"
NEUMANN3_TOP = "2*pi*sin(2*pi*x)*cos(2*pi*y)*sin(2*pi*z)"


def mixed_neumann_deck(n, solver=None):
    """The JAX package's test_mixed_dirichlet_neumann deck
    (tests/test_thermal_family.py:115-127) at n^2: thermal, e = 0 on the
    left and right, the Neumann flux of S on the top and bottom, steady,
    nonlinear TOL 1e-7, 4 Newton steps at most (the solver keys of
    `solver` on top)."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Functions": {"thermal source": "8*pi*pi*sin(2*pi*x)*sin(2*pi*y)"},
        "Physics": {"modules": "thermal",
                    "Dirichlet conditions": {"e": {"left": "0.0",
                                                   "right": "0.0"}},
                    "Neumann conditions": {
                        "e": {"top": NEUMANN_TOP,
                              "bottom": f"-{NEUMANN_TOP}"}},
                    "Initial conditions": {"e": "0.0"}},
        "Discretization": {"order": {"e": 1}, "quadrature": 2},
        "Solver": dict({"solver": "steady-state", "nonlinear TOL": 1e-7,
                        "max nonlinear iters": 4}, **(solver or {})),
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e": S_TRUE}},
    }


def weak_dirichlet_deck(n):
    """kappa = 1 + e*e with its manufactured source (nonlinear_deck),
    Dirichlet 0 imposed weakly ('use weak Dirichlet': Nitsche's terms of
    thermal's boundary residual), the default solver. Thermal's weak
    Dirichlet term reads the data as the function 'Dirichlet e <side>',
    in both packages, which the Functions list defines (the condition's
    own value is registered as 'weak Dirichlet e <side>' and unread)."""
    cfg = deck(n, "1.0 + e*e", SOURCE_NL, {"nonlinear TOL": 1e-10})
    cfg["Physics"]["use weak Dirichlet"] = True
    cfg["Functions"].update({f"Dirichlet e {s}": "0.0"
                             for s in ("left", "right", "bottom", "top")})
    return cfg


def hex_neumann_deck(n):
    """The 3D manufactured deck (hex_deck) with the Neumann flux of S3 on
    the top and bottom faces (y = 1, 0) and e = 0 on the other four."""
    cfg = hex_deck(n, solver={"nonlinear TOL": 1e-10})
    cfg["Physics"]["Dirichlet conditions"] = {"e": {
        s: 0.0 for s in ("left", "right", "front", "back")}}
    cfg["Physics"]["Neumann conditions"] = {
        "e": {"top": NEUMANN3_TOP, "bottom": f"-{NEUMANN3_TOP}"}}
    return cfg


def thermal_cdr_affine_deck(n, mesh="p1", transient=False, kappa=None):
    """thermal + cdr with constant coefficients (an affine set: JAX's
    split path, mode "state"), steady, on n^2 p1 quads, n^3 hex or n^2 p2
    quads (quadrature 4): both fields have the true solution S (S3), cdr
    is advected by (2, 1[, 0.5]) with reaction 0; each field is 0 on the
    left, right and bottom (hex: front and back too), and its flux enters
    on the top wall: a Neumann condition on e, a Flux condition on c.
    `transient`: u = T S from IC 0, DIRK-2,2, 4 steps of 0.05 to t = 0.2,
    the fluxes T times the steady ones. `kappa`: the thermal diffusion's
    expression instead of 1 (one that reads the coordinates keeps the
    set affine, its state part varying by element; the true solutions
    then no longer hold, so such a deck only feeds phase 3h)."""
    dim = 3 if mesh == "hex" else 2
    true = S3_TRUE if dim == 3 else S_TRUE
    flux = NEUMANN3_TOP if dim == 3 else NEUMANN_TOP
    src_e = SOURCE3 if dim == 3 else SOURCE
    src_c = CDR3_SOURCE if dim == 3 else CDR_SOURCE
    if transient:
        src_e = f"2*pi*cos(2*pi*t)*{true} + {T_TIME}*({src_e})"
        src_c = f"2*pi*cos(2*pi*t)*{true} + {T_TIME}*({src_c})"
        true, flux = f"{T_TIME}*{true}", f"{T_TIME}*{flux}"
    walls = ["left", "right", "bottom"] + (["front", "back"] if dim == 3
                                           else [])
    order = 2 if mesh == "p2" else 1
    solver = {"solver": "steady-state", "nonlinear TOL": 1e-10}
    if transient:
        solver.update({"solver": "transient",
                       "transient Butcher tableau": "DIRK-2,2",
                       "final time": 0.2, "number of steps": 4})
    cfg = {
        "Mesh": {"dimension": dim, "element type": "hex" if dim == 3
                 else "quad", "NX": n, "NY": n},
        "Functions": {"thermal source": src_e, "source": src_c,
                      "xvel": "2.0", "yvel": "1.0", "reaction": "0.0"},
        "Physics": {"modules": "thermal,cdr",
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "e": {s: 0.0 for s in walls},
                        "c": {s: 0.0 for s in walls}},
                    "Neumann conditions": {"e": {"top": flux}},
                    "Flux conditions": {"c": {"top": flux}}},
        "Discretization": {"order": {"e": order, "c": order},
                           "quadrature": 4 if mesh == "p2" else 2},
        "Solver": solver,
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e": true, "c": true}},
    }
    if dim == 3:
        cfg["Mesh"]["NZ"] = n
        cfg["Functions"]["zvel"] = "0.5"
    if transient:
        cfg["Physics"]["Initial conditions"] = {"e": "0.0", "c": "0.0"}
    if kappa is not None:
        cfg["Functions"]["thermal diffusion"] = kappa
    return cfg


def with_quadrature(cfg, degree):
    """The deck at another quadrature degree."""
    cfg["Discretization"]["quadrature"] = degree
    return cfg


# name -> (deck function of n, n on the card, rtol, {held time: the JAX
# package's f64 CPU L2 per variable}, the kernel every fused res_and_jac
# call launches), as SET_DECKS; tools/jax_references.py runs the same
# deck functions through the JAX package (its general path) for those
# references. Each boundary deck launches the kernel of its deck without
# boundary terms; each affine set deck set_node_state or set_elem_state,
# never a "full" kernel; the quadrature decks the kernels at Q = 64
# (hex, quadrature 6) and Q = 25 (2D p1, quadrature 8).
BOUNDARY_DECKS = {
    "thermal_mixed_neumann_nx512": (
        lambda n: mixed_neumann_deck(n, {"nonlinear TOL": 1e-10,
                                         "Belos solver": "CG"}),
        512, 1e-6, {0.0: {"e": 6.274898128026548e-06}}, "state"),
    # 256^2, not 512^2, since PR 18 (the script's time)
    "thermal_weak_dirichlet_nx256": (
        weak_dirichlet_deck, 256, 1e-6, {0.0: {"e": 2.5099623024602037e-05}},
        "full"),
    "hex_neumann_nx40": (hex_neumann_deck, 40, 1e-6,
                         {0.0: {"e": 0.0007267746494363886}}, "elem_state"),
}
AFFINE_SET_DECKS = {
    "thermal_cdr_affine_nx512": (
        thermal_cdr_affine_deck, 512, 1e-6,
        {0.0: {"e": 6.274905299571667e-06, "c": 6.278257489819945e-06}},
        "set_node_state"),
    "thermal_cdr_affine_dirk22_nx256": (
        lambda n: thermal_cdr_affine_deck(n, transient=True), 256, 1e-6,
        {0.1: {"e": 0.0008146885361382903, "c": 0.0008183940406640421},
         0.2: {"e": 0.001409250662272966, "c": 0.0014120982037004425}},
        "set_node_state"),
    "thermal_cdr_affine_hex_nx48": (
        lambda n: thermal_cdr_affine_deck(n, "hex"), 48, 1e-6,
        {0.0: {"e": 0.0005048151779286237, "c": 0.0005042725895708673}},
        "set_elem_state"),
    "thermal_cdr_affine_p2_nx128": (
        lambda n: thermal_cdr_affine_deck(n, "p2"), 128, 1e-6,
        {0.0: {"e": 4.0235696167172063e-07, "c": 4.0235723029381124e-07}},
        "set_elem_state"),
}
QUADRATURE_DECKS = {
    "ns3d_channel_direct_nx20_q6": (
        lambda n: with_quadrature(ns_elem_deck("hex", n, NS_DIRECT), 6), 20,
        1e-6, {0.0: {"ux": 0.00860948024548221, "uy": 0.0007936004429378482,
                     "pr": 0.042924342612873714,
                     "uz": 0.0029675811510480325}}, "ns_elem_full"),
    "ns3d_thermal_channel_direct_nx20_q6": (
        lambda n: with_quadrature(ns_thermal_channel_deck("hex", n), 6), 20,
        1e-6, {0.0: {"ux": 0.10604396404949179, "uy": 0.015255381037872575,
                     "pr": 0.29369837311871627, "uz": 0.012059791940174794,
                     "e": 0.0014663276769748103}}, "set_elem_full"),
    "ns_channel_visc_nonlinear_direct_nx128_q8": (
        lambda n: with_quadrature(ns_visc_deck(n), 8), 128, 1e-6,
        {0.0: {"ux": 0.00027111995312320255, "uy": 1.2241600284096292e-05,
               "pr": 0.002869571982169511}}, "set_node_full"),
}


def with_solver(cfg, **keys):
    """The deck with more Solver keys."""
    cfg["Solver"].update(keys)
    return cfg


def smoother(kind):
    """The reference's Ifpack2 smoother key, which Problem maps onto a
    preconditioner (ILU* -> multigrid, CHEBYSHEV, SCHWARZ)."""
    return {"Preconditioner Settings": {"smoother: type": kind}}


# the solver decks, as BOUNDARY_DECKS plus the name of the deck of an
# earlier phase that runs the same problem with GMRES + Jacobi (CG for
# nonlinear_nx256): decks with a preconditioner or Krylov key of the
# reference's, each held to the JAX package's f64 CPU L2 for the same
# deck (tools/jax_references.py)
SOLVER_DECKS = {
    # StructuredMG, 2 variables, the Neumann / Flux blocks folded
    "thermal_cdr_affine_mg_nx512": (
        lambda n: with_solver(thermal_cdr_affine_deck(n),
                              **smoother("ILUT")),
        512, 1e-6,
        {0.0: {"e": 6.274905950879487e-06, "c": 6.278257538157226e-06}},
        "set_node_state", "thermal_cdr_affine_nx512"),
    # StructuredMG on a nonsymmetric operator
    "cdr_mg_nx256": (
        lambda n: with_solver(cdr_deck(n), **smoother("ILUT")),
        256, 1e-6, {0.0: {"c": 2.4843363967623844e-05}}, "state",
        "cdr_nx256"),
    # StructuredMG in 3D
    "cdr_hex_mg_nx32": (
        lambda n: with_solver(cdr_deck(n, CDR3_SOURCE,
                                       vel=("2.0", "1.0", "0.5"),
                                       mesh="hex"), **smoother("ILUT")),
        32, 1e-6, {0.0: {"c": 0.0011298217972563996}}, "elem_state",
        "cdr_hex_nx32"),
    # StructuredMG refuses p2: AggregationAMG
    "cdr_p2_amg_nx128": (
        lambda n: with_solver(cdr_deck(n, mesh="p2"), **smoother("ILUT")),
        128, 1e-6, {0.0: {"c": 4.023602971614953e-07}}, "elem_state",
        "cdr_p2_nx128"),
    # Chebyshev inside CG
    "nonlinear_chebyshev_nx256": (
        lambda n: with_solver(nonlinear_deck(n), **smoother("CHEBYSHEV")),
        256, 1e-6, {0.0: {"e": 2.5099635930037346e-05}}, "full",
        "nonlinear_nx256"),
    # element-Schwarz on the nd = 12 saddle blocks
    "ns_startup_schwarz_nx128": (
        lambda n: with_solver(ns_startup_deck(n), **smoother("SCHWARZ")),
        128, 1e-6,
        {0.02: {"ux": 0.16743894056347847, "pr": 0.0018524455771878642,
                "uy": 2.161978007459451e-05}}, "ns_full",
        "ns_startup_dirk22_nx128"),
    # BiCGStab with Jacobi
    "cdr_bicgstab_nx256": (
        lambda n: with_solver(cdr_deck(n), **{"Belos solver": "BiCGStab"}),
        256, 1e-6, {0.0: {"c": 2.484336399365614e-05}}, "state",
        "cdr_nx256"),
}

# phase precond: the Jacobians whose preconditioners the card and the host
# evaluate from the same numbers (kappa = 1 + e*e at 64^2: the SoA rows of
# thermal_node_full; the channel start-up at 128x32: ns_node_full's saddle
# blocks at a BWE stage of dt 0.01)
PRECOND_DECKS = {"nonlinear_nx64": lambda: nonlinear_deck(64),
                 "ns_startup_nx128": lambda: ns_startup_deck(128)}
PRECOND_RTOL = 1e-12


# element blocks, periodic and Exodus meshes, and elasticity: decks whose
# files (an Exodus mesh, grain rotations) are written from SEED with
# numpy into one temporary directory, which tools/jax_references.py
# writes the same way, so both packages read the same files
SEED = 0
_DATA = {}


def data_dir(name):
    """A fresh subdirectory `name` of this run's temporary directory
    (removed at exit)."""
    import atexit
    import os
    import shutil
    import tempfile
    if "root" not in _DATA:
        _DATA["root"] = tempfile.mkdtemp(prefix="chip_smoke_")
        atexit.register(shutil.rmtree, _DATA["root"], True)
    path = os.path.join(_DATA["root"], name)
    os.makedirs(path, exist_ok=True)
    return path


def multiblock_deck(n, solver=None):
    """The reference's thermal/2D_multiblock (tests/test_thermal_family.py
    :130-157): 2x2 element blocks of n x n elements on the unit square,
    u = sin(pi x) sin(pi y); one L2 norm per block (gold 0.000513878 each
    at n = 10)."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n,
                 "Xblocks": 2, "Yblocks": 2},
        "Functions": {"thermal source": "2*(pi*pi)*sin(pi*x)*sin(pi*y)"},
        "Physics": {"modules": "thermal",
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "e": {"top": 0.0, "bottom": 0.0, "left": 0.0,
                              "right": 0.0}},
                    "Initial conditions": {"scalar data": True, "e": 0.0}},
        "Discretization": {"order": {"e": 1}, "quadrature": 2},
        "Solver": dict({"solver": "steady-state", "use strong DBCs": True},
                       **(solver or {})),
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e": "sin(pi*x)*sin(pi*y)"}},
    }


def per_block_deck(n):
    """The JAX package's per-block physics deck
    (tests/test_per_block_physics.py): [0,2]x[0,1] in two blocks of n/2 x
    n/2 elements, thermal (e) on eblock-0_0 and cdr (c) on eblock-1_0,
    each true on its own block; direct solve (the e rows inside the cdr
    block are empty, which the dense solve patches and Jacobi cannot)."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "xmin": 0.0,
                 "xmax": 2.0, "ymin": 0.0, "ymax": 1.0, "NX": n,
                 "NY": n // 2, "Xblocks": 2},
        "Physics": {
            "eblock-0_0": {"modules": "thermal",
                           "Dirichlet conditions": {
                               "e": {"all boundaries": 0.0},
                               "c": {"all boundaries": 0.0}}},
            "eblock-1_0": {"modules": "cdr"}},
        "Functions": {
            "thermal source": "(5.0*pi*pi/4.0)*sin(pi*x/2)*sin(pi*y)"
                              "*(x<1.0)",
            "source": "(5.0*pi*pi/4.0)*cos(pi*(x-1.0)/2)*sin(pi*y)"
                      "*(x>1.0)",
            "diffusion": "1.0", "xvel": "0.0", "yvel": "0.0",
            "reaction": "0.0"},
        "Discretization": {"order": {"e": 1, "c": 1}, "quadrature": 2},
        "Solver": {"solver": "steady-state", "nonlinear TOL": 1e-10,
                   "max nonlinear iters": 3, "use direct solver": True},
        "Postprocess": {"compute errors": True,
                        "True solutions": {
                            "e": "sin(pi*x/2)*sin(pi*y)*(x<1.0)",
                            "c": "cos(pi*(x-1.0)/2)*sin(pi*y)*(x>1.0)"}},
    }


def cdr_periodic_deck(n, final_time=1.0):
    """The reference's cdr/periodic (tests/test_periodic.py:9-24): a
    bubble advected at 10 along a strip periodic in x, BWE steps of 0.1
    to `final_time`; the L2 norm of c (gold 0.250474, 0.131765, 0.123484
    at t = 0, 0.1, 1.0 at n = 40)."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n,
                 "Periodic BCs": {"Count": 1, "Periodic Condition 1":
                                  "y-all 1e-8: left;right"}},
        "Functions": {"source": "0.0", "diffusion": "0.5", "xvel": "10.0",
                      "yvel": "0.0", "reaction": "0.0", "SUPG tau": "0.0",
                      "bubble":
                          "-25.0*(x-0.7)*(x-0.7) - 25.0*(y-0.5)*(y-0.5)"},
        "Physics": {"modules": "cdr",
                    "Initial conditions": {"c": "exp(bubble)"}},
        "Discretization": {"order": {"c": 1}, "quadrature": 2},
        "Solver": {"solver": "transient", "nonlinear TOL": 1e-7,
                   "max nonlinear iters": 10, "final time": final_time,
                   "delta t": 0.1},
        "Postprocess": {"compute errors": True,
                        "True solutions": {"c": "0.0"}},
    }


def exodus_hex_deck(n):
    """Thermal on an n^3 hex box read from an Exodus file that the port's
    write_exodus writes (one block, the box's sidesets, the nodes of the
    front and back faces as nodesets), true solution S3: Dirichlet 0 on
    the x and y faces, and on the front and back faces through
    'e_point_DBCs' on their nodesets; GMRES + Jacobi."""
    import os

    import numpy as np
    from mrhyde_tpu_torch.fem.topology import cell_topology
    from mrhyde_tpu_torch.mesh.exodus import write_exodus
    from mrhyde_tpu_torch.mesh.structured import box_mesh
    mesh = box_mesh("hex", nx=n, ny=n, nz=n)
    sides = cell_topology("hex").sides
    for face in ("front", "back"):
        mesh.nodesets[f"{face}_nodes"] = np.unique(np.concatenate(
            [mesh.conn[e, list(sides[s])] for e, s in
             mesh.sidesets[face]])).astype(np.int32)
    directory = data_dir(f"exodus_hex_{n}")
    write_exodus(os.path.join(directory, "mesh.exo"), mesh)
    return {
        "Mesh": {"dimension": 3, "element type": "hex", "source": "Exodus",
                 "mesh file": "mesh.exo"},
        "Functions": {"thermal source": f"12*(pi*pi)*{S3_TRUE}"},
        "Physics": {"modules": "thermal",
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "e": {s: 0.0 for s in ("left", "right", "bottom",
                                                "top")}},
                    "e_point_DBCs": "front_nodes, back_nodes"},
        "Discretization": {"order": {"e": 1}, "quadrature": 2},
        "Solver": {"solver": "steady-state", "nonlinear TOL": 1e-10},
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e": S3_TRUE}},
        "_deck_dir": directory,
    }


# the reference's le/2D_manufactured (tests/test_solid_sw_porous.py:11-45)
LE_FUNCTIONS = {
    "lambda": "1.0", "mu": "1.0", "A": "1.0", "B": "2.0",
    "dxxx": "(A*pi)*(A*pi)*sin(A*pi*x)*sin(A*pi*y)",
    "dxxy": "-1.0*(A*pi)*(A*pi)*cos(A*pi*x)*cos(A*pi*y)",
    "dxyy": "(A*pi)*(A*pi)*sin(A*pi*x)*sin(A*pi*y)",
    "dyxx": "(B*pi)*(B*pi)*sin(B*pi*x)*sin(B*pi*y)",
    "dyxy": "-1.0*(B*pi)*(B*pi)*cos(B*pi*x)*cos(B*pi*y)",
    "dyyy": "(B*pi)*(B*pi)*sin(B*pi*x)*sin(B*pi*y)",
    "source dx": "(lambda+2.0*mu)*dxxx + mu*(dxyy+dyxy) + lambda*dyxy",
    "source dy": "(lambda+2.0*mu)*dyyy + mu*(dyxx+dxxy) + lambda*dxxy",
}
# multigrid (StructuredMG) under GMRES: the reference's ILUT smoother key
MG = {"Preconditioner Settings": {"smoother: type": "ILUT"}}


def clamped(names):
    return {"scalar data": True, **{v: {"all boundaries": 0.0}
                                    for v in names}}


def le_deck(n, solver=None):
    """le/2D_manufactured on n x n quads (gold L2(dx) 0.000770252, L2(dy)
    0.00121848 at n = 40, direct)."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Physics": {"modules": "linearelasticity",
                    "Dirichlet conditions": clamped(("dx", "dy")),
                    "Initial conditions": {"scalar data": True, "dx": 0.0,
                                           "dy": 0.0}},
        "Functions": dict(LE_FUNCTIONS),
        "Discretization": {"order": {"dx": 1, "dy": 1}, "quadrature": 2},
        "Solver": dict({"solver": "steady-state", "max nonlinear iters": 2},
                       **(solver or {})),
        "Postprocess": {"compute errors": True,
                        "True solutions": {
                            "dx": "sin(A*pi*x)*sin(A*pi*y)",
                            "dy": "sin(B*pi*x)*sin(B*pi*y)"}},
    }


def le3_deck(n, k=(1, 2, 1)):
    """Linear elasticity on n^3 hex, manufactured: u_i = sin(k_i pi x)
    sin(k_i pi y) sin(k_i pi z), 0 on the boundary, lambda = mu = 1, the
    source -mu lap u_i - (lambda + mu) d_i div u; CG + Jacobi."""
    axes = "xyz"
    names = ("dx", "dy", "dz")

    def term(kk, cos_axes):
        return "*".join(f"{'cos' if a in cos_axes else 'sin'}"
                        f"({kk}*pi*{a})" for a in axes)
    src = {}
    for i, ai in enumerate(axes):
        parts = [f"(3.0*mu + (lambda+mu))*({k[i]}*pi)*({k[i]}*pi)"
                 f"*{term(k[i], '')}"]
        for j, aj in enumerate(axes):
            if j != i:
                parts.append(f"(lambda+mu)*(-1.0)*({k[j]}*pi)*({k[j]}*pi)"
                             f"*{term(k[j], ai + aj)}")
        src[f"source {names[i]}"] = " + ".join(parts)
    return {
        "Mesh": {"dimension": 3, "element type": "hex", "NX": n, "NY": n,
                 "NZ": n},
        "Physics": {"modules": "linearelasticity",
                    "Dirichlet conditions": clamped(names)},
        "Functions": {"lambda": "1.0", "mu": "1.0", **src},
        "Discretization": {"order": {v: 1 for v in names},
                           "quadrature": 2},
        "Solver": {"solver": "steady-state", "nonlinear TOL": 1e-10,
                   "Belos solver": "CG"},
        "Postprocess": {"compute errors": True,
                        "True solutions": {v: term(k[i], "") for i, v in
                                           enumerate(names)}},
    }


def crystal_deck(n, grains=64):
    """Crystal elasticity (the reference's defaults, E = 1, nu = 0.4) on
    n x n quads clamped on all sides under a body force, each element
    rotated by the grain nearest its center: `grains` centers and
    in-plane rotations (about z, angles uniform) from SEED in mesh data
    files; the L2 norms of dx, dy; CG + Jacobi (StructuredMG's V-cycle
    does not converge on the rotated tensors: 8,000 GMRES iterations
    without reaching TOL at 66^2 on the CPU)."""
    import os

    import numpy as np
    directory = data_dir(f"crystal_{n}_{grains}_seed{SEED}")
    rng = np.random.RandomState(SEED)
    pts = np.zeros((grains, 3))
    pts[:, :2] = rng.rand(grains, 2)
    th = 2.0 * np.pi * rng.rand(grains)
    rot = np.zeros((grains, 3, 3))
    rot[:, 0, 0] = rot[:, 1, 1] = np.cos(th)
    rot[:, 1, 0] = np.sin(th)
    rot[:, 0, 1] = -np.sin(th)
    rot[:, 2, 2] = 1.0
    np.savetxt(os.path.join(directory, "mesh_data_pts.dat"), pts)
    np.savetxt(os.path.join(directory, "mesh_data.dat"),
               rot.reshape(grains, 9))
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n,
                 "data file": "mesh_data", "have mesh data rotations": True},
        "Functions": {"source dx": "1.0", "source dy": "0.5 - x"},
        "Physics": {"modules": "crystal elasticity",
                    "Dirichlet conditions": clamped(("dx", "dy"))},
        "Discretization": {"order": {"dx": 1, "dy": 1}, "quadrature": 2},
        "Solver": {"solver": "steady-state", "nonlinear TOL": 1e-10,
                   "Belos solver": "CG"},
        "Postprocess": {"compute errors": True,
                        "True solutions": {"dx": "0.0", "dy": "0.0"}},
        "_deck_dir": directory,
    }


def thermoelastic_deck(n, steps=4):
    """Thermal and linear elasticity in one set (the stress's thermal
    term -alpha_T (3 lambda + 2 mu)(e - T_ambient) I): from rest, e
    heated by a source (0 on the boundary), the displacements clamped
    left and right; BWE steps of 0.1; the L2 norms of e, dx, dy;
    multigrid under GMRES."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Functions": {"thermal source": "10*sin(pi*x)*sin(pi*y)",
                      "lambda": "1.0", "mu": "0.5", "alpha_T": "0.01",
                      "source dy": "-0.1"},
        "Physics": {"modules": "thermal, linearelasticity",
                    "T_ambient": 0.2,
                    "Dirichlet conditions": {
                        "scalar data": True, "e": {"all boundaries": 0.0},
                        "dx": {"left": 0.0, "right": 0.0},
                        "dy": {"left": 0.0, "right": 0.0}},
                    "Initial conditions": {"scalar data": True, "e": 0.0,
                                           "dx": 0.0, "dy": 0.0}},
        "Discretization": {"order": {"e": 1, "dx": 1, "dy": 1},
                           "quadrature": 2},
        "Solver": dict({"solver": "transient", "final time": 0.1 * steps,
                        "number of steps": steps, "nonlinear TOL": 1e-10},
                       **MG),
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e": "0.0", "dx": "0.0",
                                           "dy": "0.0"}},
    }


# name -> (deck function of n, n on the card, rtol, {time: the JAX
# package's f64 CPU L2 per label} (tools/jax_references.py, the same deck
# functions and files), the kernel each fused res_and_jac call launches
# (None: the general path, no kernel), {time: the reference's gold per
# label} held at rtol 2e-5). A label is a variable, its L2 norm, or
# "var@b", the norm on element block b of a multi-block mesh.
# Two full-width decks are held looser, at the f64 floor of their
# iterative solves: the card's and JAX's L2 differ by 2-3e-12 (a few
# 1e-12 of |u|), which was 1.5e-5 of the 512-per-block deck's error
# (1.96e-7; multiblock_nx256's is 7.8e-7; held at 1e-4 as default_nx1024)
# and 4.6e-7 of le_manufactured_nx512's (4.7e-6, held at 1e-5; on an
# NVIDIA H100 80GB HBM3 at 700 W).
MULTIBLOCK_GOLD = 0.000513878
MESH_DECKS = {
    # one physics list over 2x2 blocks: B2 thermal_node_state, as JAX's
    # kernel takes it
    "multiblock_gold_nx10": (
        multiblock_deck, 10, 1e-6,
        {0.0: {"e": 0.000513878383438555, "e@1": 0.0005138783834384653,
               "e@2": 0.000513878383438497, "e@3": 0.0005138783834384703}},
        "state",
        {0.0: {f"e{b}": MULTIBLOCK_GOLD for b in ("", "@1", "@2", "@3")}}),
    # 256 per block, not 512, since PR 18 (the script's time)
    "multiblock_nx256": (
        lambda n: multiblock_deck(n, {"nonlinear TOL": 1e-10}), 256, 1e-4,
        {0.0: {"e": 7.8436645572254e-07, "e@1": 7.843664557239546e-07,
               "e@2": 7.843664557226628e-07,
               "e@3": 7.843664557238905e-07}}, "state", {}),
    # per-block physics (module masks): the general path in both packages
    "per_block_thermal_cdr_nx128": (
        per_block_deck, 128, 1e-6,
        {0.0: {"e": 8.157269552422003e-05, "e@1": 0.03607895800291421,
               "c": 0.03607895800291383, "c@1": 8.157269552725792e-05}},
        None, {}),
    # periodic meshes: no structured plan, the general path
    "cdr_periodic_gold_nx40": (
        cdr_periodic_deck, 40, 1e-6,
        {0.0: {"c": 0.25047383956395075}, 0.1: {"c": 0.13176488764169844},
         1.0: {"c": 0.12348371587903309}}, None,
        {0.0: {"c": 0.250474}, 0.1: {"c": 0.131765},
         1.0: {"c": 0.123484}}),
    "cdr_periodic_nx256": (
        lambda n: cdr_periodic_deck(n, 0.2), 256, 1e-6,
        {0.1: {"c": 0.1317836245900913}, 0.2: {"c": 0.12423954751792056}},
        None, {}),
    # a mesh from a file: the general path
    "exodus_hex_nx32": (exodus_hex_deck, 32, 1e-6,
                        {0.0: {"e": 0.0011361342397550624}}, None, {}),
}
SOLID_DECKS = {
    "le_manufactured_gold_nx40": (
        le_deck, 40, 1e-6,
        {0.0: {"dx": 0.0007702515757545954, "dy": 0.001218482747649315}},
        None, {0.0: {"dx": 0.000770252, "dy": 0.00121848}}),
    "le_manufactured_nx512": (
        lambda n: le_deck(n, dict(MG, **{"nonlinear TOL": 1e-10})), 512,
        1e-5,
        {0.0: {"dx": 4.704371718401101e-06, "dy": 7.447685261146495e-06}},
        None, {}),
    "le_hex_manufactured_nx32": (
        le3_deck, 32, 1e-6,
        {0.0: {"dx": 0.00042760630861987523, "dy": 0.0013176869071931704,
               "dz": 0.0004276063086175391}}, None, {}),
    "crystal_rotated_nx256": (
        crystal_deck, 256, 1e-6,
        {0.0: {"dx": 0.030699059466568902, "dy": 0.005780693065773657}},
        None, {}),
    "thermoelastic_transient_nx128": (
        thermoelastic_deck, 128, 1e-6,
        {0.1: {"e": 0.16812261004675014, "dx": 0.0014386209227766626,
               "dy": 0.021203692214290297},
         0.4: {"e": 0.2500524966096824, "dx": 0.0014489132281884016,
               "dy": 0.021206353963688716}}, None, {}),
}


# the rest of A10's physics (the general path; none of these modules has
# a kernel in either package) and two decks whose coefficients read the
# Parameters sublist (on the B2 kernels)
def _steps(dt, steps, tableau="BWE", **keys):
    return dict({"solver": "transient", "transient Butcher tableau": tableau,
                 "delta t": dt, "final time": dt * steps}, **keys)


def burgers_deck(n, evisc=False, supg=False, steps=4, dim=2):
    """Burgers. In 1D the reference's
    burgers/1D_Nonlinear_Backtracking (tests/test_cdr_burgers.py:36-77:
    xvel 100, eps 1e-3, BWE steps of 1e-3 to t = 0.004, direct; gold L2(u)
    0.354012 / 0.329584 / 0.313885 / 0.291375 at t = 0 / 0.001 / 0.002 /
    0.004 at n = 100). In 2D a bump advected by v = (1, 0.5) on n x n
    quads, u = 0 on the boundary, eps 1e-3, BWE steps of 0.01, with the
    entropy viscosity (C1 = C2 = 1) and SUPG (supg C = 1) switched by
    `evisc`, `supg`; GMRES + Jacobi."""
    if dim == 1:
        return {
            "Mesh": {"dimension": 1, "element type": "interval", "NX": n},
            "Physics": {"modules": "Burgers",
                        "Dirichlet conditions": {
                            "scalar data": True,
                            "u": {"left": 0.0, "right": 0.0}},
                        "Initial conditions": {"u": "exp(bubble)"}},
            "Discretization": {"order": {"u": 1}, "quadrature": 2},
            "Functions": {"Burgers source": "0.0", "xvel": "100.0",
                          "yvel": "0.0", "diffusion": "1.0e-3",
                          "bubble": "-100.0*(x-0.2)*(x-0.2)"},
            "Solver": {"solver": "transient",
                       "transient Butcher tableau": "BWE",
                       "nonlinear TOL": 1e-7, "max nonlinear iters": 10,
                       "final time": 0.004, "delta t": 1.0e-3,
                       "allow backtracking": True,
                       "use direct solver": True},
            "Postprocess": {"compute errors": True,
                            "True solutions": {"u": "0.0"}},
        }
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Physics": {"modules": "Burgers", "entropy viscosity": evisc,
                    "use SUPG": supg,
                    "Dirichlet conditions": {
                        "scalar data": True, "u": {"all boundaries": 0.0}},
                    "Initial conditions": {"u": "exp(bubble)"}},
        "Discretization": {"order": {"u": 1}, "quadrature": 2},
        "Functions": {"Burgers source": "0.0", "xvel": "1.0",
                      "yvel": "0.5", "diffusion": "1.0e-3",
                      "bubble": "-50.0*((x-0.3)*(x-0.3)+(y-0.3)*(y-0.3))",
                      "C1": "1.0", "C2": "1.0", "supg C": "1.0",
                      "supg C1": "1.0", "supg C2": "1.0"},
        "Solver": _steps(0.01, steps, **{"nonlinear TOL": 1e-10}),
        "Postprocess": {"compute errors": True,
                        "True solutions": {"u": "0.0"}},
    }


def helmholtz_deck(n, robin=False, solver=None):
    """The reference's helmholtz/manufactured_solution
    (tests/test_helmholtz_gold.py: complex c2 = (x^2-1) + 2x i, Neumann
    impedance data on the right side; gold L2(ureal) 0.000517267,
    L2(uimag) 0.000222348 at n = 100) on n x n quads, GMRES +
    StructuredMG; robin: the impedance robin_alpha = 0.5 + 0.25 i on the
    Neumann side too."""
    funcs = {
        "source_r_side": "2.0*pi*cos(2*pi*x)*sin(2*pi*y)",
        "source_i_side": "2.0*pi*cos(2*pi*x)*sin(2*pi*y)",
        "scoeff": "8*pi*pi*(x*x-2*x-1)-1.0",
        "scoeffi": "8*pi*pi*(x*x+2*x-1)-1.0",
        "srcoeff": "2.0-2*x", "sicoeff": "-2.0-2*x",
        "source_r": "scoeff*sin(2*pi*x)*sin(2*pi*y) + "
                    "srcoeff*2*pi*cos(2*pi*x)*sin(2*pi*y)",
        "source_i": "scoeffi*sin(2*pi*x)*sin(2*pi*y) + "
                    "sicoeff*2*pi*cos(2*pi*x)*sin(2*pi*y)",
        "c2r_x": "x*x-1.0", "c2i_x": "2.0*x",
        "c2r_y": "x*x-1.0", "c2i_y": "2.0*x",
        "omega2r": "1.0", "omega2i": "0.0"}
    if robin:
        funcs.update({"robin_alpha_r": "0.5", "robin_alpha_i": "0.25"})
    walls = {"left": 0.0, "top": 0.0, "bottom": 0.0}
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Physics": {"modules": "helmholtz",
                    "Dirichlet conditions": {"scalar data": True,
                                             "ureal": dict(walls),
                                             "uimag": dict(walls)},
                    "Neumann conditions": {"ureal": {"right": "0.0"},
                                           "uimag": {"right": "0.0"}}},
        "Functions": funcs,
        "Discretization": {"order": {"ureal": 1, "uimag": 1},
                           "quadrature": 2},
        "Solver": dict({"solver": "steady-state", "nonlinear TOL": 1e-8,
                        "preconditioner variant": "multigrid",
                        "linear TOL": 1e-11}, **(solver or {})),
        "Postprocess": {"compute errors": True,
                        "True solutions": {
                            "ureal": "sin(2*pi*x)*sin(2*pi*y)",
                            "uimag": "sin(2*pi*x)*sin(2*pi*y)"}},
    }


def ks_deck(n, dim=1, steps=20):
    """Kuramoto-Sivashinsky. dim 1: the reference's ks/1D_wave
    (tests/test_ks_gold.py: 10 elements periodic in x, u = sin(2 pi x),
    BWE steps of 1e-3 to t = 0.02, direct; the norms of u and w at every
    step, true solutions 0). dim 2: n x n quads periodic in x and y, u =
    sin(2 pi x) sin(2 pi y), `steps` BWE steps of 1e-3, direct (the
    mixed system's condition grows as dt/h^4: at 128^2 GMRES with Jacobi
    or element-Schwarz stops at its cap, and the two runs' L2(u) at t =
    0.004 differ 30-fold in the JAX package)."""
    conds = {"Periodic Condition 1": "x-all 1e-8: left;right"} if dim == 1 \
        else {"Periodic Condition 1": "y-all 1e-8: left;right",
              "Periodic Condition 2": "x-all 1e-8: bottom;top"}
    mesh = {"dimension": dim, "NX": n,
            "Periodic BCs": dict({"Count": len(conds)}, **conds)}
    mesh.update({"element type": "interval"} if dim == 1 else
                {"element type": "quad", "NY": n})
    return {
        "Mesh": mesh,
        "Physics": {"modules": "Kuramoto-Sivashinsky",
                    "Initial conditions": {
                        "u": "sin(2*pi*x)" if dim == 1
                        else "sin(2*pi*x)*sin(2*pi*y)"}},
        "Discretization": {"order": {"u": 1, "w": 1}, "quadrature": 2},
        "Solver": _steps(1.0e-3, steps, **(
            {"nonlinear TOL": 1e-7, "max nonlinear iters": 10,
             "use direct solver": True} if dim == 1
            else {"nonlinear TOL": 1e-10, "use direct solver": True})),
        "Postprocess": {"compute errors": True,
                        "True solutions": {"u": "0.0", "w": "0.0"}},
    }


def shallowwater_deck(n, steps=5):
    """The reference's shallowwater/droptest (tests/test_solid_sw_porous.py
    :45-77): a Gaussian hump of water on n x n quads, DIRK-1,2 steps of
    1e-3; gold L2(H) 1.00321 (rtol 2e-5) and L2(Hv) 0.0121219 (2e-4) at
    t = 0.005 at n = 40."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Physics": {"modules": "shallow water",
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "Hu": {"left": 0.0, "right": 0.0},
                        "Hv": {"top": 0.0, "bottom": 0.0}},
                    "Initial conditions": {"H": "1.0 + 0.1*exp(hump)",
                                           "Hu": "0.0", "Hv": "0.0"}},
        "Discretization": {"order": {"H": 1, "Hu": 1, "Hv": 1},
                           "quadrature": 2},
        "Solver": _steps(1.0e-3, steps, "DIRK-1,2"),
        "Postprocess": {"compute errors": True,
                        "True solutions": {"H": "0.0", "Hu": "0.0",
                                           "Hv": "0.0"}},
        "Functions": {"hump":
                      "-100.0*(x-0.5)*(x-0.5) - 100*(y-0.5)*(y-0.5)"},
    }


def phasefield_deck(n, legacy=True, dim=2, module="msphasefield"):
    """The reference's phasefield/2d-3phi (tests/test_phasefield_gold.py:
    three disks on [0,100]^2, n x n quads, L = 2 (active), A = 0.2,
    thermal_diff = 2 as parameters, one BWE step to t = 0.5, initial
    values interpolated; golds at n = 100 with the legacy first-qp
    sampling). dim 3: the disks as balls on n^3 hex."""
    rs = {"rone": (37.5, 50.0, 50.0), "rtwo": (61.5, 50.0, 50.0),
          "rthree": (50.0, 75.0, 50.0)}
    funcs = {k: "(" + " + ".join(f"({a}-{c})*({a}-{c})" for a, c in
                                 zip("xyz"[:dim], ctr)) + ")^(0.5)"
             for k, ctr in rs.items()}
    mesh = {"dimension": dim, "element type": "quad" if dim == 2 else "hex",
            "xmin": 0.0, "xmax": 100.0, "ymin": 0.0, "ymax": 100.0,
            "NX": n, "NY": n}
    if dim == 3:
        mesh.update({"zmin": 0.0, "zmax": 100.0, "NZ": n})
    return {
        "Mesh": mesh,
        "Physics": {"number_phases": 3, "modules": module,
                    "legacy first-qp sampling": legacy,
                    "Initial conditions": {
                        "phi1": "1.0*(rone<12.5)", "phi2": "1.0*(rtwo<12.5)",
                        "phi3": "1.0*(rthree<12.5)"}},
        "Functions": funcs,
        "Parameters": {
            "thermal_diff": {"type": "scalar", "value": 2.0,
                             "usage": "inactive"},
            "L": {"type": "scalar", "value": 2.0, "usage": "active"},
            "A": {"type": "scalar", "value": 0.2, "usage": "inactive"}},
        "Discretization": {"order": {"phi1": 1, "phi2": 1, "phi3": 1},
                           "quadrature": 2},
        "Solver": {"solver": "transient", "initial type": "interpolation",
                   "nonlinear TOL": 1e-7, "max nonlinear iters": 10,
                   "final time": 0.5, "delta t": 0.5},
        "Postprocess": {"compute errors": True,
                        "True solutions": {
                            p: "sin(2*pi*x)*sin(2*pi*y)"
                            for p in ("phi1", "phi2", "phi3")}},
    }


def phasesolidification_deck(n, dim=3, module="phasesolidification",
                             legacy=False):
    """Two phases on n^dim (hex in 3D) decaying from sine bumps, L = 1, A
    = 0.25, diff = 0.8 as functions, 0 on the boundary, two BWE steps of
    0.01 (tests/test_phasesolidification.py), nonlinear TOL 1e-10; the
    norms of phi1, phi2 (true solutions 0). module "msphasefield": its
    form, with its first-qp sampling if `legacy`."""
    bump = "*".join(f"sin(pi*{a})" for a in "xyz"[:dim])
    mesh = {"dimension": dim, "element type": "quad" if dim == 2 else "hex",
            "NX": n, "NY": n}
    if dim == 3:
        mesh["NZ"] = n
    return {
        "Mesh": mesh,
        "Physics": {"modules": module, "number_phases": 2,
                    "legacy first-qp sampling": legacy,
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "phi1": {"all boundaries": 0.0},
                        "phi2": {"all boundaries": 0.0}},
                    "Initial conditions": {"phi1": bump,
                                           "phi2": f"0.5*{bump}"}},
        "Functions": {"L": "1.0", "A": "0.25", "diff": "0.8"},
        "Discretization": {"order": {"phi1": 1, "phi2": 1},
                           "quadrature": 2},
        "Solver": _steps(0.01, 2, **{"nonlinear TOL": 1e-10}),
        "Postprocess": {"compute errors": True,
                        "True solutions": {"phi1": "0.0", "phi2": "0.0"}},
    }


VDNS_TRUE = {"ux": "0.5*y*(1.0-y)", "uy": "0.0", "pr": "0.0", "T": "1.0"}


def vdns_deck(nx, ny, pspg=True, supg=False, graddiv=False, steps=0,
              solver=None):
    """The reference's vdns/channel (tests/test_vdns_gold.py): the
    channel [0,5]x[0,1] on nx x ny quads, T = 1 on the walls, traction
    data in and out, rho = mu = cp = lambda = 1 as functions, p0 = 1 and
    dp0dt = 0 as parameters; gold L2 ux / pr / uy 0.0019421 / 0.0128887 /
    8.18291e-05 and T 0 at 50x10 (PSPG, steady, direct). steps > 0: the
    start-up from rest, BWE steps of 0.01, direct: with PSPG + SUPG +
    GRADDIV, GMRES + Jacobi stops at its cap in every solve and Newton at
    its 10 iterations at 128x32 and 256x64 (32 and 40 Newton iterations
    for 4 steps), and GMRES + StructuredMG at 256x64 outlasts 15 minutes
    on the card."""
    sol = {"solver": "steady-state", "use direct solver": True}
    if steps:
        sol = _steps(0.01, steps, **{"nonlinear TOL": 1e-8,
                                     "use direct solver": True})
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "xmin": 0.0,
                 "xmax": 5.0, "ymin": 0.0, "ymax": 1.0, "NX": nx,
                 "NY": ny},
        "Physics": {"modules": "VDNS", "usePSPG": pspg, "useSUPG": supg,
                    "useGRADDIV": graddiv,
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "ux": {"bottom": 0.0, "top": 0.0},
                        "uy": {"bottom": 0.0, "top": 0.0},
                        "T": {"bottom": 1.0, "top": 1.0},
                        "pr": {"left": 0.0}},
                    "Neumann conditions": {
                        "ux": {"left": "0.0", "right": "0.0"},
                        "uy": {"left": "-.5*(1.-2.*y)",
                               "right": ".5*(1.-2.*y)"}},
                    "Initial conditions": {
                        "scalar data": False, "ux": "0.0", "uy": "0.0",
                        "pr": "0.0", "T": "1.0"}},
        "Functions": {"source ux": "1.0", "rho": "1.0", "mu": "1.0",
                      "cp": "1.0", "lambda": "1.0"},
        "Parameters": {
            "p0": {"type": "scalar", "value": 1.0, "usage": "inactive"},
            "dp0dt": {"type": "scalar", "value": 0.0, "usage": "inactive"}},
        "Discretization": {"order": {"ux": 1, "uy": 1, "pr": 1, "T": 1},
                           "quadrature": 2},
        "Solver": dict(sol, **(solver or {})),
        "Postprocess": {"compute errors": True,
                        "True solutions": dict(VDNS_TRUE)},
    }


def porous_deck(n, compressible=False, steps=4):
    """The reference's porous/2D_verification (tests/test_solid_sw_porous.py
    :79-103: p = sin(2 pi x) sin(2 pi y) on n x n quads, steady; gold L2
    0.00102776, L2-grad 0.201394, L2-face 0.0017603 at n = 40).
    compressible: compressibility 0.1 and permeability 1 + 0.5 sin(2 pi
    x), `steps` BWE steps of 0.05 from p = 0, GMRES + StructuredMG."""
    cfg = {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Functions": {"porous source": SOURCE},
        "Physics": {"modules": "porous",
                    "Dirichlet conditions": {"scalar data": True,
                                             "p": {"all boundaries": 0.0}},
                    "Initial conditions": {"scalar data": True, "p": 0.0}},
        "Discretization": {"order": {"p": 1}, "quadrature": 2},
        "Solver": {"solver": "steady-state", "nonlinear TOL": 1e-7,
                   "max nonlinear iters": 2},
        "Postprocess": {"compute errors": True,
                        "True solutions": {
                            "p": S_TRUE, "p face": S_TRUE,
                            "grad(p)[x]": "2*pi*cos(2*pi*x)*sin(2*pi*y)",
                            "grad(p)[y]": "2*pi*sin(2*pi*x)*cos(2*pi*y)"}},
    }
    if compressible:
        cfg["Functions"].update({"compressibility": "0.1",
                                 "permeability": "1.0 + 0.5*sin(2*pi*x)"})
        cfg["Solver"] = dict(_steps(0.05, steps, **{"nonlinear TOL": 1e-10}),
                             **MG)
    return cfg


def manufactured_deck(n, module, var, funcs, transient=False):
    """A steady manufactured deck of a scalar module on n x n quads: u =
    sin(2 pi x) sin(2 pi y), 0 on the boundary, CG + Jacobi (transient:
    4 BWE steps of 0.05 from 0 towards it)."""
    cfg = {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Functions": funcs,
        "Physics": {"modules": module,
                    "Dirichlet conditions": {"scalar data": True,
                                             var: {"all boundaries": 0.0}},
                    "Initial conditions": {"scalar data": True, var: 0.0}},
        "Discretization": {"order": {var: 1}, "quadrature": 2},
        "Solver": {"solver": "steady-state", "nonlinear TOL": 1e-10,
                   "Belos solver": "CG"},
        "Postprocess": {"compute errors": True,
                        "True solutions": {var: S_TRUE}},
    }
    if transient:
        cfg["Solver"] = _steps(0.05, 4, **{"nonlinear TOL": 1e-10,
                                           "Belos solver": "CG"})
    return cfg


def shallowice_deck(n):
    """Shallow ice with the diffusion 1 + 0.5 x y: its manufactured
    source (tests/test_shallowice_llamas.py), CG."""
    kx = "2*pi*cos(2*pi*x)*sin(2*pi*y)"
    ky = "2*pi*sin(2*pi*x)*cos(2*pi*y)"
    return manufactured_deck(n, "shallow ice", "s", {
        "diffusion": "1.0 + 0.5*x*y",
        "source": f"(1.0 + 0.5*x*y)*8*(pi*pi)*{S_TRUE}"
                  f" - 0.5*y*{kx} - 0.5*x*{ky}"})


def llamas_deck(n):
    """llamas, -lap u + c u = f with c = 1 (tests/test_shallowice_llamas.py
    :91-105), CG."""
    return manufactured_deck(n, "llamas", "llama", {
        "whatever": f"(8*(pi*pi)+1.0)*{S_TRUE}", "c": "1.0"})


def physics_test_deck(n):
    """physicsTest (plain diffusion) towards the manufactured solution,
    4 BWE steps of 0.05 from 0, CG."""
    return manufactured_deck(n, "physicsTest", "e",
                             {"test source": SOURCE}, transient=True)


def hartmann_deck(n, ny=None, ha=None):
    """The reference's hartmann/analytical_solve (tests/test_hartmann_gold.py:
    [-1, 1] in n elements, u = 0 at the walls, the Neumann data
    -resistivity b on b, resistivity and hartmannNum as parameters 1.0,
    direct; its analytic solution's L2 1.126126e-06 (u) and 1.062206e-06
    (b) at n = 500, rtol 1e-4). ny: the same channel on n x ny quads of
    [-1,1]x[0,0.25] (its solution does not vary in y), GMRES +
    StructuredMG (GMRES + Jacobi stops at its cap).
    ha: the parameter hartmannNum's value (the function of that name,
    1.0 by default, is what the module reads)."""
    mesh = {"dimension": 1, "element type": "interval", "xmin": -1.0,
            "xmax": 1.0, "NX": n}
    if ny:
        mesh.update({"dimension": 2, "element type": "quad", "NY": ny,
                     "ymin": 0.0, "ymax": 0.25})
    return {
        "Mesh": mesh,
        "Physics": {"modules": "hartmann",
                    "Dirichlet conditions": {
                        "scalar data": True, "u": {"left": 0.0,
                                                   "right": 0.0}},
                    "Neumann conditions": {
                        "b": {"left": "-resistivity*b",
                              "right": "-resistivity*b"}}},
        "Functions": {
            "uhat": "(resistivity+1)/(hartmannNum*(hartmannNum+"
                    "resistivity*sinh_Ha/cosh_Ha))",
            "cosh_Ha": "cosh(hartmannNum)", "sinh_Ha": "sinh(hartmannNum)",
            "cosh_xHa": "cosh(x*hartmannNum)",
            "sinh_xHa": "sinh(x*hartmannNum)"},
        "Parameters": {
            "resistivity": {"type": "scalar", "value": 1.0,
                            "usage": "inactive"},
            "hartmannNum": {"type": "scalar",
                            "value": 1.0 if ha is None else ha,
                            "usage": "inactive"}},
        "Discretization": {"order": {"u": 1, "b": 1}, "quadrature": 2},
        "Solver": dict({"solver": "steady-state", "nonlinear TOL": 1e-10,
                        "max nonlinear iters": 2},
                       **(MG if ny else {"use direct solver": True})),
        "Postprocess": {"compute errors": True,
                        "True solutions": {
                            "u": "uhat*(1-cosh_xHa/cosh_Ha)",
                            "b": "-x/hartmannNum+uhat*sinh_xHa/cosh_Ha"}},
    }


def inc_sat_deck(nx, ny, wells=True, steps=4):
    """Incompressible saturation (tests/test_inc_sat.py): S = 0.5 + 0.25
    sin(2 pi (x - t)) carried by u = (1, 0), f_w = S, porosity 0.5, on nx
    x ny quads periodic in x, DIRK-2,2 steps of 0.005; wells: a rate well
    (0.3 at (0.5, 0.5)) through 'use well source'. GMRES + Jacobi."""
    cfg = {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": nx, "NY": ny,
                 "Periodic BCs": {
                     "periodic condition 1": "y-all 1e-8: left;right"}},
        "Physics": {"modules": "inc sat", "porosity": 0.5,
                    "Initial conditions": {"S": "0.5 + 0.25*sin(2*pi*x)"}},
        "Functions": {"f_w": "S", "ux": "1.0", "uy": "0.0",
                      "source_S": "(-0.5)*0.25*2*pi*cos(2*pi*(x-t))"
                                  " + 0.25*2*pi*cos(2*pi*(x-t))"},
        "Discretization": {"order": {"S": 1}, "quadrature": 3},
        "Solver": _steps(0.005, steps, "DIRK-2,2",
                         **{"nonlinear TOL": 1e-10}),
        "Postprocess": {"compute errors": True,
                        "True solutions": {
                            "S": "0.5 + 0.25*sin(2*pi*(x-t))"}},
    }
    if wells:
        cfg["Physics"]["use well source"] = True
        cfg["Physics"]["Wells"] = {
            "w1": {"type": "rate", "rate": 0.3, "location": [0.5, 0.5],
                   "radius": 0.05}}
    return cfg


CNS_FAR = {"rho": "1.0", "rhoux": "0.1", "rhouy": "0.0", "rhouz": "0.0",
           "rhoE": "2.505"}


def cns_deck(n, dim=2, bc="Slip", steps=4):
    """Compressible Navier-Stokes (mu = 0.05): a pressure pulse at the
    center of n^dim cells (tests/test_euler_unit.py:65-98's in 1D), DIRK-1,2
    steps of 0.005; bc "Slip": slip walls on every side, "Far-field": the
    free stream (1, 0.1, 0, 2.505) on every side. GMRES + Jacobi."""
    names = ["rho", "rhoux", "rhouy", "rhouz"][:1 + dim] + ["rhoE"]
    bump = "exp(-200*(" + "+".join(f"({a}-0.5)*({a}-0.5)"
                                   for a in "xyz"[:dim]) + "))"
    mesh = {"dimension": dim, "element type": ("interval", "quad", "hex")[
        dim - 1], "NX": n, "NY": n, "NZ": n}
    ics = {v: "0.0" for v in names}
    ics.update({"rho": f"1.0 + 0.01*{bump}",
                "rhoE": f"(1.0/0.4) + 0.01*{bump}"})
    bcs = {"Slip conditions": {"rho": {"all boundaries": "0"}}} \
        if bc == "Slip" else {"Far-field conditions": {
            v: {"all boundaries": CNS_FAR[v]} for v in names}}
    return {
        "Mesh": mesh,
        "Physics": dict({"modules": "cns", "gamma": 1.4, "mu": 0.05,
                         "Initial conditions": ics}, **bcs),
        "Discretization": {"order": {v: 1 for v in names}, "quadrature": 2},
        "Solver": _steps(0.005, steps, "DIRK-1,2",
                         **{"nonlinear TOL": 1e-10}),
        "Postprocess": {"compute errors": True,
                        "True solutions": {v: "0.0" for v in names}},
    }


def params_thermal_deck(n):
    """The nonlinear thermal deck (kappa = 1 + e e) with kappa = k0 + k1
    e e read from two inactive parameters k0 = k1 = 1: B2
    thermal_node_full."""
    cfg = nonlinear_deck(n)
    cfg["Functions"]["thermal diffusion"] = "k0 + k1*e*e"
    cfg["Parameters"] = {
        "k0": {"type": "scalar", "value": 1.0, "usage": "inactive"},
        "k1": {"type": "scalar", "value": 1.0, "usage": "inactive"}}
    return cfg


def params_ns_deck(nx):
    """The 128x32 NS channel (PSPG, direct) with the viscosity and the
    source ux both the active parameter nu = 0.5 (the same Poiseuille
    flow): ns_node_full."""
    cfg = ns_deck(nx, nx // 4, {"use direct solver": True,
                                "nonlinear TOL": 1e-8})
    cfg["Functions"].update({"viscosity": "nu", "source ux": "nu"})
    cfg["Parameters"] = {"nu": {"type": "scalar", "value": 0.5,
                                "usage": "active"}}
    return cfg




# the manufactured Darcy flow of the reference's porous/Mixed and
# porous/WeakGalerkin_2D decks: p = 1 + S or S (S = sin 2 pi x sin 2 pi y),
# velocity -grad p
DARCY_U = ("-2*pi*cos(2*pi*x)*sin(2*pi*y)", "-2*pi*sin(2*pi*x)*cos(2*pi*y)")


def porous_mixed_deck(n, solver=None, hybrid=False):
    """The reference's porous/Mixed (tests/test_mixed_porous.py): HDIV
    (RT0) velocity u and HVOL pressure p on n x n quads, the pressure 1
    on every side through the natural boundary integral, direct; gold
    L2(p) 0.158697, L2(u) 1.02259 (rtol 2e-5) and L2-div(u) 12.390539
    (1e-4) at n = 8. hybrid: its hybridized form (broken HDIV u, HFACE
    trace lambda carrying the Dirichlet data; tests/test_hybridized.py),
    the same golds. `solver` replaces the direct solve's keys."""
    trues = {"p": f"1.0+{S_TRUE}", "u[x]": DARCY_U[0], "u[y]": DARCY_U[1]}
    if not hybrid:
        trues["div(u)"] = SOURCE
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Physics": {"modules": "porous mixed hybridized" if hybrid
                    else "porous mixed",
                    "Dirichlet conditions": {
                        "lambda" if hybrid else "p": {
                            s: "1.0" for s in ("left", "right", "top",
                                               "bottom")}}},
        "Functions": {"source": SOURCE},
        "Solver": dict({"solver": "steady-state", "nonlinear TOL": 1e-7,
                        "max nonlinear iters": 2, "initial type": "none"},
                       **(solver or {"use direct solver": True})),
        "Discretization": {"order": {"p": 0, "u": 1, "lambda": 0},
                           "quadrature": 2},
        "Postprocess": {"compute errors": True, "True solutions": trues},
    }


def weak_galerkin_deck(n, solver=None):
    """The reference's porous/WeakGalerkin_2D (tests/test_hybridized.py
    :37-72): HVOL pint, HFACE pbndry (0 on every side), broken RT0 weak
    gradient u and flux t on n x n quads, direct; gold L2(pint) 0.127469,
    L2-face(pbndry) 1.2962, L2(u) = L2(t) 0.814028 (rtol 2e-5) at n =
    10."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Physics": {"modules": "porous weak Galerkin",
                    "assemble face terms": True,
                    "Dirichlet conditions": {"pbndry": {
                        s: "0.0" for s in ("left", "right", "top",
                                           "bottom")}}},
        "Functions": {"source": SOURCE},
        "Solver": dict({"solver": "steady-state", "initial type": "none"},
                       **(solver or {"use direct solver": True,
                                     "use preconditioner": False})),
        "Discretization": {"order": {"pint": 0, "pbndry": 0, "u": 1,
                                     "t": 1}, "quadrature": 2},
        "Postprocess": {"compute errors": True, "True solutions": {
            "pint": S_TRUE, "pbndry face": S_TRUE,
            "u[x]": DARCY_U[0][1:], "u[y]": DARCY_U[1][1:],
            "t[x]": DARCY_U[0], "t[y]": DARCY_U[1]}},
    }


SINES3 = "sin(pi*x)*sin(pi*y)*sin(pi*z)"


def maxwell_deck(n, steps=1, solver=None):
    """The reference's maxwell/NonzeroIC (tests/test_maxwell.py:17-56):
    HCURL E and HDIV B on n^3 hex, both projected from sin sin sin in
    every component (L2 projection), DIRK-1,2 steps of 0.01, direct;
    gold L2(E) 0.0692758 / 0.0743729 and L2(B) 0.0976523 / 0.101339 at t
    = 0 / 0.01 (rtol 2e-5) at n = 8, one step."""
    trues = {f"{v}[{c}]": SINES3 for v in ("E", "B") for c in "xyz"}
    return {
        "Mesh": {"dimension": 3, "shape": "hex", "NX": n, "NY": n, "NZ": n},
        "Physics": {"modules": "maxwell", "Initial conditions": trues},
        "Functions": {"current x": "0.0", "permittivity": "1.0",
                      "permeability": "1.0"},
        "Discretization": {"order": {"E": 1, "B": 1}, "quadrature": 2},
        "Solver": dict({"solver": "transient", "transient BDF order": 1,
                        "transient Butcher tableau": "DIRK-1,2",
                        "nonlinear TOL": 1e-7, "max nonlinear iters": 1,
                        "final time": 0.01 * steps, "number of steps": steps,
                        "initial type": "L2-projection",
                        "allow backtracking": False},
                       **(solver or {"use direct solver": True})),
        "Postprocess": {"compute errors": True, "True solutions": trues},
    }


MAXWELL_FP_VARS = ("Arx", "Aix", "Ary", "Aiy", "Arz", "Aiz", "phir", "phii")


def maxwells_fp_deck(n, solver=None):
    """The reference's maxwell_fp/3D_verfication
    (tests/test_maxwell_fp_gold.py:44-77): the complex potentials' eight
    HGRAD components on n^3 hex, 'test: 2' (the reference's manufactured
    coefficients and sources), zero on every side, direct; gold the
    eight L2 at n = 5."""
    sol = {"Arx": SINES3, "Aix": SINES3, "Ary": f"-1.0*{SINES3}",
           "Aiy": f"-1.0*{SINES3}", "Arz": f"2.0*{SINES3}",
           "Aiz": f"2.0*{SINES3}", "phir": SINES3, "phii": SINES3}
    return {
        "Mesh": {"dimension": 3, "element type": "hex", "NX": n, "NY": n,
                 "NZ": n},
        "Physics": {"modules": "maxwells_freq_pot", "test": 2,
                    "Dirichlet conditions": {
                        v: {"all boundaries": "0.0"}
                        for v in MAXWELL_FP_VARS}},
        "Discretization": {"order": {v: 1 for v in MAXWELL_FP_VARS},
                           "quadrature": 2},
        "Solver": dict({"solver": "steady-state", "nonlinear TOL": 1e-12,
                        "max nonlinear iters": 10},
                       **(solver or {"use direct solver": True})),
        "Postprocess": {"compute errors": True, "True solutions": sol},
    }


def swe_hybridized_deck(n, steps=5, solver=None):
    """Hybridized shallow water: a Gaussian hump of water (the droptest's)
    on n x n quads under the far-field state (H, Hux, Huy) = (1, 0, 0) on
    every side (the characteristic boundary flux), DIRK-1,2 steps of
    1e-3."""
    names = ("H", "Hux", "Huy")
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Physics": {"modules": "shallow water hybridized",
                    "Far-field conditions": {
                        v: {"all boundaries": "1.0" if v == "H" else "0.0"}
                        for v in names},
                    "Initial conditions": {"H": "1.0 + 0.1*exp(hump)",
                                           "Hux": "0.0", "Huy": "0.0"}},
        "Discretization": {"order": {v: 1 for v in names}, "quadrature": 2},
        "Solver": _steps(1.0e-3, steps, "DIRK-1,2", **(solver or {})),
        "Postprocess": {"compute errors": True,
                        "True solutions": {v: "0.0" for v in names}},
        "Functions": {"hump":
                      "-100.0*(x-0.5)*(x-0.5) - 100*(y-0.5)*(y-0.5)"},
    }


PULSE = "(1.0 + 0.2*exp(-50*(x-0.5)*(x-0.5)))"


def euler_hdg_deck(n, steps=4, stab="max EV stabilization", solver=None):
    """Euler's HDG form (tests/test_euler_hdg.py:95-108): a density pulse
    carried by a uniform stream (u, p) = (0.5, 1) on [0,2]x[0,0.5] with
    n x n/4 quads (an exact solution rho(x - u t)), Far-field sides left
    and right, Slip top and bottom, broken p1 states with p1 traces,
    DIRK-1,2 steps of 0.05 (0.2 / 4 at n = 8); the L2 norms of the
    state against the exact pulse. Quadrature 4, not the test's 3: at 3
    the 2x2 Gauss points of a broken p1 element make the projected
    initial state exact there, so its L2 at t = 0 would be round-off."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n,
                 "NY": max(n // 4, 1), "xmin": 0.0, "xmax": 2.0,
                 "ymin": 0.0, "ymax": 0.5},
        "Physics": {
            "modules": "Euler", "gamma": 1.4, stab: True,
            "Initial conditions": {
                "rho": PULSE, "rhoux": f"0.5*{PULSE}", "rhouy": "0.0",
                "rhoE": f"2.5 + 0.125*{PULSE}"},
            "Far-field conditions": {
                "rho": {"left": "1.0", "right": "1.0"},
                "rhoux": {"left": "0.5", "right": "0.5"},
                "rhouy": {"left": "0.0", "right": "0.0"},
                "rhoE": {"left": "2.625", "right": "2.625"}},
            "Slip conditions": {"rho": {"top": "0", "bottom": "0"}}},
        "Discretization": {"order": {"rho": 1}, "quadrature": 4},
        "Solver": _steps(0.05, steps, "DIRK-1,2",
                         **dict({"max nonlinear iters": 10,
                                 "nonlinear TOL": 1e-10}, **(solver or {}))),
        "Postprocess": {"compute errors": True, "True solutions": {
            "rho": PULSE.replace("x-0.5", "x-0.5-0.5*t"),
            "rhoux": "0.5*" + PULSE.replace("x-0.5", "x-0.5-0.5*t"),
            "rhouy": "0.0",
            "rhoE": "2.5 + 0.125*" + PULSE.replace("x-0.5", "x-0.5-0.5*t")}},
    }


# the JAX package's f64 CPU L2 of every label at every recorded time of
# each PHYSICS_DECKS deck (tools/jax_references.py DECK, the same deck
# functions)
PHYSICS_REFS = {}
PHYSICS_REFS["burgers_backtracking_gold_nx100"] = {
    0.0: {"u": 0.3540123425295318},
    0.001: {"u": 0.32958352143011943},
    0.002: {"u": 0.31388475411765393},
    0.003: {"u": 0.30161904608698376},
    0.004: {"u": 0.2913753642128912},
}
PHYSICS_REFS["helmholtz_gold_nx100"] = {
    0.0: {"uimag": 0.00022234821846722628, "ureal": 0.0005172667182451912},
}
PHYSICS_REFS["ks_wave_nx10"] = {
    0.0: {"u": 0.7071016787322177, "w": 0.0},
    0.001: {"u": 0.5522612526660605, "w": 6.474842315933968},
    0.002: {"u": 0.5060358319079303, "w": 5.047004012521376},
    0.003: {"u": 0.4646432459184302, "w": 4.623686460519792},
    0.004: {"u": 0.4266509178210092, "w": 4.245385482904524},
    0.005: {"u": 0.3917692317768597, "w": 3.898142509993867},
    0.006: {"u": 0.35974342401669984, "w": 3.5793057354039526},
    0.007: {"u": 0.3303397730960832, "w": 3.286549802456974},
    0.008: {"u": 0.30334375095366595, "w": 3.0177407791262834},
    0.009: {"u": 0.27855844066194824, "w": 2.7709194149252894},
    0.01: {"u": 0.25580308642162436, "w": 2.5442868420069846},
    0.011: {"u": 0.23491176427041957, "w": 2.3361914370251022},
    0.012: {"u": 0.2157321634633338, "w": 2.145116755150408},
    0.013: {"u": 0.19812446916249707, "w": 1.9696704536790433},
    0.014: {"u": 0.18196033784585225, "w": 1.808574125304784},
    0.015: {"u": 0.1671219575927691, "w": 1.6606539663777722},
    0.016: {"u": 0.15350118609611846, "w": 1.5248322112724657},
    0.017: {"u": 0.1409987598782262, "w": 1.4001192696235176},
    0.018: {"u": 0.12952356875555082, "w": 1.2856065084469819},
    0.019: {"u": 0.11899199010931458, "w": 1.1804596260028453},
    0.02: {"u": 0.10932727798220371, "w": 1.0839125686863174},
}
PHYSICS_REFS["shallowwater_droptest_gold_nx40"] = {
    0.0: {"H": 1.0032149643175396, "Hu": 0.0, "Hv": 0.0},
    0.001: {"H": 1.0032146521014367, "Hu": 0.0025051809155073185,
        "Hv": 0.002505180915507317},
    0.002: {"H": 1.0032137255377083, "Hu": 0.004989718501959955,
        "Hv": 0.004989718501959952},
    0.003: {"H": 1.0032122143767668, "Hu": 0.007433395727817461,
        "Hv": 0.007433395727817455},
    0.004: {"H": 1.0032101665600885, "Hu": 0.009816833593219325,
        "Hv": 0.00981683359321932},
    0.005: {"H": 1.0032076458763286, "Hu": 0.012121874560241636,
        "Hv": 0.012121874560241634},
}
PHYSICS_REFS["phasefield_3phi_gold_nx100"] = {
    0.0: {"phi1": 96.66791949095791, "phi2": 96.66791949095793,
        "phi3": 96.69320321304497},
    0.5: {"phi1": 96.77267328309175, "phi2": 96.78157608300222,
        "phi3": 96.94318102413511},
}
PHYSICS_REFS["vdns_channel_gold_nx50"] = {
    0.0: {"T": 1.75541673428835e-17, "pr": 0.01288871923600609,
        "ux": 0.001942096392967426, "uy": 8.182912618944312e-05},
}
PHYSICS_REFS["porous_verification_gold_nx40"] = {
    0.0: {"p": 0.0010277567668694498, "p#L2-face": 0.0017603025427893988,
        "p#L2-grad": 0.20139361265266592},
}
PHYSICS_REFS["hartmann_analytic_nx500"] = {
    0.0: {"b": 1.0622054296577546e-06, "u": 1.1261260633082536e-06},
}
PHYSICS_REFS["burgers_2d_evisc_supg_nx256"] = {
    0.0: {"u": 0.1772430868478512},
    0.01: {"u": 0.17693008660328272},
    0.02: {"u": 0.1766203488394884},
    0.03: {"u": 0.17631255645150776},
    0.04: {"u": 0.17600552884684828},
}
PHYSICS_REFS["helmholtz_nx512"] = {
    0.0: {"uimag": 7.806613100245951e-06, "ureal": 1.9737512449473583e-05},
}
PHYSICS_REFS["shallowwater_droptest_nx256"] = {
    0.0: {"H": 1.0032149644716406, "Hu": 0.0, "Hv": 0.0},
    0.001: {"H": 1.0032146520389829, "Hu": 0.0025060607502248623,
        "Hv": 0.0025060607502248606},
    0.002: {"H": 1.0032137248542359, "Hu": 0.004991426132077918,
        "Hv": 0.004991426132077916},
    0.003: {"H": 1.0032122127500391, "Hu": 0.00743583076889016,
        "Hv": 0.007435830768890156},
    0.004: {"H": 1.003210163793105, "Hu": 0.009819854372964103,
        "Hv": 0.009819854372964093},
    0.005: {"H": 1.003207641924439, "Hu": 0.012125307917392698,
        "Hv": 0.012125307917392686},
}
PHYSICS_REFS["phasefield_consistent_nx256"] = {
    0.0: {"phi1": 54.61894264263382, "phi2": 54.625771213250424,
        "phi3": 54.61894264263382},
    0.5: {"phi1": 54.7137514530592, "phi2": 54.7122465231369,
        "phi3": 54.827131514160115},
}
PHYSICS_REFS["vdns_channel_stab_nx128x32"] = {
    0.0: {"T": 2.608726512002472e-16, "pr": 0.0, "ux": 0.20412412900960128,
        "uy": 0.0},
    0.01: {"T": 1.4600302995332557e-16, "pr": 0.19140050205468634,
        "ux": 0.18602680606227548, "uy": 0.003342467826609561},
    0.02: {"T": 1.670656693217502e-16, "pr": 0.21532826618994613,
        "ux": 0.16965373962199878, "uy": 0.004025593619397677},
    0.03: {"T": 1.7828451207616058e-16, "pr": 0.21076055113566516,
        "ux": 0.1547580996237502, "uy": 0.004045183926213728},
    0.04: {"T": 1.880595470498099e-16, "pr": 0.1983439162797259,
        "ux": 0.14118315971702938, "uy": 0.003853502484884268},
}
PHYSICS_REFS["porous_compressible_nx256"] = {
    0.0: {"p": 0.4999999999999998, "p#L2-face": 181.01933598375618,
        "p#L2-grad": 4.442882938158364},
    0.05: {"p": 0.2459090700618107, "p#L2-face": 89.03745176655606,
        "p#L2-grad": 2.232930808326233},
    0.1: {"p": 0.2711282060529655, "p#L2-face": 98.16852065453052,
        "p#L2-grad": 2.447372740052618},
    0.15: {"p": 0.2725010627867254, "p#L2-face": 98.66557587202486,
        "p#L2-grad": 2.4584268586537292},
    0.2: {"p": 0.27258068440225386, "p#L2-face": 98.69440319061539,
        "p#L2-grad": 2.4590365191507013},
}
PHYSICS_REFS["ks_periodic_2d_nx64"] = {
    0.0: {"u": 0.49999999988474475, "w": 0.0},
    0.001: {"u": 0.06978215026461776, "w": 5.5141836098317585},
    0.002: {"u": 0.009740997999655276, "w": 0.7695802602941801},
    0.003: {"u": 0.0013733045474953836, "w": 0.10740552363186387},
    0.004: {"u": 0.00027292141834839745, "w": 0.01498991996367471},
}
PHYSICS_REFS["shallowice_nx256"] = {
    0.0: {"s": 2.5105023284455436e-05},
}
PHYSICS_REFS["hartmann_channel_nx256x64"] = {
    0.0: {"b": 2.025996888807249e-06, "u": 2.1479173156145356e-06},
}
PHYSICS_REFS["llamas_nx256"] = {
    0.0: {"llama": 2.4785622266313283e-05},
}
PHYSICS_REFS["phasesolidification_3d_nx32"] = {
    0.0: {"phi1": 0.3535533575349766, "phi2": 0.1767766787674883},
    0.01: {"phi1": 0.28357851143682916, "phi2": 0.1406746310091262},
    0.02: {"phi1": 0.22762739919500607, "phi2": 0.11219983390417093},
}
PHYSICS_REFS["inc_sat_wells_nx256x64"] = {
    0.0: {"S": 4.1917432401208256e-08},
    0.005: {"S": 0.0008082030030670742},
    0.01: {"S": 0.0016044849944451497},
    0.015: {"S": 0.0023891928750955226},
    0.02: {"S": 0.0031621878796920045},
}
PHYSICS_REFS["physics_test_nx256"] = {
    0.0: {"e": 0.4999999999999998},
    0.05: {"e": 0.10107014036458759},
    0.1: {"e": 0.02044632483965424},
    0.15: {"e": 0.004152233355124118},
    0.2: {"e": 0.000859193766044875},
}
PHYSICS_REFS["cns_pulse_2d_nx128"] = {
    0.0: {"rho": 1.0001574599349403, "rhoE": 2.500157231767945, "rhoux": 0.0,
        "rhouy": 0.0},
    0.005: {"rho": 1.0001574585346722, "rhoE": 2.5001572335594306,
        "rhoux": 2.2442757591318166e-05, "rhouy": 2.2442757591318526e-05},
    0.01: {"rho": 1.0001574546545327, "rhoE": 2.500157231786658,
        "rhoux": 4.04014720576086e-05, "rhouy": 4.040147205760727e-05},
    0.015: {"rho": 1.0001574488736458, "rhoE": 2.5001572272773016,
        "rhoux": 5.4968106209905284e-05, "rhouy": 5.496810620990538e-05},
    0.02: {"rho": 1.0001574416623464, "rhoE": 2.500157220770904,
        "rhoux": 6.685097130552392e-05, "rhouy": 6.685097130552448e-05},
}
PHYSICS_REFS["params_thermal_nonlinear_nx256"] = {
    0.0: {"e": 2.5099636346396307e-05},
}
PHYSICS_REFS["params_ns_channel_nx128"] = {
    0.0: {"pr": 0.0014361471164863364, "ux": 0.00018842896243938227,
        "uy": 1.225088645125545e-05},
}

# name -> (deck function of n, n on the card, the kernel each fused
# res_and_jac call launches (None: the general path), {time: the golds
# per label, each (value, rtol)}); PHYSICS_DECKS adds rtol 1e-6 and the
# JAX package's L2 (PHYSICS_REFS) as MESH_DECKS holds them. A label
# "var#L2-grad" is the norm of that kind (l2_key). A reference below
# ZERO_L2 (a field exact to round-off) is held as |L2| <= ZERO_L2.
_PHYSICS = {
    # the reference decks at the reference's size
    "burgers_backtracking_gold_nx100": (
        lambda n: burgers_deck(n, dim=1), 100, None, {
        t: {"u": (g, 2e-5)} for t, g in ((0.0, 0.354012), (0.001, 0.329584),
                                         (0.002, 0.313885),
                                         (0.004, 0.291375))}),
    "helmholtz_gold_nx100": (helmholtz_deck, 100, None, {0.0: {
        "ureal": (0.000517267, 2e-5), "uimag": (0.000222348, 2e-5)}}),
    "ks_wave_nx10": (ks_deck, 10, None, {}),
    "shallowwater_droptest_gold_nx40": (shallowwater_deck, 40, None, {
        0.005: {"H": (1.00321, 2e-5), "Hv": (0.0121219, 2e-4)}}),
    "phasefield_3phi_gold_nx100": (phasefield_deck, 100, None, {
        0.0: {"phi1": (96.6679, 2e-5), "phi2": (96.6679, 2e-5),
              "phi3": (96.6932, 2e-5)},
        0.5: {"phi1": (96.7726, 2e-5), "phi2": (96.7815, 2e-5),
              "phi3": (96.9442, 2e-5)}}),
    "vdns_channel_gold_nx50": (lambda n: vdns_deck(n, n // 5), 50, None, {
        0.0: {"ux": (0.0019421, 2e-5), "pr": (0.0128887, 2e-5),
              "uy": (8.18291e-05, 2e-5)}}),
    "porous_verification_gold_nx40": (porous_deck, 40, None, {0.0: {
        "p": (0.00102776, 2e-5), "p#L2-grad": (0.201394, 2e-5),
        "p#L2-face": (0.0017603, 2e-4)}}),
    "hartmann_analytic_nx500": (hartmann_deck, 500, None, {0.0: {
        "u": (1.126126e-06, 1e-4), "b": (1.062206e-06, 1e-4)}}),
    # full width
    "burgers_2d_evisc_supg_nx256": (
        lambda n: burgers_deck(n, evisc=True, supg=True), 256, None, {}),
    "helmholtz_nx512": (helmholtz_deck, 512, None, {}),
    "shallowwater_droptest_nx256": (shallowwater_deck, 256, None, {}),
    "phasefield_consistent_nx256": (
        lambda n: phasefield_deck(n, legacy=False), 256, None, {}),
    # 128x32, not 256x64: a dense solve (vdns_deck)
    "vdns_channel_stab_nx128x32": (
        lambda n: vdns_deck(n, n // 4, True, True, True, steps=4), 128,
        None, {}),
    # 256^2, not 512^2, for the script's time
    "porous_compressible_nx256": (
        lambda n: porous_deck(n, compressible=True), 256, None, {}),
    # 64^2, not 128^2: a dense solve (ks_deck)
    "ks_periodic_2d_nx64": (lambda n: ks_deck(n, dim=2, steps=4), 64, None,
                            {}),
    "shallowice_nx256": (shallowice_deck, 256, None, {}),
    "hartmann_channel_nx256x64": (lambda n: hartmann_deck(n, n // 4), 256,
                                  None, {}),
    "llamas_nx256": (llamas_deck, 256, None, {}),
    "phasesolidification_3d_nx32": (phasesolidification_deck, 32, None, {}),
    "inc_sat_wells_nx256x64": (lambda n: inc_sat_deck(n, n // 4), 256, None,
                               {}),
    "physics_test_nx256": (physics_test_deck, 256, None, {}),
    "cns_pulse_2d_nx128": (cns_deck, 128, None, {}),
    # coefficients that read parameters, on the B2 kernels
    "params_thermal_nonlinear_nx256": (params_thermal_deck, 256, "full", {}),
    "params_ns_channel_nx128": (params_ns_deck, 128, "ns_full", {}),
}
PHYSICS_DECKS = {name: (build, n, 1e-6, PHYSICS_REFS[name], mode, golds)
                 for name, (build, n, mode, golds) in _PHYSICS.items()}


# the JAX package's f64 CPU L2 of every label at every recorded time of
# each VECTOR_DECKS deck (tools/jax_references.py DECK, the same deck
# functions)
VECTOR_REFS = {}
VECTOR_REFS["porous_mixed_gold_nx8"] = {
    0.0: {"p": 0.15869740005830424, "u": 1.022593580038641,
        "u#L2-div": 12.39053856029592},
}
VECTOR_REFS["porous_mixed_hybrid_gold_nx8"] = {
    0.0: {"p": 0.15869740005830418, "u": 1.022593580038641},
}
VECTOR_REFS["porous_weak_galerkin_gold_nx10"] = {
    0.0: {"pbndry#L2-face": 1.2962023735951775, "pint": 0.12746858948238862,
        "t": 0.8140281011029156, "u": 0.8140281011029157},
}
VECTOR_REFS["maxwell_nonzero_ic_hex_nx8"] = {
    0.0: {"B": 0.09765226378404308, "E": 0.0692758156978673},
    0.01: {"B": 0.10133940908450413, "E": 0.07437289413974678},
}
VECTOR_REFS["maxwells_fp_3d_gold_nx5"] = {
    0.0: {"Aix": 0.013503027766972282, "Aiy": 0.012692267532182581,
        "Aiz": 0.025372822180136916, "Arx": 0.011541704498905682,
        "Ary": 0.010486532011249149, "Arz": 0.02096444751934515,
        "phii": 0.012406712223715107, "phir": 0.010816167091434096},
}
VECTOR_REFS["porous_mixed_schwarz_nx256"] = {
    0.0: {"p": 0.0050099183541630204, "u": 0.031479035469070236,
        "u#L2-div": 0.3955623339646647},
}
VECTOR_REFS["porous_mixed_hybrid_direct_nx64"] = {
    0.0: {"p": 0.020037150389791824, "u": 0.1259476829859878},
}
VECTOR_REFS["porous_weak_galerkin_gmres_nx256"] = {
    0.0: {"pbndry#L2-face": 1.2825712902689628, "pint": 0.005009918350005274,
        "t": 0.03147903545596277, "u": 0.03147903545596281},
}
VECTOR_REFS["maxwell_hex_gmres_nx32"] = {
    0.0: {"B": 0.02453548205930803, "E": 0.017352693138087405},
    0.01: {"B": 0.03644378137803634, "E": 0.03234985809943746},
    0.02: {"B": 0.05851422516223817, "E": 0.05775637303809612},
    0.03: {"B": 0.08212835756734131, "E": 0.08506246596613935},
    0.04: {"B": 0.1057575046243367, "E": 0.11293170703904293},
}
VECTOR_REFS["maxwells_fp_hex_direct_nx14"] = {
    0.0: {"Aix": 0.001736552605516885, "Aiy": 0.0016246007448365218,
        "Aiz": 0.0032473470170727202, "Arx": 0.0014677851137412101,
        "Ary": 0.0013233887617844495, "Arz": 0.0026454387734226852,
        "phii": 0.001585170370982942, "phir": 0.001368439761994528},
}
VECTOR_REFS["swe_hybridized_nx512"] = {
    0.0: {"H": 1.0032149644716413, "Hux": 0.0, "Huy": 0.0},
    0.001: {"H": 1.0032148045475324, "Hux": 0.0012817460556244717,
        "Huy": 0.001281746055624472},
    0.002: {"H": 1.0032143274777048, "Hux": 0.0025578717625337555,
        "Huy": 0.0025578717625337555},
    0.003: {"H": 1.0032135412962022, "Hux": 0.0038228235291552794,
        "Huy": 0.003822823529155278},
    0.004: {"H": 1.0032124591512588, "Hux": 0.005071179775560772,
        "Huy": 0.0050711797755607696},
    0.005: {"H": 1.003211098952772, "Hux": 0.006297713246743657,
        "Huy": 0.006297713246743652},
}
VECTOR_REFS["euler_hdg_maxev_nx128"] = {
    0.0: {"rho": 4.6878707234167606e-05, "rhoE": 5.859838404294546e-06,
        "rhoux": 2.3439353617083803e-05, "rhouy": 0.0},
    0.05: {"rho": 0.00011887681847271158, "rhoE": 1.4859602305318958e-05,
        "rhoux": 5.943840923503488e-05, "rhouy": 6.37558619871526e-16},
    0.1: {"rho": 0.0002117544700219644, "rhoE": 2.646930873128963e-05,
        "rhoux": 0.00010587723500465827, "rhouy": 3.5991310232875757e-16},
    0.15: {"rho": 0.0003138515852530989, "rhoE": 3.923144809407252e-05,
        "rhoux": 0.0001569257926084482, "rhouy": 6.280583663684748e-16},
    0.2: {"rho": 0.00041528361426353757, "rhoE": 5.191045165429306e-05,
        "rhoux": 0.0002076418070949012, "rhouy": 4.659858140136251e-16},
}

# GMRES with the element-Schwarz preconditioner: the Krylov solve that
# converges the mixed saddle point in the JAX package (Jacobi divides by
# its zero pressure diagonal); every Newton step stops at the 2,000
# iteration cap, so Newton iterates to 1e-9 as iterative refinement
MIXED_SCHWARZ = {"Belos solver": "Block GMRES",
                 "preconditioner variant": "schwarz",
                 "max nonlinear iters": 10, "nonlinear TOL": 1e-9}
GMRES = {"Belos solver": "Block GMRES"}
# weak Galerkin: GMRES without a preconditioner converges it in the JAX
# package (Jacobi divides by its zero trace diagonal, element-Schwarz and
# AggregationAMG stall)
WG_GMRES = {"Belos solver": "Block GMRES", "use preconditioner": False}

# name -> (deck function of n, n on the card, rtol of the JAX L2, {time:
# the golds per label, each (value, rtol)}); no deck has a fused
# provider or launches a kernel: the general path, as in the JAX package
_VECTOR = {
    # the reference decks at the reference's size, direct
    "porous_mixed_gold_nx8": (porous_mixed_deck, 8, 1e-6, {0.0: {
        "p": (0.158697, 2e-5), "u": (1.02259, 2e-5),
        "u#L2-div": (12.390539, 1e-4)}}),
    "porous_mixed_hybrid_gold_nx8": (
        lambda n: porous_mixed_deck(n, hybrid=True), 8, 1e-6, {0.0: {
            "p": (0.158697, 2e-5), "u": (1.02259, 2e-5)}}),
    "porous_weak_galerkin_gold_nx10": (weak_galerkin_deck, 10, 1e-6, {0.0: {
        "pint": (0.127469, 2e-5), "pbndry#L2-face": (1.2962, 2e-5),
        "u": (0.814028, 2e-5), "t": (0.814028, 2e-5)}}),
    "maxwell_nonzero_ic_hex_nx8": (maxwell_deck, 8, 1e-6, {
        0.0: {"E": (0.0692758, 2e-5), "B": (0.0976523, 2e-5)},
        0.01: {"E": (0.0743729, 2e-5), "B": (0.101339, 2e-5)}}),
    "maxwells_fp_3d_gold_nx5": (maxwells_fp_deck, 5, 1e-6, {0.0: {
        v: (g, 2e-5) for v, g in (
            ("Arx", 0.0115417), ("Aix", 0.013503), ("phir", 0.0108162),
            ("phii", 0.0124067), ("Ary", 0.0104865), ("Aiy", 0.0126923),
            ("Arz", 0.0209644), ("Aiz", 0.0253728))}}),
    # full width
    "porous_mixed_schwarz_nx256": (
        lambda n: porous_mixed_deck(n, MIXED_SCHWARZ), 256, 1e-4, {}),
    # 64^2, not 256^2: no Krylov solve converges it in the JAX package
    # beyond 64^2, so a dense solve (28,800 DOFs)
    "porous_mixed_hybrid_direct_nx64": (
        lambda n: porous_mixed_deck(n, hybrid=True), 64, 1e-6, {}),
    "porous_weak_galerkin_gmres_nx256": (
        lambda n: weak_galerkin_deck(n, WG_GMRES), 256, 1e-6, {}),
    "maxwell_hex_gmres_nx32": (
        lambda n: maxwell_deck(n, steps=4, solver=GMRES), 32, 1e-6, {}),
    # 14^3, not 24^3: GMRES with Jacobi or element-Schwarz stalls on the
    # complex-shifted system (16^3 and 24^3), so a dense solve (27,000 DOFs)
    "maxwells_fp_hex_direct_nx14": (maxwells_fp_deck, 14, 1e-6, {}),
    "swe_hybridized_nx512": (swe_hybridized_deck, 512, 1e-6, {}),
    "euler_hdg_maxev_nx128": (euler_hdg_deck, 128, 1e-6, {}),
}
VECTOR_DECKS = {name: (build, n, rtol, VECTOR_REFS.get(name, {}), None,
                       golds)
                for name, (build, n, rtol, golds) in _VECTOR.items()}

def _jacobian_on(J, device):
    """The BlockJacobian J with its tensors on `device`: the same numbers
    (the phase's Jacobians have no boundary groups)."""
    import dataclasses
    assert not J.bnd

    def to(t):
        return None if t is None else t.to(device)
    return dataclasses.replace(
        J, vol=to(J.vol), vol_lids=to(J.vol_lids), fixed=to(J.fixed),
        inc=to(J.inc), _aos_cache=None,
        vol_soa=None if J.vol_soa is None else [to(r) for r in J.vol_soa])


def preconditioners(problem):
    """{variant: J -> M} of the solver layer on the problem's assembler:
    the precond.py builders, SIMPLE on a deck with a pressure (its dofs
    masked), and the V-cycles of StructuredMG and AggregationAMG (each
    hierarchy built here, once; its seconds in the second value)."""
    from mrhyde_tpu_torch.solvers import precond
    from mrhyde_tpu_torch.solvers.amg import AggregationAMG
    from mrhyde_tpu_torch.solvers.multigrid import StructuredMG
    asm = problem.assembler
    out = {"jacobi": precond.jacobi_precond,
           "chebyshev": precond.chebyshev_precond,
           "schwarz": precond.element_schwarz_precond}
    if "pr" in problem.disc.var_names:
        mask = torch.zeros(problem.n_dof, dtype=torch.bool,
                           device=asm.device)
        mask[torch.as_tensor(problem.disc.dofmap.all_dofs("pr"),
                             device=asm.device)] = True
        out["simple"] = lambda J: precond.fieldsplit_simple_precond(J, mask)
    setup = {}
    for name, cls in (("structured_mg", StructuredMG),
                      ("amg", AggregationAMG)):
        t0 = time.perf_counter()
        out[name] = cls(asm).preconditioner
        setup[name] = time.perf_counter() - t0
    return out, setup


def phase_precond(device):
    """Each preconditioner's M(v) on the card against the host's, from
    the same Jacobian (assembled on the card at a seeded state, copied to
    the host) and the same seeded v, in f64: max |card - host| <=
    PRECOND_RTOL max |host|. Records each variant's build (one call) and
    apply (CUDA-event median of 10) ms on the card, and the hierarchies'
    host set-up s. Returns {deck: record}."""
    import numpy as np
    from mrhyde_tpu_torch.problem import Problem
    out = {}
    for name, build in PRECOND_DECKS.items():
        card = Problem(build(), device=device)
        host = Problem(build(), device="cpu")
        rng = np.random.RandomState(7)
        u = torch.as_tensor(0.3 * rng.randn(card.n_dof), dtype=card.dtype,
                            device=device)
        _r, J = card.assembler.res_and_jac(u, assembly_tc(card, u, 0.01))
        Jh = _jacobian_on(J, "cpu")
        vh = torch.as_tensor(rng.randn(card.n_dof), dtype=card.dtype)
        v = vh.to(device)
        on_card, setup = preconditioners(card)
        on_host, _ = preconditioners(host)
        rec = {"phase": "precond", "deck": name, "n_dof": card.n_dof,
               "nd": J.vol_lids.shape[1], "soa": J.vol is None,
               "hierarchy_setup_s": setup, "variants": {}}
        ok = True
        for variant, make in on_card.items():
            M, build_ms = timed(lambda: make(J))
            z = M(v)
            zh = on_host[variant](Jh)(vh)
            err, scale = max_err(z.cpu(), zh)
            good = bool(torch.isfinite(z).all()) and err <= PRECOND_RTOL * scale
            ok = ok and good
            rec["variants"][variant] = {
                "max_abs_err": err, "max_abs_host": scale,
                "rel_err": err / scale, "build_ms": build_ms,
                "apply_ms": cuda_ms(lambda: M(v), reps=10), "ok": good}
        rec["ok"] = ok
        emit(rec)
        if not ok:
            raise SystemExit(f"phase precond failed: {rec}")
        out[name] = rec
    return out


def _small(cfg, mesh):
    """The deck on 4x2x2 hex or 4x4 p2 quads: where a phase 3g case takes
    its weak form and row classes from."""
    cfg["Mesh"].update({"NX": 4, "NY": 2, "NZ": 2} if mesh == "hex"
                       else {"NX": 4, "NY": 4})
    return cfg


def ns_thermal_stage_deck(mesh):
    """ns_thermal_channel_deck with SUPG, transient (a DIRK-2,2 stage)."""
    cfg = ns_thermal_channel_deck(mesh, 4)
    cfg["Physics"]["useSUPG"] = True
    cfg["Solver"] = dict(NS_STARTUP_SOLVER)
    return cfg


# phase 3g: name -> (mesh, deck function, box, stage alphas or None, time
# step); each case's weak form and row classes come from its deck at
# 4x2x2 (hex) or 4x4 (p2), its element size from the shape; the six
# generated sources are those of SET_ELEM_DECKS
SET_ELEM_KERNEL_CASES = {
    "ns+thermal pspg steady": (
        "hex", lambda: ns_thermal_channel_deck("hex", 4), CHANNEL, None,
        1.0),
    "ns+cdr pspg+supg dirk22 stage 1": (
        "hex", lambda: add_cdr(ns_elem_startup_deck("hex", 4)), CHANNEL,
        NS_STAGE1, 0.01),
    "ns+thermal advected pspg+supg dirk22 stage 1": (
        "p2", lambda: ns_thermal_stage_deck("p2"), CHANNEL, NS_STAGE1,
        0.01),
    "ns viscosity 1 + 0.1 ux^2 pspg steady": (
        "hex", lambda: ns_elem_visc_deck(4), CHANNEL, None, 1.0),
    "thermal+cdr kappa = 1 + e*c steady": (
        "p2", lambda: thermal_cdr_deck(4, "p2"), (1.0, 1.0), None, 1.0),
    "cdr velocity (c, 1, 0.5) steady": (
        "hex", lambda: cdr_deck(4, CDR3_SOURCE, vel=("c", "1.0", "0.5"),
                                mesh="hex"), (1.0, 1.0, 1.0), None, 1.0),
}
SET_ELEM_SHAPES = {"hex": ((64, 64, 64), (31, 23, 15)),
                   "p2": ((512, 128), (250, 61))}


def set_elem_case(name, h):
    """(SetForm at element size h, SetScalars, jac_idx, Stage or None) of
    a phase 3g case, from its deck at 4x2x2 / 4x4 on the CPU."""
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    from mrhyde_tpu_torch.ops.fused_set import SetForm, SetScalars
    from mrhyde_tpu_torch.problem import Problem
    mesh, build, _box, alphas, dt = SET_ELEM_KERNEL_CASES[name]
    fused = Problem(_small(build(), mesh), device="cpu",
                    dtype=torch.float64).assembler.fused_provider()
    f = fused.form
    form = SetForm(f.modules, f.fm, f.variables, f.params, h, f.transient,
                   f.dim, f.nc)
    sc = SetScalars(0.0125, dt, ())
    au, at = alphas or (1.0, 0.0)
    jac_idx = fused._classify(sc, au, at, alphas is None)[0]
    return form, sc, jac_idx, None if alphas is None else Stage(au, at,
                                                                None)


def phase_set_elem_kernels(device, shapes=SET_ELEM_SHAPES):
    """set_elem_full (each case's generated kernel) against its plain
    version (residual rows and Jacobian rows each within rtol of its max
    |plain|) on hex and p2, f64 and f32, with CUDA-event medians of 20
    (kernel), the plain version's one check call and the bound of each
    case. Returns {case: its f64 record at the first (divisible) shape}."""
    import math
    from mrhyde_tpu_torch.ops import fused_set as fs
    summary = {}
    for name, (mesh, _build, box, _alphas, _dt) in \
            SET_ELEM_KERNEL_CASES.items():
        for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            for i, dims in enumerate(shapes[mesh]):
                gen = torch.Generator(device=device).manual_seed(2468)
                tab, lat, q_off = elem_tables(mesh, dims, device, dtype,
                                              box)
                form, sc, jac_idx, stage = set_elem_case(
                    name, math.fsum(tab.wts) ** (1.0 / tab.dim))
                geo = ((0.0,) * tab.dim,
                       tuple(b / n for b, n in zip(box, dims)), q_off)
                ue, ud = set_inputs(len(form.variables), dims, lat, device,
                                    dtype, gen, stage)
                args = (form, ue, ud, sc, tab, lat, geo, jac_idx, stage)
                ref, plain_ms = timed(lambda: fs.set_elem_full_plain(*args))
                out = fs.set_elem_full(*args)
                torch.cuda.synchronize()
                errs = [max_err(o, r) for o, r in zip(out, ref)]
                del out, ref
                err = max(e for e, _ in errs)
                ok = all(e <= rtol * sc_ for e, sc_ in errs)
                nbytes, nflops = set_elem_work(dims, dtype, *args)
                rec = {"phase": "kernels_set_elem",
                       "kernel": "set_elem_full", "case": name,
                       "mesh": mesh,
                       "dtype": str(dtype).replace("torch.", ""),
                       "shape": list(dims),
                       "variables": list(form.variables),
                       "nd": len(form.variables) * len(lat.offsets),
                       "jac_rows": len(jac_idx), "max_abs_err": err,
                       "max_abs_err_res": errs[0][0],
                       "max_abs_plain_res": errs[0][1],
                       "max_abs_err_jac": errs[1][0],
                       "max_abs_plain_jac": errs[1][1], "rtol": rtol,
                       "ok": ok,
                       "ms": cuda_ms(lambda: fs.set_elem_full(*args)),
                       "plain_ms": plain_ms,
                       **bound(nbytes, nflops, dtype)}
                rec["share"] = rec["bound_ms"] / rec["ms"]
                emit(rec)
                if not ok:
                    raise SystemExit(f"set_elem_full {name} disagrees with "
                                     f"its plain version: {rec}")
                if dtype == torch.float64 and i == 0:
                    summary[name] = rec
    return summary


# ----------------------------------------------------------------------
# phase 3h: mode "state" of affine module sets (set_node_state on 2D p1,
# set_elem_state on hex and p2); phase 3i: the set and NS element kernels
# past 27 qps and set_node_full past 16, which their layouts held at most
# before they took any quadrature
# ----------------------------------------------------------------------

# name -> (mesh, deck function, box, stage alphas or None, time step); each
# case's weak form comes from its deck at size 4 (hex 3) on the CPU, which
# must find the set affine; the generated sources are those of
# AFFINE_SET_DECKS
STATE_KERNEL_CASES = {
    "thermal+cdr affine steady": (
        "p1", lambda: thermal_cdr_affine_deck(4), (1.0, 1.0), None, 1.0),
    "thermal+cdr affine dirk22 stage 1": (
        "p1", lambda: thermal_cdr_affine_deck(4, transient=True),
        (1.0, 1.0), DIRK22_STAGE1, 0.05),
    "thermal+cdr affine hex steady": (
        "hex", lambda: thermal_cdr_affine_deck(3, "hex"), (1.0, 1.0, 1.0),
        None, 1.0),
    "thermal+cdr affine hex dirk22 stage 1": (
        "hex", lambda: thermal_cdr_affine_deck(3, "hex", transient=True),
        (1.0, 1.0, 1.0), DIRK22_STAGE1, 0.05),
    "thermal+cdr affine p2 steady": (
        "p2", lambda: thermal_cdr_affine_deck(4, "p2"), (1.0, 1.0), None,
        1.0),
    "thermal+cdr affine p2 dirk22 stage 1": (
        "p2", lambda: thermal_cdr_affine_deck(4, "p2", transient=True),
        (1.0, 1.0), DIRK22_STAGE1, 0.05),
    # kappa = 1 + 0.5 x: the state part's linearization differs at every
    # qp (tests/torch_port_utils.py thermal_cdr_affine_cfg's diffusion)
    "thermal+cdr affine kappa=1+0.5x steady": (
        "p1", lambda: thermal_cdr_affine_deck(4, kappa="1.0 + 0.5*x"),
        (1.0, 1.0), None, 1.0),
    "thermal+cdr affine hex kappa=1+0.5x steady": (
        "hex", lambda: thermal_cdr_affine_deck(3, "hex", kappa="1.0 + 0.5*x"),
        (1.0, 1.0, 1.0), None, 1.0),
}
STATE_SHAPES = {"p1": ((1024, 1024), (1000, 777)),
                "hex": ((64, 64, 64), (31, 23, 15)),
                "p2": ((512, 512), (250, 161))}


_STATE_FORMS = {}


def state_case(name, h):
    """(SetForm at element size h, SetScalars, Stage or None) of a phase
    3h case, from its deck on the CPU (which finds the set affine; one
    Problem per case)."""
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    from mrhyde_tpu_torch.ops.fused_set import SetForm, SetScalars
    from mrhyde_tpu_torch.problem import Problem
    _mesh, build, _box, alphas, dt = STATE_KERNEL_CASES[name]
    if name not in _STATE_FORMS:
        fused = Problem(build(), device="cpu", dtype=torch.float64) \
            .assembler.fused_provider()
        if not fused._detect_affine(alphas is None):
            raise SystemExit(f"phase 3h case {name}: the set is not affine")
        _STATE_FORMS[name] = fused.form
    f = _STATE_FORMS[name]
    form = SetForm(f.modules, f.fm, f.variables, f.params, h, f.transient,
                   f.dim, f.nc)
    sc = SetScalars(0.0125, dt, ())
    return form, sc, None if alphas is None else Stage(*alphas, None)


def phase_state_kernels(device, shapes=STATE_SHAPES):
    """set_node_state (2D p1) and set_elem_state (hex, p2) against their
    plain versions (within rtol of max |plain|), f64 and f32, at a
    divisible and a non-divisible shape, steady and at a DIRK-2,2 stage,
    with CUDA-event medians of 20 (kernel), the plain version's one check
    call and the bound of each case. Returns {kernel: its quoted record
    (f64, the first shape, the stage; set_elem_state: hex), "cases":
    every f64 record at the first shape}."""
    import math
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops.fused_p1 import QUAD_P1
    summary = {"cases": []}
    for name, (mesh, _build, box, alphas, _dt) in \
            STATE_KERNEL_CASES.items():
        node = mesh == "p1"
        kernel = "set_node_state" if node else "set_elem_state"
        for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            for i, dims in enumerate(shapes[mesh]):
                gen = torch.Generator(device=device).manual_seed(1357)
                if node:
                    tab, q_off = quad_tables(*dims, device, dtype, *box)
                    lat = QUAD_P1
                else:
                    tab, lat, q_off = elem_tables(mesh, dims, device, dtype,
                                                  box)
                form, sc, stage = state_case(
                    name, math.fsum(tab.wts) ** (1.0 / tab.dim))
                geo = ((0.0,) * tab.dim,
                       tuple(b / n for b, n in zip(box, dims)), q_off)
                u, _ = set_inputs(len(form.variables), dims, lat, device,
                                  dtype, gen, None)
                if node:
                    args = (form, u, sc, tab, geo, stage)
                    plain, fn = fs.set_node_state_plain, fs.set_node_state
                else:
                    args = (form, u, sc, tab, lat, geo, stage)
                    plain, fn = fs.set_elem_state_plain, fs.set_elem_state
                ref, plain_ms = timed(lambda: plain(*args))
                out = fn(*args)
                torch.cuda.synchronize()
                err, scale = max_err(out, ref)
                del out, ref
                ok = err <= rtol * scale
                nbytes, nflops = state_work(dims, dtype, form, u, sc, tab,
                                            lat, stage, node)
                rec = {"phase": "kernels_state", "kernel": kernel,
                       "case": name, "mesh": mesh,
                       "dtype": str(dtype).replace("torch.", ""),
                       "shape": list(dims),
                       "variables": list(form.variables),
                       "max_abs_err": err, "max_abs_plain": scale,
                       "rtol": rtol, "ok": ok,
                       "ms": cuda_ms(lambda: fn(*args)),
                       "plain_ms": plain_ms, **bound(nbytes, nflops, dtype)}
                rec["share"] = rec["bound_ms"] / rec["ms"]
                emit(rec)
                if not ok:
                    raise SystemExit(f"{kernel} {name} disagrees with its "
                                     f"plain version: {rec}")
                if dtype == torch.float64 and i == 0:
                    summary["cases"].append(rec)
                    if alphas is not None and mesh != "p2":
                        summary[kernel] = rec
    return summary


# phase 3i: kernel -> (deck function of its weak form and rows, mesh,
# quadrature, box, shape); f64 and f32 at one non-divisible shape (the
# last block partial), the plain version's time its one check call
QUADRATURE_CASES = {
    "ns_elem_full": (lambda: ns_elem_deck("hex", 4, NS_DIRECT), "hex", 6,
                     CHANNEL, (31, 23, 15)),
    "set_elem_full": (lambda: ns_thermal_channel_deck("hex", 4), "hex", 6,
                      CHANNEL, (31, 23, 15)),
    "set_node_full": (lambda: ns_visc_deck(8), "p1", 8, CHANNEL[:2],
                      (1000, 243)),
    "ns_node_full": (lambda: ns_deck(4, 1, NS_DIRECT), "p1", 8, CHANNEL[:2],
                     (1000, 243)),
    # quadrature 4 (Q = 9): thermal_node_state's runtime-Q instance
    "thermal_node_state": (lambda: deck(4), "p1", 4, (1.0, 1.0),
                           (1000, 777)),
}


def quadrature_case(kernel, h):
    """(SetForm at element size h, or None for the kernels of one module;
    jac_idx, None for thermal_node_state) of a phase 3i case, from its
    deck at small size on the CPU. The row classes come from the deck at
    its own quadrature (which classes vary does not depend on the qps;
    each plain version checks it), the costlier probe at Q = 64 left
    out."""
    from mrhyde_tpu_torch.ops.fused_set import SetForm, SetScalars
    from mrhyde_tpu_torch.problem import Problem
    build, mesh, _quad, _box, _dims = QUADRATURE_CASES[kernel]
    if kernel in ("ns_elem_full", "ns_node_full"):
        return None, ns_rows(True, False, False, False, mesh)
    if kernel == "thermal_node_state":
        return None, None
    cfg = build()
    if mesh == "hex":
        cfg = _small(cfg, mesh)
    fused = Problem(cfg, device="cpu", dtype=torch.float64) \
        .assembler.fused_provider()
    f = fused.form
    form = SetForm(f.modules, f.fm, f.variables, f.params, h, f.transient,
                   f.dim, f.nc)
    return form, fused._classify(SetScalars(0.0, 1.0, ()), 1.0, 0.0,
                                 True)[0]


def phase_quadrature_kernels(device):
    """ns_elem_full and set_elem_full on hex at quadrature 6 (Q = 64),
    set_node_full and ns_node_full (PSPG) on 2D p1 at quadrature 8 (Q =
    25) and thermal_node_state (kappa = 1 + 0.5 x y) at quadrature 4 (Q =
    9, its runtime-Q instance), steady, against their plain versions (f64
    1e-12, f32 1e-5 of max |plain|), with CUDA-event medians of 20 and
    the bound. Returns {kernel: its f64 record}."""
    import math
    from mrhyde_tpu_torch.ops import fused_ns as fn
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops.fused_p1 import QUAD_P1
    from mrhyde_tpu_torch.ops.fused_set import SetScalars
    summary = {}
    for kernel, (_build, mesh, quad, box, dims) in QUADRATURE_CASES.items():
        case = None
        for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            gen = torch.Generator(device=device).manual_seed(9753)
            if mesh == "p1":
                tab, q_off = quad_tables(*dims, device, dtype, *box,
                                         quadrature=quad)
                lat = QUAD_P1
            else:
                tab, lat, q_off = elem_tables(mesh, dims, device, dtype,
                                              box, quad)
            h = math.fsum(tab.wts) ** (1.0 / tab.dim)
            case = case or quadrature_case(kernel, h)
            form, jac_idx = case
            geo = ((0.0,) * tab.dim, tuple(b / n for b, n in zip(box, dims)),
                   q_off)
            sc = SetScalars(0.0, 1.0, ())
            if kernel == "thermal_node_state":
                u, kxy = qp_inputs(*dims, tab, q_off, device, dtype,
                                   gen)[:2]
                args = (u, kxy, tab)
                plain, call = fp.thermal_node_state_plain, \
                    fp.thermal_node_state
                work = thermal_work("state", *dims, tab.Q, dtype, kxy, None)
            elif kernel == "ns_node_full":
                ue = ns_inputs(*dims, tab, q_off, device, dtype, gen)[0]
                args = (ue, None, (1.0, 1.0, 1.0, 0.0), tab,
                        fn.NSForm(True, False, h, 1.0, False), jac_idx)
                plain, call = fn.ns_node_full_plain, fn.ns_node_full
                work = ns_work(*dims, tab.Q, dtype, args)
            elif kernel == "ns_elem_full":
                ue = set_inputs(tab.dim + 1, dims, lat, device, dtype, gen,
                                None)[0]
                src = (1.0,) + (0.0,) * (tab.dim - 1)
                args = (ue, None, (1.0, 1.0, *src), tab, lat,
                        fn.NSForm(True, False, h, 1.0, False), jac_idx)
                plain, call = fn.ns_elem_full_plain, fn.ns_elem_full
                work = ns_elem_work(dims, dtype, args)
            else:
                ue = set_inputs(len(form.variables), dims, lat, device,
                                dtype, gen, None)[0]
                if mesh == "p1":
                    args = (form, ue, None, sc, tab, geo, jac_idx, None)
                    plain, call = fs.set_node_full_plain, fs.set_node_full
                    work = set_work(*dims, dtype, *args)
                else:
                    args = (form, ue, None, sc, tab, lat, geo, jac_idx,
                            None)
                    plain, call = fs.set_elem_full_plain, fs.set_elem_full
                    work = set_elem_work(dims, dtype, *args)
            ref, plain_ms = timed(lambda: plain(*args))
            out = call(*args)
            torch.cuda.synchronize()
            # thermal_node_state: the node residual alone, no rows
            errs = [max_err(out, ref), (0.0, 0.0)] if jac_idx is None \
                else [max_err(o, r) for o, r in zip(out, ref)]
            del out, ref
            err = max(e for e, _ in errs)
            ok = all(e <= rtol * sc_ for e, sc_ in errs)
            rec = {"phase": "kernels_quadrature", "kernel": kernel,
                   "mesh": mesh, "quadrature": quad, "Q": tab.Q,
                   "dtype": str(dtype).replace("torch.", ""),
                   "shape": list(dims),
                   "jac_rows": len(jac_idx) if jac_idx else 0,
                   "max_abs_err": err, "max_abs_err_res": errs[0][0],
                   "max_abs_plain_res": errs[0][1],
                   "max_abs_err_jac": errs[1][0],
                   "max_abs_plain_jac": errs[1][1], "rtol": rtol, "ok": ok,
                   "ms": cuda_ms(lambda: call(*args)), "plain_ms": plain_ms,
                   **bound(*work, dtype)}
            rec["share"] = rec["bound_ms"] / rec["ms"]
            emit(rec)
            if not ok:
                raise SystemExit(f"{kernel} at Q = {tab.Q} disagrees with "
                                 f"its plain version: {rec}")
            if dtype == torch.float64:
                summary[kernel] = rec
    return summary


ADVECT_SHAPES = (("p1", KERNEL_SHAPES[0]), ("p1", KERNEL_SHAPES[1]),
                 *ELEM_SHAPES)


def advect_call(mesh, kind, plain, head, tab, lat, stage, vel):
    """One call of the thermal kernel of this mesh (node kernels on p1,
    element kernels on hex and p2) and kind ("state", "full"), or of its
    plain version: head is (grid, kappa) or (grid, S, dS, K, dK)."""
    from mrhyde_tpu_torch.ops import fused_elem as fe
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    suffix = "_plain" if plain else ""
    if mesh == "p1":
        return getattr(fp, f"thermal_node_{kind}{suffix}")(*head, tab, stage,
                                                           vel)
    return getattr(fe, f"thermal_elem_{kind}{suffix}")(*head, tab, lat,
                                                       stage, vel)


def phase_advect_kernels(device):
    """The four thermal kernels with advection (their ADVECT
    instantiations, which cdr and thermal's 'include advection' run)
    against their plain versions, on phases 3 and 3c's shapes, f64 and
    f32 (the same bounds): "state" with kappa 1 or 0.5 and "full" on the
    kappa = 1 + e*e inputs, each steady and at DIRK-2,2 stage-1 alphas
    with m = 1 (cdr), with the velocity (2, 1[, 0.5]) scalar and the
    rotating field (-4 (y - 0.5), 4 (x - 0.5)[, 0.5 + 0.25 z]) per qp;
    CUDA-event medians of 20 (plain: its one check call). Returns the
    quoted case of each kernel: f64, the steady scalar velocity (the main
    path's case), B2 at 1024^2 and B1 on hex at 128^3."""
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    summary = {}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for mesh, dims in ADVECT_SHAPES:
            gen = torch.Generator(device=device).manual_seed(1357)
            if mesh == "p1":
                tab, q_off = quad_tables(*dims, device, dtype)
                lat = fp.QUAD_P1
            else:
                tab, lat, q_off = elem_tables(mesh, dims, device, dtype)
            u, _kxy, _mx, full, (ue, tr) = elem_inputs(
                dims, tab, lat, q_off, device, dtype, gen)
            xs = qp_xyz(dims, q_off, tab.Q, device, dtype)
            rot = [(-4.0 * (xs[1] - 0.5)).contiguous(),
                   (4.0 * (xs[0] - 0.5)).contiguous(),
                   (0.5 + 0.25 * xs[-1]).contiguous()][:tab.dim]
            const = [2.0, 1.0, 0.5][:tab.dim]
            st1 = fp.Stage(*DIRK22_STAGE1, 1.0)
            b3 = ",0.5" if tab.dim == 3 else ""
            cases = []
            for vname, vel in ((f"b=(2,1{b3})", const), ("b rotating", rot)):
                cases += [
                    ("state", f"{vname} kappa=1", (u, 1.0), None, vel),
                    ("state", f"dirk22 {vname} kappa=0.5 m=1", (u, 0.5), st1,
                     vel),
                    ("full", f"{vname} kappa=1+e*e", (u, *full), None, vel),
                    ("full", f"dirk22 {vname} kappa=1+e*e m=1", (ue, *tr),
                     st1, vel)]
            for kind, label, head, stage, vel in cases:
                def kern():
                    return advect_call(mesh, kind, False, head, tab, lat,
                                       stage, vel)

                def plain():
                    return advect_call(mesh, kind, True, head, tab, lat,
                                       stage, vel)
                ref, plain_ms = timed(plain)
                out = kern()
                torch.cuda.synchronize()
                pairs = [max_err(o, r) for o, r in
                         (zip(out, ref) if isinstance(ref, tuple)
                          else [(out, ref)])]
                err = max(e for e, _ in pairs)
                ok = all(e <= rtol * sc for e, sc in pairs)
                if mesh == "p1":
                    nbytes, nflops = thermal_work(
                        kind, *dims, tab.Q, dtype, head[1] if kind ==
                        "state" else None, stage, head[1:] if kind == "full"
                        else (), vel)
                else:
                    nbytes, nflops = elem_work(
                        kind, u, dims, tab, dtype, head[1] if kind ==
                        "state" else None, stage, head[1:] if kind == "full"
                        else (), vel)
                name = (f"thermal_node_{kind}" if mesh == "p1"
                        else f"thermal_elem_{kind}")
                rec = {"phase": "kernels_advect", "kernel": name,
                       "case": label, "mesh": mesh,
                       "dtype": str(dtype).replace("torch.", ""),
                       "shape": list(dims), "max_abs_err": err,
                       "max_abs_plain": max(sc for _, sc in pairs),
                       "rtol": rtol, "ok": ok, "ms": cuda_ms(kern),
                       "plain_ms": plain_ms,
                       **bound(nbytes, nflops, dtype)}
                emit(rec)
                if not ok:
                    raise SystemExit(f"{name} {label} disagrees with its "
                                     f"plain version: {rec}")
                if dtype == torch.float64 and stage is None \
                        and vel is const and (mesh, dims) in (
                            ("p1", KERNEL_SHAPES[0]), ELEM_SHAPES[0]):
                    summary[name] = rec
    return summary


# ----------------------------------------------------------------------
# bounds: bytes (each input read once, each output written once) over
# 3.35 TB/s, and the operations the function needs (an FMA is 2, a
# divide or a square root 1; the thermal ones counted by hand from the
# weak form, the Navier-Stokes ones by ns_ops) over the card's peak for
# their type: 34 TFLOP/s in f64 and 67 TFLOP/s in f32 outside the tensor
# cores (NVIDIA's H100 SXM data sheet)
# ----------------------------------------------------------------------

HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}


def bound(nbytes, nflops, dtype):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = nflops / PEAK_FLOPS[dtype] * 1e3
    return {"bytes": nbytes, "flops": nflops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _qp_len(v):
    return v.numel() if isinstance(v, torch.Tensor) else 0


# The operations are those the function needs: each element's quadrature
# once. The kernels recompute an element's quadrature in each of its four
# node threads (and ns_node_full its values and primal density in each of
# three column threads); that is their design's cost, not the function's.
# With kappa (and a stage's m) scalar, the state part on a uniform mesh is
# one constant nc x nc element matrix times the element's values: nc^2 FMA
# per element.


def _constant_matrix(kappa, stage, vel):
    return not isinstance(kappa, torch.Tensor) and (
        stage is None or not isinstance(stage.mass, torch.Tensor)) and \
        not any(isinstance(b, torch.Tensor) for b in vel or ())


def _advect_flops(kernel, vel, tr, nc, dim):
    """Operations the velocity adds per element and qp: b . grad u_h (2
    dim), and in "state" a phi_c term in each of the nc rows (2 each; a
    stage has it already), in "full" b . grad phi_c' in each of the nc
    column tangents (2 dim each)."""
    if vel is None:
        return 0
    if kernel == "state":
        return 2 * dim + (0 if tr else 2 * nc)
    return 2 * dim + nc * 2 * dim


def thermal_work(kernel, N0, N1, Q, dtype, kappa, stage, full_inputs=(),
                 vel=None):
    """(bytes, flops) of one thermal_node_state / thermal_node_full call
    (csrc/fused_p1_thermal.cu); vel: None or the velocity's
    components."""
    nodes, E = (N0 + 1) * (N1 + 1), N0 * N1
    it = torch.finfo(dtype).bits // 8
    tr = stage is not None
    mass = _qp_len(stage.mass) if tr else 0
    velb = sum(_qp_len(b) for b in vel or ())
    adv = _advect_flops(kernel, vel, tr, 4, 2)
    if kernel == "state":
        nbytes = it * (2 * nodes + _qp_len(kappa) + mass + velb)
        if _constant_matrix(kappa, stage, vel):
            return nbytes, E * 2 * 4 * 4
        # per element and qp: grad u_h 16, the flux 2, four rows of 5; a
        # stage adds u_h 8, the alphas and the mass lane 4, and 2 per row
        per_q = 16 + 2 + 4 * 5 + (8 + 4 + 4 * 2 if tr else 0) + adv
        return nbytes, E * Q * per_q
    nbytes = it * (2 * nodes + sum(t.numel() for t in full_inputs) + mass
                   + velb + 16 * E)
    # per element and qp: grad u_h 16, the flux 2, four residual rows of
    # 7, the Jacobian's 16 (c, c') pairs of 16 (20 in a stage)
    return nbytes, E * Q * (16 + 2 + 4 * 7 + 16 * (20 if tr else 16) + adv)


def elem_work(kernel, grid, dims, tab, dtype, kappa, stage,
              full_inputs=(), vel=None):
    """(bytes, flops) of one thermal_elem_state / thermal_elem_full call
    (csrc/fused_elem_thermal.cu) on the element grid `dims`: the grid,
    the coefficient tensors and the rows once; each element's quadrature
    once (not the full kernel's per-column recomputation of grad u_h);
    vel: None or the velocity's components."""
    import math
    E, nc, dim, Q = math.prod(dims), tab.nc, tab.dim, tab.Q
    nodes = grid.numel()
    it = torch.finfo(dtype).bits // 8
    tr = stage is not None
    mass = _qp_len(stage.mass) if tr else 0
    velb = sum(_qp_len(b) for b in vel or ())
    adv = _advect_flops(kernel, vel, tr, nc, dim)
    grad_uh = 2 * nc * dim
    if kernel == "state":
        nbytes = it * (nodes + _qp_len(kappa) + mass + velb + nc * E)
        if _constant_matrix(kappa, stage, vel):
            return nbytes, E * 2 * nc * nc
        # per element and qp: grad u_h, the flux dim, nc rows of 2 dim +
        # 2; a stage adds u_h 2 nc, its alphas dim + 2, and 2 per row
        per_q = (grad_uh + dim + nc * (2 * dim + 2)
                 + (2 * nc + dim + 2 + 2 * nc if tr else 0) + adv)
        return nbytes, E * Q * per_q
    nbytes = it * (nodes + sum(t.numel() for t in full_inputs) + mass
                   + velb + (nc + nc * nc) * E)
    # per element and qp: grad u_h, the flux dim, nc residual rows of 2
    # dim + 3, nc column tangents of 4 dim + 1 (a stage: dim + 3 more),
    # nc * nc Jacobian entries of 2 dim + 3
    per_q = (grad_uh + dim + nc * (2 * dim + 3)
             + nc * (4 * dim + 1 + (dim + 3 if tr else 0))
             + nc * nc * (2 * dim + 3) + adv)
    return nbytes, E * Q * per_q


# The Navier-Stokes kernels' operations are counted, not derived by hand:
# the weak form's accumulation (fused_ns.accumulate, the JAX package's
# trace-time sparse forward AD) runs once on (2,)-shaped stand-ins for
# one element's inputs, with this call's coefficients, switches and
# alphas, under _OpCount. Arithmetic on Python floats (the tables, the
# seeds alpha phi_c', the scalar coefficients) is element-independent and
# free, structural zeros are never formed, the constant Jacobian rows
# come back as floats, and the quadrature weights are folded into the
# tables (weights of 1). Only the operations whose values reach the
# returned rows count: in mode "lin" the primal densities feed nothing
# but the tangents' coefficients, so a source that reads only the
# coordinates (the decks' sin and cos) costs nothing there.

class _OpCount(TorchDispatchMode):
    """Counts the distinct arithmetic operations on tensors run under it,
    one per element of a (2,)-shaped result: a multiply, an add, a
    divide, a square root and an elementary function (sin, exp, max,
    ...) are one each (an FMA two); an operation on
    tensors alone (b * b, sqrt(b)) counts once however often it recurs;
    negating, multiplying or dividing by 1, -1 or 0 and adding 0 are
    free, as are selects and copies. `ops` counts every operation run;
    reaching(results) only those whose values reach the results, as a
    compiler keeps them (a primal value that feeds no tangent of a
    linearization is never computed)."""
    ARITH = {"add", "sub", "rsub", "mul", "div", "reciprocal", "sqrt",
             "rsqrt", "pow", "sin", "cos", "tan", "exp", "log", "sinh",
             "cosh", "tanh", "atan2", "abs", "maximum", "minimum"}

    def __init__(self):
        super().__init__()
        self.ops = 0
        self._floats = 0
        self._num = {}     # id(tensor) -> value number
        self._live = []    # the numbered tensors: no id is reused
        self._seen = {}    # (operation, operands) -> value number
        self._deps = []    # op number -> (its count, its operands' op numbers)

    def _operand(self, a):
        if isinstance(a, float):
            # never shared: equal table entries are coincidences of the
            # element's shape, not structure
            self._floats += 1
            return ("float", self._floats)
        if not isinstance(a, torch.Tensor):
            return ("scalar", repr(a))
        if id(a) not in self._num:
            self._num[id(a)] = ("input", len(self._num))
            self._live.append(a)
        return self._num[id(a)]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        operands = [self._operand(a) for a in args]
        if name in ("add", "mul"):
            operands.sort(key=repr)
        key = (name, tuple(operands), repr(kwargs))
        if key not in self._seen:
            self._seen[key] = ("op", len(self._seen))
            scalars = [a for a in args if isinstance(a, (int, float))]
            free = (name in ("mul", "div")
                    and any(s in (1, -1, 0) for s in scalars)) or (
                name in ("add", "sub", "rsub") and 0 in scalars)
            counted = name in self.ARITH and not free
            if counted:
                if out.numel() != 2:
                    raise ValueError(f"{func} on a {tuple(out.shape)} "
                                     "operand: not an element's stand-in")
                self.ops += 1
            self._deps.append((int(counted), [o[1] for o in operands
                                              if o[0] == "op"]))
        if isinstance(out, torch.Tensor):
            self._num[id(out)] = self._seen[key]
            self._live.append(out)
        return out

    def reaching(self, *results):
        """The counted operations whose values reach the results (nested
        lists of tensors, floats and None), each once."""
        todo = []

        def collect(x):
            if isinstance(x, (list, tuple)):
                for y in x:
                    collect(y)
            elif isinstance(x, torch.Tensor) and \
                    self._num.get(id(x), ("",))[0] == "op":
                todo.append(self._num[id(x)][1])
        collect(results)
        seen, total = set(), 0
        while todo:
            n = todo.pop()
            if n not in seen:
                seen.add(n)
                count, operands = self._deps[n]
                total += count
                todo.extend(operands)
        return total


_NS_OPS = {}


def _first_qps(tab, n):
    """The first n qps of a table, with unit weights (the counts fold the
    weights into the kernels' multiplies)."""
    from types import SimpleNamespace
    return SimpleNamespace(Q=n, dim=tab.dim,
                           phi=[row[:n] for row in tab.phi],
                           grad=[row[:n] for row in tab.grad],
                           wts=[1.0] * n)


def _ops_of_qps(ops, Q, hex_):
    """Operations of an accumulation over Q qps, ops(n) counting the
    first n. On hex p1 (hex_), ops(1) + (Q - 1) (ops(2) - ops(1)): every
    qp after the first runs the same operations (the first starts each
    sum), since the trilinear basis takes no value 0 or 1 at a Gauss
    point that would make a multiply free at one qp and not another
    (tests/test_torch_op_count.py checks it against whole counts at 8
    and 27 qps); elsewhere (p2's basis is 0 at some qps) the whole
    count."""
    if not hex_ or Q <= 2:
        return ops(Q)
    one, two = ops(1), ops(2)
    return one + (Q - 1) * (two - one)


def ns_ops(tab, nc, coeffs, form, stage):
    """Operations per element of one NS kernel call (all its qps): the
    values and gradients at each qp, the density and its sparse
    derivatives, the residual rows and the column tangents and sums of
    every element-varying Jacobian row, as _OpCount counts them on
    fused_ns.accumulate. Cached per (element, coefficients, switches,
    alphas): the element's size changes no count (the check of h = 1
    aside)."""
    from mrhyde_tpu_torch.ops import fused_ns as fn
    nv, Q = tab.dim + 1, tab.Q
    key = (tab.dim, Q, nc, form.pspg, form.supg, form.transient,
           form.h == 1.0, None if stage is None
           else (stage.alpha_u, stage.alpha_t),
           tuple(None if isinstance(c, torch.Tensor) else c for c in coeffs))
    if key in _NS_OPS:
        return _NS_OPS[key]
    gen = torch.Generator().manual_seed(97)

    def standin():
        return torch.rand(2, generator=gen, dtype=torch.float64) + 0.5
    steady = stage is None
    ue = [[standin() for _ in range(nc)] for _ in range(nv)]
    ud = [[0.0 if steady else standin() for _ in range(nc)]
          for _ in range(nv)]
    # a coefficient that reads x, y or z differs at every qp
    per_q = [[standin() if isinstance(c, torch.Tensor) else c
              for c in coeffs] for _ in range(Q)]

    def coeff_at(q):
        rho, visc, *src = per_q[q]
        return rho, visc, src

    def ops(n):
        with _OpCount() as count:
            results = fn.accumulate(ue, ud, coeff_at, _first_qps(tab, n),
                                    form, 1.0 if steady else stage.alpha_u,
                                    0.0 if steady else stage.alpha_t,
                                    steady)
        return count.reaching(*results)
    _NS_OPS[key] = _ops_of_qps(ops, Q, tab.dim == 3)
    return _NS_OPS[key]


def ns_work(N0, N1, Q, dtype, args):
    """(bytes, flops) of one ns_node_full call with these arguments: the
    grids and coefficient tensors read once, the node residual and the
    varying Jacobian rows written once; ns_ops per element, and the adds
    of the residual's scatter to the nodes."""
    ue, ud, coeffs, tab, form, jac_idx = args[:6]
    stage = args[6] if len(args) > 6 else None
    nodes, E = (N0 + 1) * (N1 + 1), N0 * N1
    it = torch.finfo(dtype).bits // 8
    tr = ud is not None
    nbytes = it * (3 * nodes * (3 if tr else 2)
                   + sum(_qp_len(c) for c in coeffs) + len(jac_idx) * E)
    return nbytes, E * ns_ops(tab, 4, coeffs, form, stage) \
        + 3 * (4 * E - nodes)


def ns_elem_work(dims, dtype, args):
    """(bytes, flops) of one ns_elem_full call with these arguments: the
    grids of all variables (and the u_dot ones) and the coefficient
    tensors read once, the nd residual rows and the varying Jacobian rows
    written once; ns_ops per element, the operations of the scheme the
    kernel runs: the density linearized once per qp, each column built
    from that linearization and the basis tables."""
    import math
    ue, ud, coeffs, tab, lat, form, jac_idx = args[:7]
    stage = args[7] if len(args) > 7 else None
    E, nc = math.prod(dims), len(lat.offsets)
    nd = (tab.dim + 1) * nc
    it = torch.finfo(dtype).bits // 8
    nbytes = it * (ue.numel() * (1 if ud is None else 2)
                   + sum(_qp_len(c) for c in coeffs)
                   + (nd + len(jac_idx)) * E)
    return nbytes, E * ns_ops(tab, nc, coeffs, form, stage)


_SET_OPS = {}


def set_ops(form, tab, sc, stage, mode="full"):
    """Operations per element of one set_node_full or set_elem_full call
    (mode "lin": set_node_state or set_elem_state, the tangent-only
    pass), as ns_ops counts them: the set's accumulation (fused_set's
    plain version, the JAX package's sparse forward AD) on one element's
    stand-ins (form.nc local dofs per variable), with stand-ins for the
    coordinates of each qp (a coefficient that reads x, y or z differs at
    every qp). Cached per (form, scalars, alphas, mode)."""
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops.fused_ns import accumulate_density
    key = (form.source, form.h == 1.0, sc, tab.Q, mode, None if stage is None
           else (stage.alpha_u, stage.alpha_t))
    if key in _SET_OPS:
        return _SET_OPS[key]
    gen = torch.Generator().manual_seed(97)

    def standin():
        return torch.rand(2, generator=gen, dtype=torch.float64) + 0.5
    steady = stage is None
    nv, nc, Q = len(form.variables), form.nc, tab.Q
    ue = [[standin() for _ in range(nc)] for _ in range(nv)]
    ud = [[0.0 if steady else standin() for _ in range(nc)]
          for _ in range(nv)]
    xy = [[standin() for _ in range(form.dim)] for _ in range(Q)]

    def ops(n):
        with _OpCount() as count:
            results = accumulate_density(
                ue, ud, fs._density(form, lambda q: xy[q], sc),
                _first_qps(tab, n), 1.0 if steady else stage.alpha_u,
                0.0 if steady else stage.alpha_t, steady, mode)
        return count.reaching(*results)
    _SET_OPS[key] = _ops_of_qps(ops, Q, form.dim == 3)
    return _SET_OPS[key]


def set_work(N0, N1, dtype, form, ue, ud, sc, tab, geo, jac_idx,
             stage=None):
    """(bytes, flops) of one set_node_full call: the grids of all
    variables (and the u_dot ones) read once, the node residual and the
    varying Jacobian rows written once; set_ops per element, and the
    adds of the residual's scatter to the nodes."""
    nv = len(form.variables)
    nodes, E = (N0 + 1) * (N1 + 1), N0 * N1
    it = torch.finfo(dtype).bits // 8
    nbytes = it * (nv * nodes * (3 if ud is not None else 2)
                   + len(jac_idx) * E)
    return nbytes, E * set_ops(form, tab, sc, stage) + nv * (4 * E - nodes)


def set_elem_work(dims, dtype, form, ue, ud, sc, tab, lat, geo, jac_idx,
                  stage=None):
    """(bytes, flops) of one set_elem_full call: the grids of all
    variables (and the u_dot ones) read once, the nd residual rows and
    the varying Jacobian rows written once; set_ops per element."""
    import math
    E, nd = math.prod(dims), len(form.variables) * len(lat.offsets)
    it = torch.finfo(dtype).bits // 8
    nbytes = it * (ue.numel() * (1 if ud is None else 2)
                   + (nd + len(jac_idx)) * E)
    return nbytes, E * set_ops(form, tab, sc, stage)


def state_work(dims, dtype, form, u, sc, tab, lat, stage, node):
    """(bytes, flops) of one set_node_state or set_elem_state call: the u
    grids read once, the node residual (node) or the nd residual rows
    written once; set_ops in mode "lin" per element (and the adds of the
    node scatter)."""
    import math
    E, nv = math.prod(dims), len(form.variables)
    it = torch.finfo(dtype).bits // 8
    out = u.numel() if node else nv * len(lat.offsets) * E
    flops = E * set_ops(form, tab, sc, stage, "lin")
    if node:
        flops += nv * (4 * E - u[0].numel())
    return it * (u.numel() + out), flops


def assembly_tc(problem, u, time):
    """The TimeCoeffs of one timed assembly at state u: a steady call, or
    for a transient deck a BWE stage of its step size seeded from u."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    sc = problem.solver_cfg
    if sc.get("solver") != "transient":
        return TimeCoeffs.steady(problem.n_dof, dtype=u.dtype,
                                 device=u.device)
    dt = float(sc["delta t"]) if "delta t" in sc \
        else float(sc["final time"]) / int(sc["number of steps"])
    return TimeCoeffs(1.0, torch.zeros_like(u), 1.0 / dt, -u / dt,
                      float(time), dt)


# every deck's record, by its phase name
RECORDS = {}
# name -> {time: {label: L2}} of every run_deck deck (phase sharded_decks
# holds a sharded deck to an earlier phase's run of the same deck)
LABELS = {}


def l2_key(label):
    """The error calculator's key of a label: "e" -> ("L2", "e"), "e@1"
    (the norm on element block 1) -> ("L2@1", "e"), "p#L2-grad" (a norm
    of another kind) -> ("L2-grad", "p")."""
    label, _, kind = label.partition("#")
    var, _, block = label.partition("@")
    return (kind or (f"L2@{block}" if block else "L2"), var)


def l2_labels(errs):
    """{label: L2} of one recorded time's errors, the inverse of l2_key
    over the L2 norms (and the L2-grad and L2-face norms)."""
    out = {}
    for (kind, var), val in errs.items():
        if kind == "L2" or kind.startswith("L2@"):
            block = kind.partition("@")[2]
            out[f"{var}@{block}" if block else var] = float(val)
        elif kind in ("L2-grad", "L2-face", "L2-div", "L2-curl"):
            out[f"{var}#{kind}"] = float(val)
    return out


def run_deck(name, cfg, device, checks, mode, post=None):
    """Runs one deck through Problem(cfg).run() and checks its L2 errors:
    `checks` lists (time, var, reference, rtol). One assembly at the zero
    state runs before the timer (`warmup_s`, set-up: the first use of the
    CUDA path of torch.func.jvp and of the DSL), so a deck's solve time
    does not depend on its place in the run. The kernel launch counts
    and the fused provider's calls are reset just before run() and read
    just after it, so they hold the main path's alone. A fused deck
    (`mode` "state" or "full") must launch that kernel once per fused
    res_and_jac call, the state kernel twice more per stage of a
    transient deck (the beta grids of the coord part), and the other
    kernel never; mode None: no fused provider, no launch. An NS deck
    (mode "ns_full") launches ns_node_full once per fused res_and_jac
    call and no thermal kernel. A 3D hex or p2 deck ("elem_state",
    "elem_full") follows the thermal rule with the element kernels (B1)
    and launches no node kernel (B2); a 2D p1 deck no element kernel. A
    hex or p2 NS deck ("ns_elem_full") launches ns_elem_full once per
    fused res_and_jac call and no other kernel, and so does a module-set
    deck ("set_node_full") its generated kernel. post(problem, result),
    where given, returns more of the record, its "ok" joining the
    deck's."""
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import Problem
    from mrhyde_tpu_torch.solvers.nonlinear import MG_VARIANTS, mg_hierarchy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    problem = Problem(cfg, device=device)
    asm = problem.assembler
    fused = asm.fused_provider()
    variant = problem._precond_variant()
    hier = {"precond_variant": variant}
    if variant in MG_VARIANTS:
        # the multigrid hierarchy is set-up: built here, once per assembler
        th = time.perf_counter()
        hier["hierarchy"] = type(mg_hierarchy(asm, variant)).__name__
        hier["hierarchy_s"] = time.perf_counter() - th
    t1 = time.perf_counter()
    u0 = torch.zeros(problem.n_dof, dtype=problem.dtype, device=device)
    asm.res_and_jac(u0, assembly_tc(problem, u0, 0.0))
    torch.cuda.synchronize()
    if hasattr(fused, "_stage_cache"):
        fused._stage_cache = None   # the warm-up leaves no coord part
    t2 = time.perf_counter()
    calls = [0]
    if fused is not None:
        jacobian = fused.jacobian

        def counted(*a, **k):
            calls[0] += 1
            return jacobian(*a, **k)
        fused.jacobian = counted
    for k in fp.LAUNCHES:
        fp.LAUNCHES[k] = 0
    result = problem.run()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(fp.LAUNCHES)
    fused_calls = calls[0]
    hist = {round(t, 10): errs for t, errs in result.error_history}
    LABELS[name] = {t: ms_labels(errs) for t, errs in hist.items()}
    errors = [{"time": t, "var": v, "L2": hist[round(t, 10)][l2_key(v)],
               "L2_ref": want, "rtol": rtol}
              for t, v, want, rtol in checks]
    u = result.u
    # one assembly (residual + Jacobian) at the solution, median of 5
    tc = assembly_tc(problem, u, result.time)
    asm_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        ta = time.perf_counter()
        asm.res_and_jac(u, tc)
        torch.cuda.synchronize()
        asm_ms.append((time.perf_counter() - ta) * 1e3)
    extra = post(problem, result) if post else {}
    ok = (all(abs(e["L2"] - e["L2_ref"]) <= e["rtol"] * abs(e["L2_ref"])
              for e in errors) and extra.pop("ok", True)
          and u.shape == (problem.n_dof,) and bool(torch.isfinite(u).all())
          and u.device.type == torch.device(device).type)
    rec = {"phase": name, "n_dof": problem.n_dof, **extra,
           "linear_method": problem._linear_method(), **hier,
           "errors": errors,
           "recorded_times": len(result.error_history), **result.counts,
           "setup_s": t1 - t0, "warmup_s": t2 - t1, "solve_s": t3 - t2,
           "wall_s": t3 - t0, "assembly_ms": statistics.median(asm_ms),
           "fused_calls": fused_calls, "launches": launches,
           "fused_provider": None if fused is None
           else type(fused).__name__, "ok": ok}
    emit(rec)
    RECORDS[name] = rec
    if not ok:
        raise SystemExit(f"phase {name} failed: {rec}")
    if mode is None:
        want = {k: 0 for k in launches}
        if fused is not None:
            raise SystemExit(f"phase {name}: expected no fused provider")
    else:
        per_stage = 2 * result.counts["stages"] \
            if mode in ("state", "elem_state") \
            and problem.solver_cfg.get("solver") == "transient" else 0
        want = {k: fused_calls + per_stage if k == mode else 0
                for k in launches}
    if launches != want or (mode is not None and fused_calls <= 0):
        raise SystemExit(f"phase {name}: Problem.run() launched {launches} "
                         f"for {fused_calls} fused res_and_jac calls and "
                         f"counts {result.counts}; expected {want}")
    return launches


def run_boussinesq(device):
    """The Boussinesq deck at beta = 1 and 0: max |ux| at beta = 1 equals
    the JAX package's to rtol 1e-8, and at beta = 0 it is below 1e-3 of
    that (no thermal forcing, as tests/test_flow.py:63-98 checks)."""
    maxu = {}

    def post(beta):
        def check(problem, result):
            dofs = torch.as_tensor(problem.disc.dofmap.all_dofs("ux"),
                                   device=result.u.device)
            m = maxu[beta] = float(result.u[dofs].abs().max())
            ok = abs(m - BOUSSINESQ_MAXU) <= 1e-8 * BOUSSINESQ_MAXU \
                if beta else m < 1e-3 * maxu[1.0]
            return {"max_ux": m, "max_ux_ref": BOUSSINESQ_MAXU if beta
                    else 1e-3 * maxu[1.0], "ok": ok}
        return check
    return [run_deck(f"boussinesq_gold_nx8_beta{b:g}", boussinesq_deck(8, b),
                     device, [], "set_node_full", post(b))
            for b in (1.0, 0.0)]


def mesh_solid_decks(device):
    """Runs MESH_DECKS and SOLID_DECKS, each held to its JAX L2 and its
    gold; returns each deck's launches. Alone on the card: python3 -c
    'import torch, chip_smoke; chip_smoke.mesh_solid_decks(
    torch.device("cuda"))' (the node kernels build at first use)."""
    return [
        run_deck(name, build(n), device,
                 [(t, v, g, rtol) for t, ref in refs.items()
                  for v, g in ref.items()]
                 + [(t, v, g, 2e-5) for t, ref in golds.items()
                    for v, g in ref.items()], mode)
        for name, (build, n, rtol, refs, mode, golds) in {
            **MESH_DECKS, **SOLID_DECKS}.items()]


# a label whose JAX L2 is below this is a field exact to round-off (T of
# the VDNS channel, w at t = 0, a momentum at rest): held as |L2| <= it
ZERO_L2 = 1e-12


def physics_decks(device, decks=None):
    """Runs PHYSICS_DECKS (or `decks`, a table of the same form), each
    held to its JAX L2 (ZERO_L2 for a field exact to round-off) and its
    golds; returns each deck's launches. Alone on the card: python3 -c
    'import torch, chip_smoke; chip_smoke.physics_decks(
    torch.device("cuda"))' (the node kernels build at first use)."""
    out = []
    for name, (build, n, rtol, refs, mode, golds) in (
            decks or PHYSICS_DECKS).items():
        checks = [(t, v, g, rtol) for t, ref in refs.items()
                  for v, g in ref.items() if abs(g) >= ZERO_L2]
        checks += [(t, v, g, r) for t, ref in golds.items()
                   for v, (g, r) in ref.items()]
        zeros = [(t, v) for t, ref in refs.items() for v, g in ref.items()
                 if abs(g) < ZERO_L2]

        def post(problem, result, zeros=zeros):
            hist = {round(t, 10): errs for t, errs in result.error_history}
            worst = max((abs(float(hist[round(t, 10)][l2_key(v)]))
                         for t, v in zeros), default=0.0)
            return {"zero_labels": len(zeros), "zero_max": worst,
                    "ok": worst <= ZERO_L2}
        out.append(run_deck(name, build(n), device, checks, mode, post))
    return out


def vector_decks(device):
    """Runs VECTOR_DECKS (phase `vector_decks`), each held to its JAX L2
    and its golds, on the general path with no fused provider; then one
    line `vector_decks` with each deck's set-up, solve and assembly
    times and its stages, Newton and Krylov iterations. Alone on the
    card: python3 -c 'import torch, chip_smoke;
    chip_smoke.vector_decks(torch.device("cuda"))'."""
    missing = [n for n in VECTOR_DECKS if not VECTOR_REFS.get(n)]
    if missing:
        raise SystemExit(f"vector decks without a JAX reference: {missing}")
    out = physics_decks(device, VECTOR_DECKS)
    keys = ("n_dof", "linear_method", "precond_variant", "setup_s",
            "solve_s", "assembly_ms", "stages", "newton_iters",
            "linear_iters", "fused_provider")
    emit({"phase": "vector_decks", "decks": {
        name: {k: RECORDS[name].get(k) for k in keys}
        for name in VECTOR_DECKS}})
    return out


# ----------------------------------------------------------------------
# phase analysis_decks (ROADMAP A12): forward + adjoint, the trust
# region, a discretized field, UQ + DCI and a multi-set deck on the card
# ----------------------------------------------------------------------

# four sensors inside the unit square, and a second source shape
SENSOR_PTS = [[0.3, 0.3], [0.7, 0.45], [0.55, 0.8], [0.2, 0.65]]
S2 = "x*(1.0-x)*y*(1.0-y)"
# the solver keys of the analysis decks: CG to 1e-12, so that central
# differences of the objective hold the adjoint to 1e-6
ADJ_SOLVER = {"Belos solver": "CG", "linear TOL": 1e-12,
              "nonlinear TOL": 1e-10}


def objectives(times=(0.0,)):
    """An integrated response (e^2 against 0.05 on 4 virtual ranks) and
    four sensors of e with data at each of `times` (the objective's
    record times)."""
    data = (0.5, 0.2, -0.3, 0.1)
    return {"resp": {"type": "integrated response", "response": "e*e",
                     "target": 0.05, "weight": 10.0},
            "sens": {"type": "sensors", "response": "e",
                     "sensor points": SENSOR_PTS,
                     "sensor times": list(times),
                     "sensor data": [[d * (1.0 + 0.1 * k)
                                      for k in range(len(times))]
                                     for d in data]}}


def active(**values):
    return {k: {"type": "scalar", "value": v, "usage": "active"}
            for k, v in values.items()}


def adjoint_deck(n):
    """forward+adjoint, steady: kappa = k0, source amp 8 pi^2 S (u = S at
    k0 = amp = 1), the objectives of `objectives`: thermal_node_state."""
    cfg = deck(n, "k0", f"amp*{SOURCE}", dict(ADJ_SOLVER))
    cfg["Parameters"] = active(k0=1.0, amp=1.0)
    cfg["Analysis"] = {"analysis type": "forward+adjoint"}
    cfg["Postprocess"]["Objective functions"] = objectives()
    return cfg


def adjoint_nonlinear_deck(n):
    """forward+adjoint of kappa = k0 + k1 e^2 (k0 = k1 = 1, the
    nonlinear deck's source): thermal_node_full."""
    cfg = adjoint_deck(n)
    cfg["Functions"].update({"thermal diffusion": "k0 + k1*e*e",
                             "thermal source": SOURCE_NL})
    cfg["Parameters"] = active(k0=1.0, k1=1.0)
    return cfg


def adjoint_dirk_deck(n, steps=8):
    """forward+adjoint of the DIRK-2,2 deck (dt = 0.05, kappa = k0,
    source amp S_T): thermal_node_state. The sensors' data times are the
    objective's record times t_n + c_last dt (the reference's quirk)."""
    cfg = transient_deck(n, dict(ADJ_SOLVER, **{
        "transient Butcher tableau": "DIRK-2,2", "final time": 0.05 * steps,
        "number of steps": steps}), "k0", f"amp*{SOURCE_T}")
    cfg["Parameters"] = active(k0=1.0, amp=1.0)
    cfg["Analysis"] = {"analysis type": "forward+adjoint"}
    cfg["Postprocess"]["Objective functions"] = objectives(
        [0.05 * k + 0.0375 for k in range(steps)])
    return cfg


def rol_deck(n, iters=10):
    """A trust-region source inversion: 'Generate data' runs the source
    2 S + 0.5 S2 (datagen = 1), then ROL fits a1 S + a2 S2 from (0.2,
    -1) against the stored state (discrete control): thermal_node_state."""
    src = (f"datagen*(2.0*{S_TRUE} + 0.5*{S2}) "
           f"+ (1.0-datagen)*(a1*{S_TRUE} + a2*{S2})")
    cfg = deck(n, "1.0", src, dict(ADJ_SOLVER))
    cfg["Parameters"] = dict(
        {"datagen": {"type": "scalar", "value": 0.0, "usage": "inactive"}},
        **active(a1=0.2, a2=-1.0))
    cfg["Analysis"] = {"analysis type": "ROL", "ROL": {
        "General": {"Generate data": True, "Write Final Parameters": True,
                    "Secant": {"Maximum Storage": 5}},
        "Step": {"Trust Region": {"Initial Radius": 0.5}},
        "Status Test": {"Iteration Limit": iters,
                        "Gradient Tolerance": 1e-12,
                        "Step Tolerance": 1e-14}}}
    cfg["Postprocess"] = {"Objective functions": {
        "misfit": {"type": "discrete control", "weight": 1.0}}}
    return cfg


def field_inversion_deck(n, iters=8):
    """A discretized-field inversion on the general path: the HGRAD p1
    field src_field (start 1.0) fitted by ROL against the state of the
    source 10 sin(pi x) sin(pi y) ('Generate data')."""
    cfg = rol_deck(n, iters)
    # 'Write Final Parameters' would print one line per field DOF
    cfg["Analysis"]["ROL"]["General"]["Write Final Parameters"] = False
    cfg["Functions"]["thermal source"] = (
        "datagen*10.0*sin(pi*x)*sin(pi*y) + (1.0-datagen)*src_field")
    cfg["Parameters"] = {
        "datagen": {"type": "scalar", "value": 0.0, "usage": "inactive"},
        "src_field": {"type": "HGRAD", "usage": "discretized", "order": 1,
                      "initial_value": 1.0}}
    return cfg


def uq_deck(n, samples=64):
    """UQ + DCI: kappa ~ U(1, 2), amp ~ N(1, 0.04) (numpy RandomState,
    seed 1234), objective int e^2 = (amp / kappa)^2 int u_1^2:
    thermal_node_state per sample."""
    cfg = deck(n, "kappa", f"amp*{SOURCE}", dict(ADJ_SOLVER))
    cfg["Parameters"] = {
        "kappa": {"type": "scalar", "value": 1.0, "usage": "stochastic",
                  "distribution": "uniform", "min": 1.0, "max": 2.0},
        "amp": {"type": "scalar", "value": 1.0, "usage": "stochastic",
                "distribution": "Gaussian", "mean": 1.0, "variance": 0.04}}
    cfg["Analysis"] = {"analysis type": "DCI",
                       "UQ": {"samples": samples, "seed": 1234},
                       "DCI": {"observed type": "Gaussian",
                               "observed mean": 0.15,
                               "observed variance": 0.0025}}
    cfg["Postprocess"] = {"Objective functions": {
        "energy": {"type": "integrated control", "response": "e*e"}}}
    return cfg


def ns_cdr_multiset_deck(nx):
    """The NS + cdr start-up of SET_DECKS (ns_cdr_deck) as two physics
    sets coupled iteratively, the reference's Multiphysics/
    NavierStokes-CDR/Iteratively-Coupled: set NS reads c, set CDR reads
    ux and uy as the other set's fields. NS runs ns_node_full and cdr
    the thermal state kernel."""
    cfg = ns_cdr_deck(nx)
    phys = cfg["Physics"]
    dbc = phys["Dirichlet conditions"]
    ns = {k: v for k, v in phys.items()
          if k not in ("modules", "Dirichlet conditions",
                       "Initial conditions")}
    cfg["Physics"] = {
        "physics set names": "NS, CDR",
        "NS": dict(ns, **{
            "modules": "navier stokes",
            "Dirichlet conditions": {"scalar data": True, "ux": dbc["ux"],
                                     "uy": dbc["uy"]},
            "Initial conditions": {"scalar data": True, "ux": 0.0,
                                   "uy": 0.0, "pr": 0.0}}),
        "CDR": {"modules": "cdr",
                "Dirichlet conditions": {"scalar data": True,
                                         "c": dbc["c"]},
                "Initial conditions": {"scalar data": True, "c": 0.0}}}
    cfg["Discretization"] = {
        "NS": {"order": {"ux": 1, "uy": 1, "pr": 1}, "quadrature": 2},
        "CDR": {"order": {"c": 1}, "quadrature": 2}}
    return cfg


# the multi-set decks (tools/jax_references.py takes their keys): name ->
# (deck function, n on the card, {var: rtol}, {time: the JAX package's f64
# CPU L2 per variable}). The NS + cdr start-up: 66,820 DOFs in two sets,
# 248 s of JAX CPU solve (its general path). Every GMRES solve of the NS
# set stops at its 2,000 cap, as in SET_DECKS' ns_cdr_startup_nx256, and
# L2(pr), the least determined field, moves with the Krylov path's
# rounding: on the card 7.5e-7 from JAX's at t = 0.01 and 1.06e-3 at t =
# 0.02, against 2e-8 for ux, uy and c (at 16x4, where the solves
# converge, the packages agree to 1e-9: tests/test_torch_multiset.py)
MULTISET_DECKS = {
    # at 128x32 since PR 21 (256x64 before, 25.4 s on the card), for the
    # script's time
    "ns_cdr_multiset_startup_nx128": (
        ns_cdr_multiset_deck, 128,
        {"ux": 1e-4, "uy": 1e-4, "c": 1e-4, "pr": 2e-3},
        {0.01: {"ux": 0.18482414125039143, "uy": 1.7175423399442538e-05,
                "pr": 0.001156707541885479, "c": 0.12023567559159513},
         0.02: {"ux": 0.16742885925186757, "uy": 2.1591553782719958e-05,
                "pr": 0.0017450345796906435, "c": 0.12611054050546017}}),
}
# the JAX package's f64 CPU L2(e) of the DIRK-2,2 deck at 256^2, 8 steps
# to t = 0.4 (GMRES + Jacobi), and of the steady deck at 512^2 (CG, TOL
# 1e-10): ROADMAP's reference tables
DIRK_256_L2 = 0.000954757
REF_512_CG = 6.27491e-06
ADJ_RTOL = 1e-6


def fd_check(dfwd, pvec, h=1e-4):
    """The adjoint gradient against central differences of the
    objective, (J(p + h e_i) - J(p - h e_i)) / 2h with h relative to
    p_i: {name: (adjoint, fd, rel)}."""
    _v, grad = dfwd.value_and_gradient(pvec)
    out = {}
    for k, v in pvec.items():
        step = h * max(1.0, abs(float(v)))
        vals = []
        for sgn in (1.0, -1.0):
            pp = dict(pvec)
            pp[k] = v + sgn * step
            with torch.no_grad():
                vals.append(float(dfwd.objective(pp)))
        fd = (vals[0] - vals[1]) / (2 * step)
        g = float(grad[k])
        out[k] = (g, fd, abs(g - fd) / max(abs(fd), 1e-300))
    return out


def adjoint_timing(dfwd, pvec):
    """(forward s, forward + adjoint s) of the differentiable objective
    at pvec: one forward through the stage solves alone, then one
    value_and_gradient."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        dfwd.objective(pvec)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dfwd.value_and_gradient(pvec)
    torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1


def analysis_run(name, cfg, device, kernels, check):
    """Builds the deck through make_problem, resets the launch counts,
    runs its analysis (Problem.run(): the main path), reads the counts,
    then check(problem, result) -> dict with "ok". Every kernel named in
    `kernels` must have launched, and no other. Returns the launches."""
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import make_problem
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    problem = make_problem(cfg, device=device)
    t1 = time.perf_counter()
    for k in fp.LAUNCHES:
        fp.LAUNCHES[k] = 0
    result = problem.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(fp.LAUNCHES)
    rec = {"phase": "analysis_decks", "deck": name,
           "n_dof": problem.n_dof, "setup_s": t1 - t0, "run_s": t2 - t1,
           "launches": launches, **check(problem, result)}
    bad = sorted(k for k, n in launches.items() if (n > 0) != (k in kernels))
    rec["ok"] = bool(rec["ok"]) and not bad
    emit(rec)
    RECORDS[name] = rec
    if not rec["ok"]:
        raise SystemExit(f"phase analysis_decks, deck {name} failed "
                         f"(kernels launched or missing: {bad}): {rec}")
    return launches


def _l2(result, t, var="e"):
    hist = {round(tt, 10): errs for tt, errs in result.error_history}
    return float(hist[round(t, 10)][("L2", var)])


def adjoint_check(l2_time, l2_ref):
    """The check of a forward+adjoint deck: the forward's L2(e) against
    the JAX reference, the gradient against central differences (rel <=
    ADJ_RTOL), and the adjoint's cost against its forward."""
    def check(problem, result):
        from mrhyde_tpu_torch.analysis.forward_ad import DifferentiableForward
        dfwd = DifferentiableForward(problem,
                                     problem.objective_manager.value)
        pvec = problem.param_manager.pvec(problem.device, problem.dtype)
        fd = fd_check(dfwd, pvec)
        fwd_s, vag_s = adjoint_timing(dfwd, pvec)
        l2 = _l2(result, l2_time)
        grads_ok = all(np.isfinite(result.gradient[k]).all()
                       and abs(float(result.gradient[k]) - g)
                       <= 1e-9 * abs(g) and rel <= ADJ_RTOL
                       for k, (g, _fd, rel) in fd.items())
        return {"objective": result.objective,
                "gradient": {k: float(v) for k, v in
                             result.gradient.items()},
                "fd": {k: {"adjoint": g, "fd": f, "rel": r}
                       for k, (g, f, r) in fd.items()},
                "L2": l2, "L2_ref": l2_ref,
                "objective_forward_s": fwd_s, "value_and_gradient_s": vag_s,
                "adjoint_over_forward": (vag_s - fwd_s) / fwd_s,
                "stage_counts": dict(dfwd.stage_solve.counts),
                "ok": grads_ok and abs(l2 - l2_ref) <= 1e-4 * l2_ref}
    return check


def rol_check(want):
    """The check of a trust-region deck: the parameters it recovers."""
    def check(problem, result):
        x = np.asarray(result.x, dtype=float)
        return {"x": x.tolist(), "x_ref": list(want), "value": result.value,
                "iterations": result.iterations, "status": result.status,
                "ok": bool(np.all(np.abs(x - np.asarray(want))
                                  <= 1e-6 * np.abs(want)))}
    return check


def field_check(problem, result):
    """The check of the field inversion: its misfit falls 100-fold, and
    the adjoint gradient along a seeded direction equals central
    differences (the objective is quadratic in the field) to ADJ_RTOL."""
    from mrhyde_tpu_torch.analysis.forward_ad import DifferentiableForward
    pm = problem.param_manager
    dfwd = DifferentiableForward(problem, problem.objective_manager.value)
    extra = {"datagen": torch.zeros((), dtype=problem.dtype,
                                    device=problem.device)}
    f = torch.as_tensor(np.asarray(pm.specs["src_field"].value),
                        dtype=problem.dtype, device=problem.device)
    d = torch.as_tensor(np.random.RandomState(SEED).uniform(
        -1.0, 1.0, f.shape[0]), dtype=f.dtype, device=f.device)
    _v, g = dfwd.value_and_gradient({"src_field": f, **extra})
    h = 1e-3
    with torch.no_grad():
        jp = float(dfwd.objective({"src_field": f + h * d, **extra}))
        jm = float(dfwd.objective({"src_field": f - h * d, **extra}))
    fd = (jp - jm) / (2 * h)
    ad = float(torch.dot(g["src_field"], d))
    rel = abs(ad - fd) / abs(fd)
    v0, v1 = result.history[0][0], result.value
    return {"value0": v0, "value": v1, "iterations": result.iterations,
            "fd": {"adjoint": ad, "fd": fd, "rel": rel},
            "ok": v1 <= 1e-2 * v0 and rel <= ADJ_RTOL}


def uq_check(problem, result):
    """The check of the UQ + DCI deck: each response equals (amp /
    kappa)^2 C for one C (the deck is linear in amp / kappa) to 1e-9,
    C = int u_1^2 ~ 1/4, and DCI accepted some samples."""
    s, r = result["samples"], np.asarray(result["responses"], dtype=float)
    c = r * s["kappa"] ** 2 / s["amp"] ** 2
    spread = float(np.max(np.abs(c - c[0])) / c[0])
    return {"samples": int(r.shape[0]), "mean": float(result["stats"]["mean"]),
            "variance": float(result["stats"]["variance"]),
            "C": float(c[0]), "C_spread": spread,
            "acceptance_rate": result["dci"]["acceptance_rate"],
            "ok": spread <= 1e-9 and abs(c[0] - 0.25) <= 1e-3
            and 0 < result["dci"]["acceptance_rate"] <= 1}


def multiset_check(refs, rtol):
    """The check of a multi-set deck: every variable's L2 at each held
    time against the JAX package's, to its rtol."""
    def check(problem, result):
        errs = [{"time": t, "var": v, "L2": _l2(result, t, v),
                 "L2_ref": g, "rtol": rtol[v]} for t, ref in refs.items()
                for v, g in ref.items()]
        return {"errors": errs, "counts": result.counts,
                "ok": bool(errs) and all(
                    abs(e["L2"] - e["L2_ref"]) <= e["rtol"] * abs(e["L2_ref"])
                    for e in errs)}
    return check


def analysis_decks(device):
    """Phase analysis_decks: the steady forward+adjoint at 512^2
    (thermal_node_state), kappa = k0 + k1 e^2 at 256^2
    (thermal_node_full), the DIRK-2,2 adjoint at 256^2, the trust-region
    source inversion at 256^2, the discretized-field inversion at 128^2
    (general path), UQ + DCI with 64 samples at 512^2 and the NS + cdr
    multi-set start-up at 128x32 (ns_node_full and the cdr set's state
    kernel); returns each deck's launches. Alone on the card: python3 -c
    'import torch, chip_smoke; chip_smoke.analysis_decks(
    torch.device("cuda"))'. Rehearse a deck on the CPU with
    analysis_run at 16^2."""
    out = [
        analysis_run("adjoint_steady_nx512", adjoint_deck(512), device,
                     {"state"}, adjoint_check(0.0, REF_512_CG)),
        analysis_run("adjoint_nonlinear_nx256", adjoint_nonlinear_deck(256),
                     device, {"full"}, adjoint_check(0.0, NONLINEAR_L2)),
        analysis_run("adjoint_dirk22_nx256", adjoint_dirk_deck(256), device,
                     {"state"}, adjoint_check(0.4, DIRK_256_L2)),
        analysis_run("rol_source_nx256", rol_deck(256), device, {"state"},
                     rol_check((2.0, 0.5))),
        analysis_run("field_inversion_nx128", field_inversion_deck(128),
                     device, set(), field_check),
        analysis_run("uq_dci_nx512", uq_deck(512, 64), device, {"state"},
                     uq_check),
    ]
    for name, (build, n, rtol, refs) in MULTISET_DECKS.items():
        out.append(analysis_run(name, build(n), device, {"ns_full", "state"},
                                multiset_check(refs, rtol)))
    keys = ("n_dof", "setup_s", "run_s", "objective_forward_s",
            "value_and_gradient_s", "adjoint_over_forward")
    emit({"phase": "analysis_times", "decks": {
        rec["deck"]: {k: rec.get(k) for k in keys}
        for rec in RECORDS.values() if rec.get("phase") == "analysis_decks"}})
    return out


# ----------------------------------------------------------------------
# phase multiscale_decks: the Subgrid sublist's Dirichlet-to-Neumann fine
# solves (mrhyde_tpu_torch/multiscale/), batched on the card; no kernel
# ----------------------------------------------------------------------

MS_TRUE_T = "sin(2*pi*t)*sin(2.0*pi*x)*sin(2.0*pi*y)"
MS_SOURCE_T = ("(8*(pi*pi)*sin(2*pi*t)+2*pi*cos(2*pi*t))"
               "*sin(2*pi*x)*sin(2*pi*y)")
MS_TRUE_3 = "sin(2*pi*x)*sin(2*pi*y)*sin(2*pi*z)"


def multiscale_deck(n, refine=2, cell="quad", trace=None):
    """The reference's thermal/2D_verification_multiscale (the JAX
    package's tests/test_multiscale.py deck): an HGRAD macro trace e (no
    macro module) on n x n cells, e = 0 on the boundary, a DtN2 thermal
    subgrid of 2^refine per side (direct fine solves); gold at n = 4,
    refinements 2: L2-face(e) 0.198706, Subgrid 0 L2(e) 0.042848.
    trace = 0 / 1: an HFACE macro trace of that order instead (the
    reference's 2D_verification_multiscale_HFACE at order 1); cell "tri":
    triangles, the subgrid the macro cell itself (refinements 0)."""
    phys = {"Extra variables": {"e": "HGRAD"}, "assemble face terms": True,
            "Dirichlet conditions": {"e": {"all boundaries": "0.0"}}}
    order = {"Extra variables": {"e": 1}}
    solver = {"solver": "steady-state"}
    if trace is not None:
        phys = {"modules": "thermal", "assemble face terms": True,
                "Active variables": {"e": "HFACE"},
                "Dirichlet conditions": {"e": {"all boundaries": "0.0"}}}
        order = {"e": trace}
        solver["initial type"] = "none"
    return {
        "Mesh": {"dimension": 2, "element type": cell, "NX": n, "NY": n},
        "Functions": {"thermal source": SOURCE},
        "Physics": phys,
        "Discretization": {"order": order, "quadrature": 2},
        "Solver": solver,
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e face": S_TRUE}},
        "Subgrid": {
            "subgrid model": "DtN2",
            "Mesh": {"element type": cell, "refinements": refine,
                     "dimension": 2},
            "Physics": {"modules": "thermal",
                        "Neumann conditions": {"e": {"top": "0.0",
                                                     "bottom": "0.0"}}},
            "Solver": {"solver": "steady-state", "use direct solver": True},
            "Functions": {"thermal source": SOURCE},
            "Discretization": {"order": {"e": 1}, "quadrature": 2},
            "Postprocess": {"True solutions": {"e": S_TRUE}}},
    }


def multiscale_transient_deck(n, solver, refine=0, substeps=None):
    """The reference's thermal/2D_verification_multiscale_transient (the
    JAX package's tests/test_multiscale_transient.py `_cfg`): macro
    thermal on n x n, e = 0 on the boundary, u = sin(2 pi t) S, a
    synchronous thermal subgrid of 2^refine per side; `solver` the macro
    Solver keys (steps, tableau, BDF order). substeps: an asynchronous
    subgrid ('synchronous time stepping: false', BWE substeps) of that
    many fine steps per macro step."""
    sub = {"usage": "1.0",
           "Mesh": {"shape": "quad", "refinements": refine, "dim": 2},
           "Physics": {"modules": "thermal"},
           "Discretization": {"order": {"e": 1}, "quadrature": 2},
           "Solver": {"solver": "transient",
                      "synchronous time stepping": True},
           "Postprocess": {"True solutions": {"e": MS_TRUE_T}},
           "Functions": {"thermal source": MS_SOURCE_T}}
    if substeps is not None:
        sub.pop("usage")
        sub["subgrid model"] = "DtN"
        sub["Solver"] = {"solver": "transient",
                         "synchronous time stepping": False,
                         "number of steps": substeps}
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Functions": {"thermal source": MS_SOURCE_T},
        "Physics": {"modules": "thermal",
                    "Dirichlet conditions": {"e": {"all boundaries": "0.0"}}},
        "Discretization": {"order": {"e": 1}, "quadrature": 2},
        "Solver": {"solver": "transient", "final time": 1.0,
                   "allow backtracking": False, **solver},
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e": MS_TRUE_T}},
        "Subgrid": sub,
    }


def multiscale_hex_deck(n, refine=0):
    """The reference's thermal/3D_verification_multiscale: macro thermal
    on n^3 hex with face terms, e = 0 on the boundary, a thermal subgrid
    of 2^refine per side; gold at n = 10, refinements 0: L2-face(e)
    0.111135, Subgrid 0 L2(e) 0.00496611."""
    src = f"12*(pi*pi)*{MS_TRUE_3}"
    return {
        "Mesh": {"dimension": 3, "element type": "hex", "NX": n, "NY": n,
                 "NZ": n},
        "Physics": {"modules": "thermal", "assemble face terms": True,
                    "Dirichlet conditions": {"e": {"all boundaries": "0.0"}}},
        "Discretization": {"order": {"e": 1}, "quadrature": 2},
        "Solver": {"solver": "steady-state"},
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e face": MS_TRUE_3}},
        "Subgrid": {
            "Mesh": {"element type": "hex", "refinements": refine,
                     "dimension": 3},
            "Physics": {"modules": "thermal"},
            "Solver": {"solver": "steady-state"},
            "Functions": {"thermal source": src},
            "Discretization": {"order": {"e": 1}, "quadrature": 2},
            "Postprocess": {"True solutions": {"e": MS_TRUE_3}}},
        "Functions": {"thermal source": src},
    }


def _ms_model(refine, usage, transient=False):
    """One thermal subgrid model of a multimodel deck."""
    true, src = (MS_TRUE_T, MS_SOURCE_T) if transient \
        else (S_TRUE, SOURCE)
    return {"usage": usage,
            "Mesh": {"element type": "quad", "refinements": refine,
                     "dimension": 2},
            "Physics": {"modules": "thermal"},
            "Solver": {"solver": "transient" if transient
                       else "steady-state"},
            "Functions": {"thermal source": src},
            "Discretization": {"order": {"e": 1}, "quadrature": 2},
            "Postprocess": {"True solutions": {"e": true}}}


def multimodel_deck(n, workset=100):
    """The reference's thermal/2D_verification_multiscale_multimodel:
    two static subgrid models chosen by usage votes per (virtual rank x
    workset group) with 'assembly partitioning: subgrid-preserving',
    refinements 0 everywhere and 1 in the x < 0.5, y > 0.5 quarter; gold
    at n = 40: L2-face(e) 0.00176029, Subgrid 0 / 1 L2(e) 0.00035747 /
    0.000197984."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Physics": {"modules": "thermal", "assemble face terms": True,
                    "Dirichlet conditions": {"e": {"all boundaries": "0.0"}}},
        "Discretization": {"order": {"e": 1}, "quadrature": 2},
        "Solver": {"solver": "steady-state",
                   "assembly partitioning": "subgrid-preserving",
                   "workset size": workset},
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e face": S_TRUE}},
        "Subgrid": {"static subgrids": True,
                    "SG-R0": _ms_model(0, "1.0"),
                    "SG-R1": _ms_model(1, "(x<0.5)*(y>0.5)")},
    }


def dynamic_multimodel_deck(n, steps=4, ml=False, workset=4):
    """Three subgrid models whose usage moves with time (refinements 0,
    1 and 2 where x - t > 0.25 and x - 2 t > 0.5), re-voted at every
    step with the fine state L2-projected onto the new owner (the
    reference's thermal/2D_verification_multiscale_dynamicmultimodel
    mechanics); ml: 'subgrid model selection: ML' after 2 training
    steps."""
    cfg = multiscale_transient_deck(n, {"final time": 0.1 * steps,
                                        "number of steps": steps,
                                        "workset size": workset})
    cfg["Subgrid"] = {"static subgrids": False,
                      "SG0": _ms_model(0, "1.0", True),
                      "SG1": _ms_model(1, "(x-t>0.25)", True),
                      "SG2": _ms_model(2, "(x-2*t>0.5)", True)}
    if ml:
        cfg["Solver"].update({"subgrid model selection": "ML",
                              "max subgrid ML training steps": 2})
    return cfg


ms_gold_deck = partial(multiscale_deck, refine=2)
ms_full_deck = partial(multiscale_deck, refine=3)
ms_dirk33_deck = partial(multiscale_transient_deck, solver={
    "number of steps": 4, "transient BDF order": 1,
    "transient Butcher tableau": "DIRK-3,3", "max nonlinear iters": 4},
    refine=2)
ms_bwe_deck = partial(multiscale_transient_deck, solver={
    "number of steps": 5})
ms_async_deck = partial(multiscale_transient_deck, solver={
    "number of steps": 2, "final time": 0.2}, substeps=4)


def _ms_lines(lines):
    """{time: {label: value}} of (time, macro kind, macro value,
    Subgrid-L2 value) lines."""
    return {t: {f"e#{kind}" if kind != "L2" else "e": macro,
                "e#Subgrid-L2": sub} for t, kind, macro, sub in lines}


# name -> (builder, size, rtol vs JAX, JAX references {time: {label:
# L2}}, gold rtol, golds {time: {label: value}}). The JAX package's f64
# CPU numbers from tools/jax_references.py; labels as l2_labels, a
# subgrid model's as "e#Subgrid-L2[:k]". A gold's rtol is half a unit of
# its last printed digit unless it says otherwise.
MULTISCALE_DECKS = {
    "multiscale_dtn2_gold_nx4": (
        ms_gold_deck, 4, 1e-9,
        _ms_lines([(0.0, "L2-face", 0.19870638029295146,
                    0.04284802910601944)]),
        None, _ms_lines([(0.0, "L2-face", 0.198706, 0.042848)])),
    "multiscale_dtn2_nx256_r3": (
        ms_full_deck, 256, 1e-6,
        _ms_lines([(0.0, "L2-face", 4.29234752165103e-05,
                    6.784905577846628e-06)]), None, {}),
    "multiscale_dirk33_nx128_r2": (
        ms_dirk33_deck, 128, 1e-6,
        _ms_lines([(0.25, "L2", 0.0006899224375844061, 0.0007698086401325742),
                   (0.5, "L2", 0.014012389798517448, 0.01401461701528958),
                   (0.75, "L2", 0.00204294982482748, 0.002122860341866385),
                   (1.0, "L2", 0.013881742172795364, 0.013883948622911667)]),
        None, {}),
    "multiscale_bwe_gold_nx10": (
        ms_bwe_deck, 10, 1e-9,
        _ms_lines([(0.2, "L2", 0.03132062391700057, 0.022453546448544387),
                   (0.4, "L2", 0.029435745156898722, 0.02416440912483977),
                   (0.6, "L2", 0.012558512168752735, 0.00694295270330515),
                   (0.8, "L2", 0.037144088460347606, 0.028398151999801103),
                   (1.0, "L2", 0.010447452618891254, 0.01065500640248645)]),
        None,
        _ms_lines([(0.2, "L2", 0.0313206, 0.0224535),
                   (0.4, "L2", 0.0294357, 0.0241644),
                   (0.6, "L2", 0.0125585, 0.00694295),
                   (0.8, "L2", 0.0371441, 0.0283982),
                   (1.0, "L2", 0.0104475, 0.010655)])),
    "multiscale_multimodel_gold_nx40": (
        multimodel_deck, 40, 1e-9,
        {0.0: {"e#L2-face": 0.001760292308931635,
               "e#Subgrid-L2": 0.00035747028039020165,
               "e#Subgrid-L2:1": 0.00019798423306144903}}, None,
        {0.0: {"e#L2-face": 0.00176029, "e#Subgrid-L2": 0.00035747,
               "e#Subgrid-L2:1": 0.000197984}}),
    "multiscale_hex_gold_nx10": (
        multiscale_hex_deck, 10, 1e-9,
        _ms_lines([(0.0, "L2-face", 0.11113483299704692,
                    0.00496611245199939)]), None,
        _ms_lines([(0.0, "L2-face", 0.111135, 0.00496611)])),
    "multiscale_async_nx10": (
        ms_async_deck, 10, 1e-9,
        _ms_lines([(0.1, "L2", 0.013418905500332355, 0.007818713001550213),
                   (0.2, "L2", 0.024697594662211827, 0.01569463943775601)]),
        1e-8,
        _ms_lines([(0.1, "L2", 0.0134189055, 0.007818713002),
                   (0.2, "L2", 0.02469759466, 0.01569463944)])),
}


def ms_labels(errs):
    """l2_labels plus the subgrid models' norms ("e#Subgrid-L2:1")."""
    out = l2_labels(errs)
    out.update({f"{var}#{kind}": float(val)
                for (kind, var), val in errs.items()
                if kind.startswith("Subgrid-L2")})
    return out


def _printed_rtol(value):
    """Half a unit of the last digit of a 6-significant-digit gold,
    relative to it."""
    return 0.5 * 10.0 ** (np.floor(np.log10(abs(value))) - 5) / abs(value)


# the decks at full width, whose contributions are timed
MS_TIMED = ("multiscale_dtn2_nx256_r3", "multiscale_dirk33_nx128_r2")


def multiscale_run(name, cfg, device, refs, rtol, golds, gold_rtol):
    """One multiscale deck through make_problem(cfg).run() on the card:
    every label at every held time against the JAX reference (rtol) and
    the gold (gold_rtol, or its printed precision), no fused provider and
    no kernel launch, the peak device memory; then for the MS_TIMED decks
    the ms per residual_contribution and per jacobian_contribution at the
    solution (CUDA events, median of 3). Returns the launches (all
    zero)."""
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import make_problem
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = make_problem(cfg, device=device)
    t1 = time.perf_counter()
    for k in fp.LAUNCHES:
        fp.LAUNCHES[k] = 0
    result = problem.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(fp.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    hist = {round(t, 10): ms_labels(errs) for t, errs in result.error_history}
    checks = []
    for table, tol in ((refs, rtol), (golds, gold_rtol)):
        for t, labels in table.items():
            for label, want in labels.items():
                got = hist[round(t, 10)][label]
                r = float(tol if tol is not None else _printed_rtol(want))
                checks.append({"time": t, "label": label, "value": got,
                               "ref": want, "rtol": r,
                               "ok": bool(abs(got - want) <= r * abs(want))})
    ms = problem.multiscale
    u = result.u
    tc = assembly_tc(problem, u, result.time)
    pvec = None
    if ms.fine_prev is not None:
        # a transient deck: the stage entry of a BWE stage from the
        # committed fine state (the form its Newton steps read)
        A, b, w = np.ones((1, 1)), np.ones(1), np.array([1.0, -1.0])
        pvec = {"__ms": ms.stage_ms_entry(
            ms.blank_stages(1, u.dtype), 0, A, b, w, tc.alpha_t, u.dtype,
            t=result.time, dt=tc.deltat, u_prev=u[None])}
    # jacobian_blocks: the blocks and the residual from one jacfwd pass
    # a median of 3, for the script's time: the 256^2 deck's 2.6 s
    # jacobian_contribution takes ~8 s of timing
    timing = {k: cuda_ms(lambda f=f: f(u, tc, pvec), reps=3, warm=False)
              if name in MS_TIMED else None
              for k, f in (("residual_contribution_ms",
                            ms.residual_contribution),
                           ("jacobian_contribution_ms", ms.jacobian_blocks))}
    ok = all(c["ok"] for c in checks) \
        and not any(launches.values()) \
        and problem.assembler.fused_provider() is None \
        and bool(torch.isfinite(u).all()) \
        and u.device.type == torch.device(device).type
    sub = ms.models if hasattr(ms, "models") else [ms]
    rec = {"phase": "multiscale_decks", "deck": name, "n_dof": problem.n_dof,
           "macro_elems": int(problem.mesh.n_elem),
           "fine_dofs": [m.n_fine_dof for m in sub],
           "fine_elems_per_macro": [int(m.fine_disc.mesh.n_elem)
                                    for m in sub],
           "linear_method": problem._linear_method(),
           "checks": checks, "recorded_times": len(result.error_history),
           **result.counts, "setup_s": t1 - t0, "solve_s": t2 - t1,
           **timing, "max_memory_allocated": peak,
           "launches": launches, "ok": ok}
    emit(rec)
    RECORDS[name] = rec
    if not ok:
        raise SystemExit(f"phase multiscale_decks, deck {name} failed: "
                         f"{rec}")
    return launches


def multiscale_decks(device, decks=None):
    """Phase multiscale_decks: MULTISCALE_DECKS (or `decks`, a table of
    the same form), each through make_problem(cfg).run() on the card and
    held to its JAX reference and gold; returns each deck's launches (no
    kernel is on this path: all zero). Alone on the card: python3 -c
    'import torch, chip_smoke; chip_smoke.multiscale_decks(
    torch.device("cuda"))'."""
    return [multiscale_run(name, build(n), device, refs, rtol, golds,
                           gold_rtol)
            for name, (build, n, rtol, refs, gold_rtol, golds) in
            (decks or MULTISCALE_DECKS).items()]


def field_boundary_deck(n):
    """The JAX package's field-parameter boundary-group deck
    (tests/test_deck_sharded.py): thermal with source 1 + x y, e = 0 on
    the left and bottom sides, Neumann fluxes 2 bflux on the right and
    bflux^2 - y on the top, which read the discretized parameter bflux
    (HGRAD order 1, value 1) at side quadrature points; its L2 against 0
    is ||e||."""
    cfg = deck(n, source="1.0 + x*y")
    cfg["Physics"]["Dirichlet conditions"] = {
        "scalar data": True, "e": {"left": 0.0, "bottom": 0.0}}
    cfg["Physics"]["Neumann conditions"] = {
        "e": {"right": "2.0*bflux", "top": "bflux*bflux - y"}}
    cfg["Parameters"] = {"bflux": {"usage": "discretized", "basis": "HGRAD",
                                   "order": 1, "value": 1.0}}
    cfg["Postprocess"]["True solutions"] = {"e": "0.0"}
    return cfg


# the keys that take a symmetric deck's Newton solves to the f64 floor in
# both runs of a sharded_decks pair (the sharded CG's fixed count of
# iterations, `max linear iters`, set per deck): a sharded and an
# unsharded run stopped at 1e-10 agree to ~1e-9 in L2 on a 128^2 mesh,
# at these keys to ~4e-12 (the L2 error is ~1e-4 of |e| there)
FLOOR = {"Belos solver": "CG", "nonlinear TOL": 1e-13, "linear TOL": 1e-14}


def ms_replicated_deck(n):
    """The multiscale gold deck under the element-sharded scheme."""
    cfg = ms_gold_deck(n)
    cfg["Solver"]["sharded scheme"] = "replicated"
    return cfg


MS_GOLDS = _ms_lines([(0.0, "L2-face", 0.198706, 0.042848)])
# name -> (deck function of the mesh size, size, shards, rtol against the
# same deck unsharded on the card, [(references {time: {label: L2}},
# rtol)]): the JAX package's f64 CPU L2 (tools/jax_references.py; NS and
# the field-parameter deck with --shards, on 8 virtual CPU devices) or
# the reference's golds
SHARDED_DECKS = {
    # Newton to 1e-12: at 1e-13 both runs take all 10 steps (28.1 s of
    # sharded solve on an NVIDIA H100 80GB HBM3 at 700 W)
    "nonlinear_nx256_shards4": (
        lambda n: with_solver(nonlinear_deck(n), **dict(FLOOR, **{
            "nonlinear TOL": 1e-12, "max linear iters": 2000})),
        256, 4, 1e-10, [({0.0: {"e": NONLINEAR_L2}}, 1e-4)]),
    # the start-up's pressure (and uy) is held looser against the
    # unsharded run: GMRES(60) x 4 and the unsharded GMRES (at its
    # 2,000-iteration cap here) stop at the Newton tolerance with
    # different pressures, whose rows weigh ~h^2 of the momentum rows; the
    # JAX package's sharded run differs from its unsharded one (NS_STARTUP)
    # by 5.7e-4 in L2(pr) and 1.0e-7 in L2(uy) on this deck
    # the unsharded run: deck 13's, the same deck (when the phase runs
    # alone, its own)
    "ns_startup_dirk22_nx256_shards8": (
        ns_startup_deck, 256, 8, {"ux": 1e-8, "uy": 1e-6, "pr": 2e-3},
        [({0.01: {"pr": 0.0003158922457459171, "ux": 0.18482842715870781,
                  "uy": 3.690301193713985e-06},
           0.02: {"pr": 0.0004176389528159997, "ux": 0.1674366653372132,
                  "uy": 4.619296039154203e-06}}, 1e-6)]),
    "multiblock_nx256_shards4": (
        lambda n: multiblock_deck(n, dict(FLOOR, **{
            "max linear iters": 2500, "max nonlinear iters": 3})),
        256, 4, 1e-10, [(MESH_DECKS["multiblock_nx256"][3], 1e-4)]),
    "multiscale_dtn2_gold_nx4_shards4": (
        ms_gold_deck, 4, 4, 1e-10,
        [(MULTISCALE_DECKS["multiscale_dtn2_gold_nx4"][3], 1e-9),
         (MS_GOLDS, 1e-3)]),
    "multiscale_dtn2_gold_nx4_shards8_replicated": (
        ms_replicated_deck, 4, 8, 1e-10,
        [(MULTISCALE_DECKS["multiscale_dtn2_gold_nx4"][3], 1e-9),
         (MS_GOLDS, 1e-3)]),
    "field_boundary_nx128_shards8": (
        lambda n: with_solver(field_boundary_deck(n), **FLOOR, **{
            "max linear iters": 1000, "max nonlinear iters": 2}),
        128, 8, 1e-10, [({0.0: {"e": 0.7561182026743986}}, 1e-9)]),
}


SHARDED_BASES = {"ns_startup_dirk22_nx256_shards8": "ns_startup_dirk22_nx256"}


def sharded_run(name, cfg, shards, device, rtol, refs):
    """One deck through make_problem(cfg).run() on the card unsharded and
    with `Solver: shards` (all shards stacked on the one card,
    StackedComm): every label at every recorded time of the sharded run
    against the unsharded run's (rtol) and against each reference table
    (its rtol); the sharded run launches no kernel (its assembly is the
    general path's vmap(jacfwd)). The unsharded run of a deck that an
    earlier phase ran as it is (SHARDED_BASES) is that phase's. Records
    both runs' set-up and solve s and their stage, Newton and Krylov
    counts; returns the sharded run's launches (all zero)."""
    import copy
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import make_problem
    runs = {}
    base = SHARDED_BASES.get(name)
    if base in LABELS:
        r = RECORDS[base]
        runs[0] = {"from": base, "labels": LABELS[base], "finite": True,
                   **{k: r[k] for k in ("setup_s", "solve_s", "launches",
                                        "stages", "newton_iters",
                                        "linear_iters")}}
    for s in [shards] if 0 in runs else [0, shards]:
        c = copy.deepcopy(cfg)
        if s:
            c["Solver"]["shards"] = s
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        problem = make_problem(c, device=device)
        t1 = time.perf_counter()
        for k in fp.LAUNCHES:
            fp.LAUNCHES[k] = 0
        result = problem.run()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        u = result.u
        runs[s] = {"setup_s": t1 - t0, "solve_s": t2 - t1,
                   "launches": dict(fp.LAUNCHES), **result.counts,
                   "labels": {round(t, 10): ms_labels(errs)
                              for t, errs in result.error_history},
                   "finite": bool(torch.isfinite(u).all())
                   and u.device.type == torch.device(device).type,
                   "scheme": type(problem._newton_fn()).__name__}
    got, base = runs[shards]["labels"], runs[0]["labels"]
    checks = []
    tables = [({t: {k: v for k, v in lb.items()} for t, lb in base.items()},
               rtol, "unsharded")] + [(tb, tol, "reference")
                                      for tb, tol in refs]
    for table, tol, kind in tables:
        for t, labels in table.items():
            for label, want in labels.items():
                r = tol[label] if isinstance(tol, dict) else tol
                value = got[round(t, 10)][label]
                # a norm exact to round-off (the initial state's) is held
                # absolutely
                checks.append({"against": kind, "time": t, "label": label,
                               "value": value, "ref": want, "rtol": r,
                               "ok": bool(abs(value - want) <= max(
                                   r * abs(want), 1e-13))})
    sharded = runs[shards]
    ok = all(c["ok"] for c in checks) and sharded["finite"] \
        and runs[0]["finite"] and not any(sharded["launches"].values()) \
        and sharded["scheme"] != "function"
    rec = {"phase": "sharded_decks", "deck": name, "shards": shards,
           "checks": checks, "ok": ok,
           **{("sharded" if s else "unsharded"): {
               k: v for k, v in r.items() if k != "labels"}
              for s, r in runs.items()}}
    emit(rec)
    RECORDS[name] = rec
    if not ok:
        raise SystemExit(f"phase sharded_decks, deck {name} failed: {rec}")
    return sharded["launches"]


def sharded_decks(device, decks=None):
    """Phase sharded_decks: SHARDED_DECKS (or `decks`, a table of the same
    form), each unsharded and sharded on the card, held to each other and
    to the JAX package's references; returns each sharded run's launches
    (no kernel is on this path: all zero). Alone on the card: python3 -c
    'import torch, chip_smoke; chip_smoke.sharded_decks(
    torch.device("cuda"))'."""
    return [sharded_run(name, build(n), shards, device, rtol, refs)
            for name, (build, n, shards, rtol, refs) in
            (decks or SHARDED_DECKS).items()]


def set_sources():
    """The generated kernel sources of phases 3f and 3g's cases and the
    module-set decks (each deck's weak form at its size 4 on the CPU: the
    source does not depend on the mesh size), to build before any of them
    runs."""
    from mrhyde_tpu_torch.problem import Problem
    texts = [set_case(name, 1.0)[0].source for name in SET_KERNEL_CASES]
    texts += [set_elem_case(name, 1.0)[0].source
              for name in SET_ELEM_KERNEL_CASES]
    texts += [state_case(name, 1.0)[0].source for name in STATE_KERNEL_CASES]
    for build in [boussinesq_deck] + [b for b, *_ in SET_DECKS.values()] \
            + [b for b, *_ in SET_ELEM_DECKS.values()] \
            + [b for b, *_ in AFFINE_SET_DECKS.values()] \
            + [b for b, *_ in QUADRATURE_DECKS.values()]:
        fused = Problem(build(4), device="cpu", dtype=torch.float64) \
            .assembler.fused_provider()
        if hasattr(fused, "form"):
            texts.append(fused.form.source)
    return list(dict.fromkeys(texts))


def main(argv=()):
    global SEED
    if list(argv[:1]) == ["--seed"]:
        SEED = int(argv[1])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from concurrent.futures import ThreadPoolExecutor
    from mrhyde_tpu_torch.ops import _build
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    t0 = time.perf_counter()
    texts = set_sources()
    t1 = time.perf_counter()
    # every nvcc at once: the csrc/*.cu libraries and the generated ones
    with ThreadPoolExecutor(1) as pool:
        gen = pool.submit(_build.build_generated, texts)
        _build.load_library()
        gen_logs = gen.result()

    def ptxas(log):
        return [ln for ln in log.splitlines() if "registers" in ln
                or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources_s": t1 - t0, "generated": len(texts),
          "ptxas": ptxas(_build.build_log()),
          "ptxas_generated": {k: ptxas(v) for k, v in gen_logs.items()}})

    summary = phase_kernels(device)
    summary["ns_node_full"] = phase_ns_kernels(device)
    summary.update(phase_elem_kernels(device))
    elem_state_cases = summary.pop("thermal_elem_state cases")
    advect = phase_advect_kernels(device)
    summary["ns_elem_full"] = phase_ns_elem_kernels(device)
    summary["set_node_full"] = phase_set_kernels(device)
    set_elem = phase_set_elem_kernels(device)
    summary["set_elem_full"] = set_elem["ns+cdr pspg+supg dirk22 stage 1"]
    state = phase_state_kernels(device)
    summary["set_node_state"] = state["set_node_state"]
    summary["set_elem_state"] = state["set_elem_state"]
    quadrature = phase_quadrature_kernels(device)

    per_deck = [
        run_deck("gold_nx40", deck(40), device,
                 [(0.0, "e", 0.00102776, 2e-5)], "state"),
        run_deck("default_nx1024",
                 deck(1024, solver={"nonlinear TOL": 1e-10}),
                 device, [(0.0, "e", 1.56873e-06, 1e-4)], "state"),
        run_deck("nonlinear_nx256", nonlinear_deck(256),
                 device, [(0.0, "e", NONLINEAR_L2, 1e-4)], "full"),
        run_deck("transient_gold_nx40",
                 transient_deck(40, {
                     "transient Butcher tableau": "BWE",
                     "transient BDF order": 1, "final time": 1.0,
                     "number of steps": 20, "nonlinear TOL": 1e-7,
                     "max nonlinear iters": 2}),
                 device, [(0.9, "e", 0.00509256, 2e-5),
                          (1.0, "e", 0.00118468, 2e-5)], "state"),
        run_deck(f"transient_dirk22_nx{DIRK_N}",
                 transient_deck(DIRK_N, {
                     "transient Butcher tableau": "DIRK-2,2",
                     "final time": 0.4, "number of steps": 8,
                     "nonlinear TOL": 1e-10}),
                 device, [(0.4, "e", DIRK_L2, 1e-4)], "state"),
        run_deck("transient_nonlinear_bdf2_nx256", bdf2_nonlinear_deck(256),
                 device, [(0.2, "e", BDF2_NL_L2, 1e-4)], "full"),
        run_deck("ode_bdf2", ode_bdf2_deck(), device,
                 [(1.0, "q", 0.00106624, 2e-5)], None),
        run_deck("ns_channel_gold_nx50",
                 ns_deck(50, 10, {"use direct solver": True}), device,
                 [(0.0, v, g, 2e-5) for v, g in
                  (("ux", 0.00198075), ("pr", 0.0148536),
                   ("uy", 0.000169464))], "ns_full"),
        run_deck("ns_channel_direct_nx128",
                 ns_deck(128, 32, {"use direct solver": True,
                               "nonlinear TOL": 1e-8}), device,
                 [(0.0, v, g, 1e-4) for v, g in
                  zip(("ux", "pr", "uy"), NS_DIRECT_128)], "ns_full"),
    ] + [run_deck(f"ns_startup_dirk22_nx{n}", ns_startup_deck(n), device,
                  [(t, v, g, rtol) for t, ref in refs.items()
                   for v, g in zip(("ux", "pr", "uy"), ref)], "ns_full")
         for n, (rtol, refs) in NS_STARTUP.items()] + [
        run_deck("hex_gold_nx10", hex_deck(10), device,
                 [(0.0, "e", 0.0116656, 2e-5)], "elem_state"),
    ] + [
        run_deck(name, build(n), device, [(t, var, ref, 1e-4)], mode)
        for name, (build, n, t, var, mode, ref) in HEX_DECKS.items()] + [
        run_deck("p2_default_nx256",
                 p2_deck(256, solver={"nonlinear TOL": 1e-10}), device,
                 [(0.0, "e", P2_DEFAULT_L2, 1e-4)], "elem_state"),
        run_deck("p2_nonlinear_nx128",
                 p2_deck(128, "1.0 + e*e", SOURCE_NL,
                         {"nonlinear TOL": 1e-10, "Belos solver": "CG"}),
                 device, [(0.0, "e", P2_NL_L2, 1e-4)], "elem_full"),
    ] + [
        run_deck(name, build(n), device,
                 [(t, v, g, rtol) for t, ref in refs.items()
                  for v, g in ref.items()], "ns_elem_full")
        for name, (build, n, rtol, refs) in NS_ELEM_DECKS.items()]
    advect_decks = [
        run_deck("cdr_gold_nx40", cdr_gold_deck(), device,
                 [(0.0, "c", 0.00101714, 2e-5)], "full")] + [
        run_deck(name, build(n), device, [(t, var, ref, 1e-4)], mode)
        for name, (build, n, t, var, mode, ref) in CDR_DECKS.items()]
    per_deck += advect_decks
    per_deck += run_boussinesq(device) + [
        run_deck(name, build(n), device,
                 [(t, v, g, rtol) for t, ref in refs.items()
                  for v, g in ref.items()], "set_node_full")
        for name, (build, n, rtol, refs) in SET_DECKS.items()] + [
        run_deck(name, build(n), device,
                 [(t, v, g, rtol) for t, ref in refs.items()
                  for v, g in ref.items()], "set_elem_full")
        for name, (build, n, rtol, refs) in SET_ELEM_DECKS.items()]
    per_deck += [
        run_deck("thermal_mixed_neumann_gold_nx40", mixed_neumann_deck(40),
                 device, [(0.0, "e", 0.00102733, 2e-5)], "state")] + [
        run_deck(name, build(n), device,
                 [(t, v, g, rtol) for t, ref in refs.items()
                  for v, g in ref.items()], mode)
        for name, (build, n, rtol, refs, mode) in {
            **BOUNDARY_DECKS, **AFFINE_SET_DECKS,
            **QUADRATURE_DECKS}.items()]
    phase_precond(device)
    solver_decks = [
        run_deck(name, build(n), device,
                 [(t, v, g, rtol) for t, ref in refs.items()
                  for v, g in ref.items()], mode)
        for name, (build, n, rtol, refs, mode, _jacobi) in
        SOLVER_DECKS.items()]
    per_deck += solver_decks
    # each solver deck beside the deck of an earlier phase that runs the
    # same problem with Jacobi
    keys = ("linear_method", "setup_s", "solve_s", "stages", "newton_iters",
            "linear_iters")
    emit({"phase": "solvers", "decks": {
        name: {**{k: RECORDS[name].get(k) for k in (
            "precond_variant", "hierarchy", "hierarchy_s") + keys},
            "jacobi_deck": jacobi,
            "jacobi": {k: RECORDS[jacobi][k] for k in keys}}
        for name, (*_deck, jacobi) in SOLVER_DECKS.items()}})
    per_deck += mesh_solid_decks(device)
    per_deck += physics_decks(device)
    per_deck += vector_decks(device)
    per_deck += analysis_decks(device)
    per_deck += multiscale_decks(device)
    per_deck += sharded_decks(device)
    launches = {k: sum(d[k] for d in per_deck) for k in fp.LAUNCHES}
    advect_launches = {k: sum(d[k] for d in advect_decks)
                       for k in fp.LAUNCHES}
    emit({"phase": "launches", **launches})
    emit({"phase": "launches_advect", **advect_launches})
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of the main path never launched: "
                         f"{launches}")
    missing = [k for k in ("state", "full", "elem_state", "elem_full")
               if advect_launches[k] <= 0]
    if missing:
        raise SystemExit(f"the advection decks never launched {missing}: "
                         f"{advect_launches}")

    csrc = "mrhyde_tpu_torch/ops/csrc/"
    kernels = []
    # no single PyTorch call computes a node-scatter or an element-tile
    # assembly: library_ms is null for all ten. The four thermal kernels
    # report their advection (ADVECT) case and its launches beside: the
    # cdr and thermal-advection decks' share of `launches`; set_elem_full
    # reports every phase 3g case (f64, the divisible shape) beside, the
    # state kernels every phase 3h case, and ns_elem_full, set_elem_full,
    # set_node_full, ns_node_full and thermal_node_state their phase 3i
    # case ("quadrature", f64).
    for name, mode, src, line in (
            ("thermal_node_state", "state", "fused_p1_thermal.cu", 1350),
            ("thermal_node_full", "full", "fused_p1_thermal.cu", 1350),
            ("ns_node_full", "ns_full", "fused_p1_ns.cu", 1350),
            ("thermal_elem_state", "elem_state", "fused_elem_thermal.cu",
             1303),
            ("thermal_elem_full", "elem_full", "fused_elem_thermal.cu",
             1303),
            ("ns_elem_full", "ns_elem_full", "elem_engine.cuh", 1303),
            ("set_node_full", "set_node_full", "set_node.cuh", 1350),
            ("set_elem_full", "set_elem_full", "elem_engine.cuh", 1303),
            ("set_node_state", "set_node_state", "set_node.cuh", 1350),
            ("set_elem_state", "set_elem_state", "set_elem.cuh", 1303)):
        rec = summary[name]
        kernels.append({"name": name, "route": "cuda", "source": csrc + src,
                        "replaces": f"mrhyde_tpu/ops/fused_p1.py:{line}",
                        "launches": launches[mode],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"], "library_ms": None})
        if name in advect:
            a = advect[name]
            kernels[-1]["advect"] = {
                "case": a["case"], "shape": a["shape"],
                "launches": advect_launches[mode],
                "max_abs_err": a["max_abs_err"], "ms": a["ms"],
                "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
                "bound_by": a["bound_by"], "library_ms": None}
        if name == "set_elem_full":
            kernels[-1]["cases"] = [
                {k: c[k] for k in ("case", "mesh", "shape", "nd",
                                   "jac_rows", "max_abs_err", "ms",
                                   "plain_ms", "bound_ms", "bound_by")}
                for c in set_elem.values()]
        if name == "thermal_elem_state":
            kernels[-1]["cases"] = [
                {k: c[k] for k in ("case", "mesh", "shape", "max_abs_err",
                                   "ms", "plain_ms", "bound_ms", "bound_by")}
                for c in elem_state_cases]
        if name in ("set_node_state", "set_elem_state"):
            kernels[-1]["cases"] = [
                {k: c[k] for k in ("case", "mesh", "shape", "max_abs_err",
                                   "ms", "plain_ms", "bound_ms", "bound_by")}
                for c in state["cases"] if c["kernel"] == name]
        if name in quadrature:
            q = quadrature[name]
            kernels[-1]["quadrature"] = {
                k: q[k] for k in ("Q", "mesh", "shape", "jac_rows",
                                  "max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by")}
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
