#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (dgvit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a host with a CUDA card, nvcc and
nothing built: it builds the kernels itself (into build/kernels/, one nvcc
per source, all at once), then

  1. device: prints the card's name and power limit (nvidia-smi), and
     the CUDA kernels behind K5's wrapper (torch.profiler);
  2. K1 against its plain version: the whole-trunk kernel
     (got_forward_fused) and got_forward_plain on the same inputs, with
     the trained flagship actor's weights
     (artifacts/r5/dr_randm32_s11_amin_actor.npz), bf16 at
     B in {1, 3, 8, 16, 32, 64, 100, 2048} and fp32 at B in {1, 8, 16,
     100}; each batch in
     the form K1's route picks (the cluster up to 90 frames, two frames a
     thread block past that; k1_form), and every form (the cluster, two
     frames a block, the FMA trunk_kernel) forced at B=32 and B=2048 and
     held by itself on 65 launches of 32 frames; in bf16 held to the
     float64-sum version of the plain version (exact_sums; the rule at
     EXACT_K), and three wrong trunks (erf GELU, residual kept in fp32
     across blocks, the embedding left in fp32 before the positional add)
     must FAIL the same checks; in fp32 the route (the fp32 cluster form
     on the tensor cores to 90 frames, the FMA trunk_kernel past them),
     each fp32 form forced at every batch and the float64-sum version
     within F32_TOL of the plain version, a mis-scaled trunk outside it;
     and (gap p) the first block's MLP hidden of K1's fp32 body (the fp32
     probe) held to its float64-sum version (pooled, K1_HIDDEN_MEAN),
     which a tanh GELU must fail;
  3. policy through the kernel: make_action_fn on the card serves the 16
     golden frames; actions held against the plain path on the card and
     against the JAX package's fp32 actions (tests/data/
     torch_port_golden.npz);
  4. serving, the first main path: a BatchingActorServer (buckets
     1/8/16/32) answers 32 client threads x 4 requests; every answer
     equals the direct act for that row, and K1's launch count rose; each
     bucket's CUDA kernels by name (torch.profiler): K1's cluster form,
     k1_cluster_kernel, and no other K1 kernel;
  5. the training kernels against their plain versions (K4, K2 forward
     and backward, K3 forward and backward): the trained actor's and a
     seeded critic's blocks on embedded streams of seeded frames, bf16 at
     B in {1, 32, 256} and fp32 at B in {1, 8}; outputs, dx and all 11
     weight gradients; wrong bf16 versions must FAIL the same bf16
     limits: for K2b and K3b autograd of the plain forward (which rounds
     at other points than the hand-placed ones), for K3b also k and v of
     the recompute left in fp32 (its tensor-core projection's outputs),
     for K4 an erf GELU and the residual kept in fp32 across blocks, for
     K2f the probabilities left in fp32 before P.V, for K3f an erf GELU,
     the probabilities in fp32 and k and v in fp32, whose float64-sum
     version must pass; fp32 K3b and K4, K4's pooled bf16 latent and
     bf16 K2b (gap q: by frame and pooled) held to the float64-sum
     version, fp32 K2b (gap r: pooled over its tensors and batches) to
     the float64 evaluation (the rules at EXACT_K), fp32 K2b's and K4's
     tanh GELU and mis-scaled scores failing them (fp32 K2f, K2b and K4
     at the flagship widths take their cluster forms);
 5b. the bf16 forward and backward off the flagship widths (81 tokens,
     2 x 32 heads, an unaligned x) take the FMA bodies, not the
     tensor-core ones, and K2f, K3f, K2b and K3b there meet the bf16
     limits of 5, K4 phase 5's per-tensor max and phase 13's per-frame
     rule, K6 (also with only its CLS block's w1 unaligned) phase 13's
     pooled mean and its per-frame rule against the float64-sum version,
     each frame on its own scale, which phase 13's two wrong backwards
     must fail at these widths;
 5c. the weight products of the backwards (wgrad_mma_kernel on the
     tensor cores in bf16, wgrad_kernel else) against wgrad_plain, which
     sums the kernels' row segments in their order (its wgrad_splits
     equal to the library's segment counts): the default update's shapes
     at B=256, K3b's CLS operands and awkward ones (rows not a multiple
     of the chunk, K and N not multiples of 64, K not a multiple of 8, an
     unaligned A), bf16 and fp32; the update's six at B=256 timed on the
     tensor cores beside the FMA kernel and beside `a.t() @ b` (cuBLAS),
     by CUDA events and by device time;
  6. the SAC update, the second main path: a bf16 SACAgent (batch 256,
     emb-dropout 0.1) takes 5 learn steps on a seeded replay batch with
     finite losses, each step launching exactly K4 x3, K2f x6, K2b x6,
     K3f x2 and K3b x2 (and no K6, K7 or K8); then one fp32 update
     through the kernels matches
     the same update through the plain versions on the card and the JAX
     golden update (tests/data/torch_sac_golden.npz);
  7. profile: one more bf16 update under torch.profiler, device time by
     CUDA kernel, in all and per call, the weight products' total, the
     device's busy share of the update, and its CUDA launches by kernel
     name held to the design (K4, K2f, K2b, K3b and the weight products
     on the tensor-core kernels at the flagship widths);
  8. times: K1 and its plain version at B in {1, 32, 64, 2048}, K1 in
     the form its route picks and in its other forms, the cluster and two
     frames a block about the boundary between them, and the training
     kernels at B=256 (median of CUDA-event timings), beside
     their bounds, the kernels redesigned for the tensor cores (K2b, K4,
     K2f, K3b, K3f) also beside their earlier designs' times (K3f's FMA
     kernel also in this run), K2b and K3b also by device time split
     into the per-frame pass and the weight products, and K4 by depth;
  9. K5 against its plain version: the fused depth ingest
     (preprocess_depth_fused) and preprocess_depth_plain on raw 512x640
     frames at B in {1, 3, 32, 256}, sigma 0 and 50: uniform frames,
     frames rendered by the port's kinematic env, a constant frame and
     one of extreme range; two wrong chains (the band blur reflected at
     the image's edges instead of the band's own; round instead of floor
     in the normalisation) must FAIL the same limit; the noise's mean and
     spread against the chain with torch.randn noise, determinism for a
     seed, difference between seeds, frame-alone = frame-in-batch;
 10. camera to action, the third main path: 32 raw frames ->
     preprocess_depth_auto (K5) -> make_action_fn with the trained actor
     (K1) -> velocity commands, held against the plain path on the card,
     with K5 and K1 launched exactly once each;
 11. train and evaluate, the fourth main path: train_rl.train at the
     flagship width (bf16, batch 256) on the kinematic RRC env until
     about 100 updates have run; every update launches exactly K4 x3,
     K2f x6, K2b x6, K3f x2, K3b x2 and every action K1 x1; finite
     metrics; a checkpoint is written, `resume` restores it and the next
     update equals the one taken without the restart; the saved actor
     reloads through load_params_npz -> params_from_jax and gives the
     same actions; the same run again with sac.prefetch_batches, held to
     the same launch counts; then the guided trainer: demos the port
     records itself (train/demo_record.py) in an expert buffer
     (train.pre_buffer), and human intervention from a fake teleop with
     no expert buffer, every update launching phase 18's counts; then
     run_eval for 3 episodes; env steps/s, updates/s and the split of the
     loop into env, act, sample+copy and learn, for each run;
 12. times of K5 and its plain version at B in {1, 32, 256} beside its
     bound;
 13. K6 against its plain version (trunk_bwd_fused, trunk_bwd_plain),
     both differentiating the streams K4 writes for the same x: the
     trained actor's trunk with its RMS norm and the seeded critic's with
     a Layer norm, bf16 and fp32 at B in {1, 3, 8, 256}, 65 tokens and
     17; dx, the 44 block gradients and the final norm's (fp32 held to
     the float64-sum version); two wrong
     backwards (autograd of the plain forward; a chain that hands dx on
     in fp32) must FAIL the bf16 limits; and the K3b + K2b chain of
     per-block kernels, and K6, against the float64-sum version of K6's
     plain version by frame, each on its own scale (CHAIN_WITHIN), over
     those cases and 7 more draws of 256 frames (K6's bf16 check by this
     rule too), and each weight gradient pooled, the wrong backwards
     failing;
 13a. fault j measured (phase_fault_j, run last): K4's FMA body and its
     K4 form on the same x (actor and critic, B=256) write their streams;
     the share of frames whose streams differ, and K6's dx on each set
     against the float64-sum backward on the K4 form's, printed;
 13b. faults j and k (phase_recompute, run last): the intermediates
     K2b's per-frame pass recomputes against those K2f's body computed (a
     probe of the forward); the CLS row's q, o, h2 and hid that K3b and
     K6 (on each body of K4) work with against those the forward kept in
     its CLS records: without the records (the body before fault k's
     repair, recomputing them) the share of frames that differ, printed;
     with them (the route) equal on every frame, held, and their dx
     within phase 13's per-frame line of float64 sums; K3b's recomputed k
     and v against K3f's; the records themselves anchored to the forward
     that wrote them (K3f's, each body's of K4 and those of K4's plain
     version: each part recomputed from the block's input and the
     record's earlier parts, and the block's CLS output from x1 and z,
     pooled within ANCHOR_MEAN), four planted wrong records failing; in
     fp32 at B = 64 and 32 on the 2d BC policy's first block, K2b's
     cluster form against K2f's (the fp32 probe, whose output must be
     K2f's): h1, o, h2 and hid equal on every frame;
 14. the trunk-gradient update, the fifth main path: with
     DGVIT_TRUNK_GRAD=1 a bf16 SACAgent takes 5 learn steps at B=256, each
     launching exactly K4 x5 and K6 x2 and no per-block kernel; one fp32
     update on that route (its 3 no-grad K4 on the fp32 cluster form, the
     2 that record K6's streams on the FMA body) matches the plain
     versions on the card and the default-route update from the same
     state; a profiled update's CUDA
     launches are those designed; ms per update beside the default
     route's;
 15. K7 and K8 against their plain versions (fused_attention_section at
     (256, 65, 64), bf16 on its tensor-core form, and 256 tokens;
     attention_fused at (256, 4, 65, 64), (64, 4, 257, 64) and D = 160),
     bf16 and fp32, forward and backward; versions that leave padded keys
     unmasked or mis-scale must FAIL, and K7's with the probabilities or
     each head's output left in fp32, whose float64-sum version must
     pass; K7's FMA kernel on an unaligned x; the fp32 K8 (3xTF32 on the
     tensor cores) with its float64-sum version, which must pass;
 16. the composed routes through the model, main paths: the flagship
     actor with GoT(dropout=0.1), a training forward and backward at
     B=256 (K7 x4; in bf16 its tensor-core form, by the profile's kernel
     names); build_actor(cfg, attn_impl="pallas"), an acting
     forward at B=256 (K8 x4, K1 x0), its actions against the K1 route's;
     model.patch_size (8, 10), 257 tokens, at B=64 (K8 x4 by `auto`);
     the two bf16 checks against the composition, restated (lead l,
     EXACT_K): each route held to the float64-sum version of its plain
     route, pooled over its output and its blocks' outputs, K7's and K8's
     wrong rounding points failing; the composition's distances, the
     dropout masks of the two passes and, block by block, where they
     part, printed;
 17. times of K6, K7, K8 and their plain versions beside their bounds,
     K6, K7 and K8 (redesigned for the tensor cores) also beside their
     earlier design's times, K7 beside its FMA kernel in this run and
     beside x @ wqkv, scaled_dot_product_attention and @ wout + bout, and
     torch's scaled_dot_product_attention beside K8, both also by device
     time (torch.profiler); the fp32 K8 at the same shapes beside its
     first design (the FMA attention_kernel), its plain version, its
     bound and scaled_dot_product_attention;
 17b. long frames: every byte count of ops/smem.py against the
     libraries' own queries (the tensor-core bodies' and each form of
     K1's too); then
     frames of 90, 129 and 256 tokens (past the 80 rows of the
     tensor-core bodies: the FMA bodies), fp32
     and bf16, through acting, the learn forward, the gradient route and
     the trunk-gradient route of the trained actor's trunk, each call on
     the route the shared-memory rule picks (fused where the route's
     kernels hold the frame, else composed), with exactly that route's
     launches, its latent and gradients against the plain version of the
     same route (bf16: against its float64-sum version, where two wrong
     routes, K7 with the probabilities or its output left in fp32, must
     FAIL); and, at 129 bf16 tokens, the composed gradient route's
     distance from the fused plain chain (a record);
 18. the expert-guided update (learn_guidence), the main path of the
     default config (train.pre_buffer): one fp32 guided update at the
     flagship width through the kernels against the JAX golden
     (tests/data/torch_sac_guided_golden.npz) and the plain versions on
     the card; then 5 bf16 guided updates at B=256 (256 agent rows, some
     engaged, ++ 256 expert rows, 160 valid) on the default route (K4 x3,
     K2f x12, K2b x12, K3f x4, K3b x4 an update) and the trunk-gradient
     route (K4 x7, K6 x4), finite losses, the device time and host clock
     beside the plain update's;
 19. the on-device tier, a main path: (a) the batched env
     (envs/vec_kinematic.py) on the card against the port's host env (B=1,
     rrc, 25 scripted steps) and against itself on the CPU (B=16, randm32,
     200 steps, lanes resetting): flags exact, images within 1e-4; the
     replay ring on the card against the CPU's and its snapshot, bit for
     bit; (b) run_eval_vec, 32 episodes x 300 steps as lanes on rrc,
     with the flagship actor and with one that reaches goals and
     collides there, exactly one K1 launch a step, successes and
     collisions within one of the host run_eval on the same records;
     (c) train_fused at the flagship width (bf16, batch 256, 16 lanes x
     64 steps a round, a ring of 8192 on the card, randm32,
     alpha in [0.1, 2.0]) for 3 rounds of 16 updates: 3072 env steps, the
     ring's cursor, finite losses, K1 x64 a round and every update K4 x3,
     K2f x6, K2b x6, K3f x2, K3b x2; the host syncs of a round (the stats'
     one read and the updates' own; none in collection); collection's env
     steps/s alone, a round's time and updates/s, the device's busy share
     over a profiled round; K1 against its plain version on a
     collection's own frames (64 launches of 16, phase 2's check); a warm
     resume (the ring back bit for bit, the counters from the JSONL, one
     more round); a guided round on demos the port records, every update
     phase 18's launches; (d) train_vec, the same settings into the host
     replay buffer, 2 chunks of 16 updates: K1 x64 a chunk, every update
     PER_UPDATE's launches, finite losses, env steps/s;
 20. the round-5 recipes (the launcher examples/reference_scale_run.py
     of the port), a main path: (a) the device PER
     (replay/device_per.py) on the card against its CPU version on
     planted priorities (4096 slots, 3000 written, duplicates in every
     update): the state within rtol 1e-6, the last occurrence of a
     duplicate winning, the rows and weights for fixed uniform draws (a
     neighbour only at a boundary), 2^20 draws under a chi-square limit
     (the 1 - 1e-6 quantile) and never an empty slot, no host sync; a
     planted uniform sampler and a first-wins update must fail; (b) the
     flagship's recipe (the launcher's config: bf16, PER, nan_guard, SAC
     batch 32, a ring of 8192, randm32, seed 11, alpha in [0.1, 2.0])
     through train_fused cut to 2 rounds of 16 updates: K1 x64 a round,
     every update PER_UPDATE's launches, finite losses, priorities
     changed only at rows the updates drew, a warm resume (the restored
     rows at the max priority), the host syncs of a round (PER adds none
     to an update's), a PER round's and a uniform round's time, env
     steps/s and update ms at B=32; (c) the drqc recipe (rand8, lanes
     pinned, a shift of 4 on the critic only), 2 rounds: the update's
     frames shifted, the actor step's raw, exact launches; (d) a guided
     PER round on demos the port records, phase 18's launches; (e) K1 at
     the final evaluation's batch (100 lanes, two frames a block) on the
     evaluation's frames under phase 2's restated check; (f) the
     launcher's main end to end (--episodes 8 --chunk 4, then
     run_eval_vec of 100 episodes on hospital), exact launches and the
     summary;
 21. sensor faults, two main paths: (a) envs/fault_aug.perturb_obs on
     the card against the CPU on the same frames and draws, each grid
     point and all five knobs, frames and stacks, within 1e-6 with the
     same zeros; a knob at 0.0 leaves the frames; the patch's mask exact
     on draws that put its edges where fp32 and float64 part; a planted
     float64 patch and an unclipped noise must fail; (b) K1 against its
     plain version on frames of each fault family at the grid's
     strongest setting, at B = 16, 32 and 100 (phase 2's restated
     check); (c) the aug arm's recipe (the flagship's plus --aug
     patch_occlusion=0.25 --aug obs_noise=0.196 --aug-prob 0.5) through
     train_fused, 2 rounds of 16 updates: exact launches, finite losses,
     about half the stored rows perturbed; the round with aug_prob 0.0
     equal to the unaugmented round bit for bit (beside two unaugmented
     rounds); no host sync in an augmented collection, a PER round's
     syncs unchanged by the knobs; a collection step's time with and
     without; (d) the 16-point robustness sweep (tools/robustness_sweep,
     the drqc actor, 32 lanes, rrc, 250 steps a point): K1 once a step
     of every point and nothing else, the clean point equal to the run
     without the sweep and greying=0.9 to its static run, ms a point;
 22. the imitation tier, three main paths (phase_imitation, on its own
     generator): (a) a gradient pass of the BC loss in fp32 (the loss and
     every parameter gradient) through the kernels, on the launcher's 2d
     policy holding the round-3 warm start at B = 64 and 32 and on
     il_policy()'s 4-channel stacks at B = 32: K2f x3, K3f, K3b, K2b x3 a
     pass, held to the float64-sum version of the plain versions under
     phase 5's fp32 rule (EXACT_K), the plain versions with the other
     GELU form and the model with mis-scaled scores failing it, the 2d
     policy's K2f and K2b on their fp32 cluster forms; ms a BC step and
     fp32 K2f, K2b, K3f, K3b at B = 64 and 32 beside their plain versions
     and bounds, K2f and K2b beside the FMA body they replaced, K2b's
     device time split into its pass, weight products and sums; (b)
     BCTrainer.fit of the launcher's policy (batch 64) on a scripted-pilot
     corpus recorded as generalization_eval records it, 3 epochs: exact
     launches a training and a validation batch (every K2f and K2b on its
     fp32 cluster form), one host sync an epoch,
     a falling train loss, the best parameters those of the
     lowest-validation epoch bit for bit, the plain versions' fit within
     BC_PLAIN_REL; ms an epoch; (c) SACTeacher on the gw10 generalist
     (artifacts/r3/gen_fused/gw10_winner_actor.npz) with Config(): fp32,
     one K1 launch a choose_action (B=1 and batched), K1 (its fp32
     cluster form) against its plain version under phase 2's fp32 check
     and timed beside the FMA trunk_kernel, as_pilot's map; then
     tools/record_teacher_demos on rand2: one K1 a step, the reference
     layout, policy-unit actions; (d) generalization_eval.main with the
     gw10 arm's flags from the round-3 warm start on (b)'s corpus, cut to
     5 rounds of 32 updates: the warm start copied byte for byte, the fine-tune's
     actor before its first update equal to it, every guided update
     phase 18's launches and K1 once a collection and an evaluation
     step, finite losses, final_actor.npz in JAX's key set, the summary
     line's keys; then --skip-rl on a 2-epoch fit, its launches exact;
 23. the reference's own configuration and the rest of the model zoo
     (phase_zoo, its own generator), main paths: (a) the reference's
     config.yaml through load_reference_yaml (a GoT actor, a CNN critic,
     fp32, batch 32): one fp32 update through the kernels (its metrics
     and every gradient) held to the float64-sum version of the plain
     versions under phase 5's fp32 rule (EXACT_K), a tanh GELU failing
     it; 5 updates in fp32 and 5 with compute_dtype bfloat16, each
     launching K4, K2f x3, K2b x3, K3f and K3b; the CNN critic's Q with
     cuDNN's TF32 on against off; K4 in fp32 on the actor's widths at
     B=32 (its route: the fp32 cluster form), 128 and 256, the cluster
     form and the FMA body forced, each held to its plain version and
     timed beside it and the bound; K1's form for its actor at B=1 (the
     fp32 cluster); train_rl.main --reference-config on the card (every
     fp32 K4 launch the cluster form) and train() with the bf16 config
     (exact launches an env step and an update), then run_eval; (b) the SimpleViT family at its
     published widths: K8 at (32, 8, 64, 64) and (32, 8, 256, 64) against
     its plain version, fp32 and bf16, forward and backward, a mis-scaled
     version failing (in fp32 the float64-sum version passing), timed
     beside scaled_dot_product_attention (fp32 also beside its first
     design, the FMA attention_kernel); a ViT
     actor with attn_impl="pallas" (K8 x2 a forward) against the plain
     route; at 256 patches (256 x 320 frames, `auto`) 5 fp32 updates
     through K8 (x10 each) against the plain version, and 5 in bf16; (c)
     GaussianConvNet + CNN, Deterministic + CNN (4-frame stacks) and the
     deterministic GoT pair, 5 updates each, alpha 0 for the
     deterministic actors; (d) head-only fine-tuning: `trans` and
     `fc_embed` bit-equal after 5 updates, no backward kernel, the heads
     moved, and without the flags the trunks moved; (e) the flagship
     actor as a reference checkpoint through torch_io.load_actor_pth,
     acting through K1 bit-equal to the params_from_jax actor; each
     family's update and act times at B=32;
 24. the fleet tier (phase_fleet), main paths: (a) serve_fleet of the
     flagship actor (bf16 K1) over 8 and 32 robots on rrc (episodes of
     60 steps), with the default bucket ladder and pinned to bucket 1:
     each robot's commands and outcomes compared (bit for bit, or the
     first difference reported, within the heads' bf16 rounding, and two
     pinned runs equal), K1 launches the server's dispatches and nothing
     else, actions/s, Hz a robot and the mean batch; run_eval_fleet over
     8 robots; (b) run_eval(device_rollout_loop=True) of the drqc actor
     against the host run_eval over 8 episodes on rrc: successes,
     success rate and durations equal, the device loop's collisions at
     least the host's (the frozen steps), K1 once a step, one host sync
     a step, env steps/s of both;
     (c) train_fleet at the flagship width from the flagship actor (SAC
     batch 64), plain with 4 robots and guided PER with 8 (policy-unit
     demos in the expert buffer): finite logged losses, the learner's
     launches phase 6's or phase 18's counts an update, K1 the warm-up's
     and the server's dispatches, the updates the cadence rule's after
     the drain, the served copy equal to the learner's actor, every
     dispatch's float64 checksum equal to one publish's; (d) a
     GazeboRos2Env over tests/fake_ros2.py on the card with 512 x 640
     depth frames: a reset and 5 steps, the states within 1e-6 of the
     CPU chain on the same noise, the commands through K1;
 25. the recorded-data slice (phase_slice), main paths: (a) 1024 demo
     transitions at (128, 160) from numpy -> fill_buffer_from_demos ->
     train_offline at Config() (the fp32 flagship, B=32), 20 updates
     plain, PER and with augment_sigma 2, each update launching phase 6's
     counts, updates/s; the first plain update held to the same update
     through the plain versions on the card by phase 6b's rule; train_rl
     --env replay for one 16-step episode of the demos (K1 once a step);
     (b) sac.critic_latent_reuse in bf16 and fp32, plain, PER and
     guided, 5 updates each beside 5 without it: one K4 fewer an update,
     the K2 and K3 launches unchanged, and with lr_critic 0 and
     emb-dropout 0 one update held to reuse-off's by phase 6b's rule
     (in bf16 the actor's gradients within 2^-6 L, their pooled mean
     within 2^-14 L, the policy loss within 2^-9), a wrong latent failing
     it; (c)
     the flagship actor exported on the card with a symbolic batch and
     loaded: at b = 1, 3, 32 within 1e-5 of the composed plain route,
     within phase 2's fp32 rule of K1 (make_action_fn in fp32), no kernel
     launched; env units and a pinned batch; (d) AttentionVisualizer over
     GoTPolicy(capture=True) for 5 kinematic steps: rows summing to 1,
     maps within 1e-5 of the CPU's capture, actions within phase 2's fp32
     rule of K1;
 26. the data-parallel tier (phase_mesh), a main path: two ranks on the
     card over gloo (torch.multiprocessing.spawn; NCCL refuses two ranks
     on one device), and with two or more cards one rank a card over
     NCCL as well; the parent builds the kernels, the ranks load them.
     (a) each flavour (plain, PER, guided, guided PER) through
     parallel.shardmap_learn with SACAgent(grad_axis="data"), 5 updates
     in bf16 at global B=256 and in fp32 at B=32, emb-dropout 0, the same
     injected global noise, against the single-rank update on the card:
     fp32 by phase 6b's rule, every gradient within 1e-4 of its tensor's
     largest; bf16 against the float64-sum version of the single-rank
     update (MESH_BF16_*); three wrong data axes (the gradients summed,
     noise rows 0..b-1 on every rank, the guided step's merged rows as
     one contiguous slice) failing it; each rank's launches an update the
     single-rank update's (K4 3, K2f 6, K2b 6, K3f 2, K3b 2 a plain
     update; fp32 on the cluster forms); both ranks ending on one state;
     host ms an update at world 1 and 2, read only. (b) 12 fp32 updates
     on the ranks under core/elastic.run_elastic with a SimulatedFault
     after update 7, resumed from the checkpoint of update 6, bit-equal
     to the unbroken run; the last checkpoint resumed at world 1 under
     reshard_state, its next update within (a)'s fp32 rule of the ranks';

then prints one JSON line describing each kernel and, last, the device
line {"ok": true, "device": {...}}. Any failed check raises and ends the
run with a non-zero exit, before the last line. TF32 is switched off for
matmuls and cuDNN, so fp32 products of the plain version are full fp32.
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ACTOR = ROOT / "artifacts" / "r5" / "dr_randm32_s11_amin_actor.npz"
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.npz"
GOLDEN_SEED, GOLDEN_FRAMES = 2026, 16
SEED = 7
DEVICE = "cuda"
# 16: the collection batch of the fused round and train_vec (FUSED_LANES);
# in fp32 the teacher's lanes (phase 22c, TEACHER_LANES)
# 100: the lanes of the round-5 launcher's final run_eval_vec (phase 20e);
# in fp32 a batch past K1's cluster bound (90 frames on an H100), where
# the route keeps the FMA trunk_kernel
CHECK_BATCHES = {"bfloat16": (1, 3, 8, 16, 32, 64, 100, 2048),
                 "float32": (1, 8, 16, 100)}
# K1's fp32 forms, each forced at every fp32 batch of phase 2: the
# cluster form on the tensor cores (3xTF32) and the FMA trunk_kernel
K1_FP32_FORMS = ("cluster_fp32", "fma")
TIMED_BATCHES = ((1, 50), (32, 20), (64, 10), (2048, 2))   # (batch, reps)
# batches about the cluster form's boundary (k1_form_for: 90 frames on an
# H100's 132 SMs), timed in both forms
K1_CROSSOVER = (33, 66, 82, 90, 91, 94, 96, 99, 132, 264)
# the SAC slice: kernel checks, the update's main path, its golden file
TRAIN_BATCHES = {"bfloat16": (1, 32, 256), "float32": (1, 8)}
SAC_BATCH, SAC_STEPS = 256, 5
PER_UPDATE = {"K1": 0, "K4": 3, "K2f": 6, "K2b": 6, "K3f": 2, "K3b": 2,
              "K5": 0, "K6": 0, "K7": 0, "K8": 0}
# with DGVIT_TRUNK_GRAD=1: the two gradient forwards join K4, K6 is their
# backward, and the per-block kernels rest
PER_UPDATE_TRUNK = {**{k: 0 for k in PER_UPDATE}, "K4": 5, "K6": 2}
# the guided update (learn_guidence), B agent ++ B expert rows: K4 x3 (the
# TD target's two no-grad forwards and the actor step's critic trunk, on
# the merged rows); gradient-bearing trunk passes: the critic and the
# actor on the merged rows, the actor on the expert rows (BC) and on the
# agent rows (engage), each K2f x3 + K3f forward, and the backwards of the
# critic's one and the actor's three, K2b x3 + K3b each. With
# DGVIT_TRUNK_GRAD=1 those four passes go forward through K4 and back
# through K6.
PER_GUIDED = {**{k: 0 for k in PER_UPDATE}, "K4": 3, "K2f": 12, "K2b": 12,
              "K3f": 4, "K3b": 4}
PER_GUIDED_TRUNK = {**{k: 0 for k in PER_UPDATE}, "K4": 7, "K6": 4}
GUIDED_EXPERT = 160     # valid expert rows of the bf16 guided update
GOLDEN_SAC = ROOT / "tests" / "data" / "torch_sac_golden.npz"
GOLDEN_SAC_SEED, GOLDEN_SAC_BATCH, CRITIC_SEED = 11, 8, 5

# the ingest slice: K5's checks, the camera-to-action path, the trainer
K5_BATCHES, K5_SIGMAS = (1, 3, 32, 256), (0.0, 50.0)
K5_TIMED = ((1, 20), (32, 10), (256, 3))                   # (batch, reps)
K5_PROFILED = 20           # calls in the window that names K5's CUDA kernels
CAMERA_FRAMES, CAMERA_SEED = 32, 2024
TRAIN_EPISODES, TRAIN_MAX_STEPS, TRAIN_BUFFER = 11, 52, 4096
# the episodes of demos the guided trainer run records for its expert
# buffer; the human-intervention run's episodes (the teleop's command
# ends episodes sooner than the policy's) and its least updates
DEMO_EPISODES, INTERVENTION_EPISODES, INTERVENTION_UPDATES = 3, 20, 20
EVAL_EPISODES, EVAL_MAX_STEPS = 3, 100
# K5 against its plain version. Both take every product and sum in fp32,
# each rounded on its own and in the same order (the kernel through
# __fmul_rn / __fadd_rn, the plain chain one PyTorch operation at a time),
# and draw the same noise bits, so an H100 read max |err| = 0 on states in
# [0, 1] at sigma 0 and 50 alike. The limit leaves a few fp32 roundings
# (2^-20, about 8 ulps at 0.5); one u8 step of one input pixel moves a
# state by up to 3.8e-4 and the wrong chains by more, so both fail it.
K5_MAX = 2.0 ** -20
K5_NOISE_STATS = 0.01      # mean and std of the states, as the JAX test

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32
# outside them, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Tolerances of the kernel against its plain version on the same card.
# fp32: both accumulate in fp32 in another order; 1e-4 abs + rel.
# bf16: both round to bf16 at the same points, so most latents agree bit
# for bit, but another summation order can flip one bf16 rounding and the
# flip propagates. Errors are taken relative to the largest |latent| L
# (~0.37-0.47). Each batch: max <= 2^-7 L (one bf16 ulp at the top of the
# range; an H100 read 1.95e-3 = 2^-9 at B=2048). All bf16 batches pooled
# (139k latents, most from B=2048): mean <= 2^-17 L (an H100 read
# 1.3e-6 at B=2048). The mean is pooled because a single flip in a batch
# of one moves that batch's mean by ~3e-5. With the trained weights an
# erf GELU changes few bf16 roundings (mean ~7e-6 on the CPU at B=64-256,
# nothing at B=1), so the pooled mean is what separates it; phase 2 shows
# that both wrong trunks fail these limits.
# Phase 2 holds K1's bf16 latent to the float64-sum version of the plain
# version, these limits restated (see EXACT_K).
F32_TOL = 1e-4
BF16_MAX, BF16_MEAN = 2.0 ** -7, 2.0 ** -17
# Actions (|a| < 1, bf16 ulp 2^-8 on [0.5, 1)): the bf16 kernel path
# against the bf16 plain path on the card within two ulps of the action
# (the trunk's rare flips pass through the bf16 heads; an H100 read
# 2^-8); the bf16 policy against the JAX fp32 golden actions differs by
# the bf16 model error itself (1.1e-2 on an H100, 1.4e-2 on the CPU for
# these frames).
ACTION_BF16 = 2.0 ** -7
ACTION_BF16_VS_FP32 = 2.0 ** -5
ACTION_FP32 = 1e-4


# The rule a check of a kernel against its plain version must meet. A
# kernel differs from its plain version by the order of its sums, and a
# check must tell that apart from a wrong rounding point or form. So on
# seeds 7 to 11, in both orders of chip_draws.py's draws ("shared",
# "fresh") and in this script's own order:
#   (a) the plain version with every matrix product summed in float64
#       (`exact_sums`, "the float64-sum version") passes the check;
#   (b) every wrong version the check has fails it;
#   (c) the kernel passes it.
# A check that fails (a) has a limit below the spread of exact arithmetic
# and is restated in one of two forms: the kernel held to the float64-sum
# version in place of the plain version, the statistic s under max(old
# limit, k x s(plain version, float64-sum version)) on the same draw, k <=
# 2 (EXACT_K); or phase 13's per-frame share rule against the float64-sum
# version. A kernel that fails (c) where (a) holds is at fault and is
# repaired; a check that meets (a) keeps its limit. Four checks failed
# (a) on an H100 80GB HBM3 at 700 W and were restated first, four more
# after them (faults 3f-3i of ROADMAP.md), two more since (gaps q and r),
# and two checks that no wrong version failed were restated (gaps s, t);
# the readings below are chip_draws.py's on seeds 7-11 in both orders and
# this script's own:
#   * fp32 K3f and K3b (phase 5, gap t): K3b was held by the largest
#     max|err|/L over the tensors against float64 sums (old limit
#     TRAIN_F32_MAX, k = 2), K3f by max|err|/L against the plain version
#     under TRAIN_F32_MAX, both with no wrong version. Now K2b's rule
#     (`f32_rule`, F32_SPECS): the mean|err|/L pooled over the outputs (K3b:
#     dx and the 11 gradients) and the phase's two fp32 batches against
#     the plain version evaluated in float64 throughout (K3b's recomputing
#     its CLS row), under max(F32_POOLED, k x the plain version's), which
#     the kernel (the fp32 cluster form), the FMA body (forced, K3b on the
#     FMA K3f's records), the plain and the float64-sum versions must pass
#     and a tanh GELU and scores scaled 1 / dim_head fail. On seeds 7-11 in
#     both orders (H100 80GB HBM3, 700 W): K3f's correct versions read at
#     most 0.095 of the limit (the kernel 0.064), the tanh GELU at least
#     10.36 x, the mis-scaled block 5602 x; K3b's at most 0.037 (the kernel
#     0.030), the tanh GELU at least 5.70 x, the mis-scaled block 2380 x.
#   * K1's fp32 latent (phase 2, gap s): held by F32_TOL alone, which the
#     tanh GELU passes. Now also the same pooled statistic over phase 2's
#     fp32 batches against K1's float64-sum version (F32_SPECS["K1"]), the
#     tanh GELU and the mis-scaled trunk failing: on seeds 7-11 K1's route
#     read at most 0.284 of the limit, its cluster form forced at every
#     batch (B=100 past its bound too) 0.842, the FMA kernel 0.160; the
#     tanh GELU at least 2.06 x, the mis-scaled trunk 2623 x. K1 keeps its
#     sums (cl32::Fast).
#   * fp32 K2b (phase 5, gap r): s = the largest max|err|/L over the
#     tensors was decided by ill-conditioned frames (LN1's bias gradient,
#     sums whose terms cancel), where correct fp32 evaluations spread 12x
#     about the exact answer and the float64-sum version is no exact
#     answer itself. Now s = the mean|err|/L pooled over dx, the 11
#     gradients and the phase's two fp32 batches (each tensor over its own
#     largest |value|), against the plain version evaluated in float64
#     throughout (`float64_eval`), under max(F32_POOLED = 2^-22, k x the
#     plain version's), k = 2 (`f32_rule`). The kernel (the fp32 cluster
#     form), the FMA body, the plain and the float64-sum versions must
#     pass, a tanh GELU and scores scaled 1 / dim_head fail: on seeds 7-11
#     in both orders the correct versions read at most 0.646 of the limit
#     (the kernel; the FMA body 0.618, the float64-sum version 0.344), the
#     tanh GELU at least 4.49 x, the mis-scaled block 1825 x. Per batch
#     (B=1 alone) the mis-scaled block read as little as 3.97e-7 on a
#     frame whose first block attends one-hot, and the correct versions
#     up to 7.0e-7 at B=8: no per-batch limit separated them.
#   * fp32 K4 (phase 5): the same pooled statistic over its latent and its
#     two batches, against its float64-sum version, under the same limit,
#     and each batch's max|err|/L under max(TRAIN_F32_MAX, k x the plain
#     version's) as before. Since its fp32 cluster form it has the two
#     wrong versions of K2b (`F32_TRUNK_WRONGS`). On seeds 7-11 the
#     kernel read at most 0.327 of the pooled limit (the FMA body 0.272,
#     the plain version 0.334) and 0.432 of the max limit; the tanh GELU
#     at least 1.99 x the pooled limit (0.53-0.91 of the max limit: only
#     the pooled mean sees it), the mis-scaled trunk 1460 x. Summed as
#     K1's cluster form sums (3xTF32 accumulated on the tensor cores,
#     which round toward zero) the kernel read 1.6e-7 to 4.4e-7 there,
#     past the tanh GELU on one draw and past TRAIN_F32_MAX on another:
#     K4 sums as K2f (cl32::Exact).
#   * bf16 K2b (phase 5, gap q): each tensor's max within 2^-6 L of the
#     plain version and the pooled mean|err|/L within TRAIN_BF16_MEAN
#     failed two draws on which the plain version itself flipped bf16
#     roundings (seed 8 shared: the plain version read 1.86e-5 pooled from
#     float64 sums, the kernel 1.68e-6). Now phase 13's rule against the
#     float64-sum version (`k2b_bf16_rule`): at least CHAIN_WITHIN of the
#     dx frames within 2^-18 on their own scale, and the mean|err|/L
#     pooled over dx, the 11 gradients and the bf16 batches under
#     max(2^-18, k x the plain version's), k = 2 (EXACT_K["K2b"]). The
#     kernel held 0.9862-0.9965 of its 289 frames and read at most 0.641
#     of the pooled limit, the plain version 0.9792-0.9931 and 0.500,
#     autograd of the plain forward 0.0035-0.0242 and at least 1.153 x.
#   * K4's pooled bf16 latent (phase 5): s = the pooled mean|err|/L, old
#     limit TRAIN_BF16_MEAN; the plain version read 3.9e-6 to 8.9e-6. k =
#     1.65: K4 read at most 0.91 of its limit, the erf GELU at least 1.09
#     x its limit, the fp32 residual 24 x. The per-tensor max (2^-6 L)
#     meets (a) and keeps its limit.
#   * K1's bf16 latent (phase 2): s = the pooled mean|err|/L (old limit
#     BF16_MEAN; the plain version read 5.6e-6 to 7.3e-6) and the
#     launches' largest max|err| over each launch's own largest |latent|
#     (old limit BF16_MAX; at B=2048 the plain version read two ulps,
#     8.2e-3, and 1.0e-2 on 32-frame cuts of that batch); held for the
#     route over its batches, and for each form by itself on 65 launches
#     of 32 frames (K1_SAMPLE) and on one of 2048. k = 2: the forms read
#     at most 0.61 of the mean's limit; the max reached 1.00 of its limit
#     once (seed 8: one frame of B=1 two ulps off in both tensor-core
#     forms, where the plain version's worst was one ulp of an equal L;
#     the FMA kernel 0.50); the erf GELU at least 1.08 x the mean's limit,
#     the fp32 residual 21 x and the fp32 embedding 9.7 x.
#   * the K3b + K2b chain against the whole-trunk backward, bf16 (phase
#     13): its per-tensor max (2^-6 L) became the per-frame share rule
#     against the float64-sum version's dx. No per-tensor form holds: on
#     seeds 7-11 the chain's worst weight gradient read up to 7.6 x
#     max(2^-6, 2 x the plain version's) (0.119 L on block 1 wqkv, where
#     the plain version read under 7.8e-3), and K6's own up to 4.6 x;
#     each weight gradient's mean pooled over the cases read up to 1.55 x
#     max(2^-13, 2 x plain's) for the chain and 1.29 x for K6, while the
#     wrong backwards read from 0.99 x: a flip of the recomputed bf16
#     stream, which the gradients amplify, not a wrong rounding point.
#     Both are printed. By frame, over K6_BATCHES' cases and CHAIN_EXTRA
#     more draws (4123 frames, standard error 0.0078 at the line), at
#     least CHAIN_WITHIN of the frames within 2^-18. Until K6 read K4's
#     streams, the frame's mean |err| was taken over the batch's largest
#     |dx| and the line was 0.52 (the chain 0.5440 to 0.5574, K6 0.5833 to
#     0.6017, the wrong backwards 0.4812 to 0.4948). Since every version
#     but the chain and autograd of the plain forward differentiates the
#     same streams, the float64-sum version's on those streams: on the
#     batch's scale an H100 80GB HBM3 at 700 W read the chain 0.732 to
#     0.756, K6 0.947 to 0.963, the plain version 0.960 to 0.974 and the
#     wrong backwards 0.482 to 0.495 (chip_draws.py, seeds 7-11, both
#     orders), the wrong ones within 5 standard errors of 0.52; on each
#     frame's own scale (phase 5b's) the chain 0.612 to 0.630, K6 0.881
#     to 0.893, the plain version 0.912 to 0.924 and the wrong backwards
#     0.002 to 0.028. So phase 13 took each frame's own scale and phase
#     5b's line, 0.5: 14 standard errors under the chain's lowest, 61
#     over the wrong backwards' highest. The pooled mean (2^-13) meets (a)
#     and keeps its limit, against the float64-sum version.
#   * fp32 K6 against its plain version and the chain (phase 13, fault
#     3f): s = the largest max|err|/L over the tensors, old limit
#     K6_F32_MAX; on the trained actor at B=256 the plain version read up
#     to 4.5e-3 from float64 sums and K6 up to 3.0e-3 from the plain
#     version. k = 2 (EXACT_K["fp32"]): K6 and the chain read at most 0.43
#     of their limit. fp32 has no rounding point to move, so no wrong
#     rounding point exists (fp32 K2b's, K3f's, K3b's and K4's wrong
#     versions are a wrong GELU form and a wrong scale, above). The chain
#     differentiates the
#     forward of the per-block kernels; while K2f's fp32 form was the FMA
#     body, those streams were K4's bit for bit. Since its cluster form
#     (3xTF32 and the exact TF32 split) they are not, and a frame of the
#     trained actor whose backward magnifies its input reads the chain up
#     to 5.3e-3 from the float64-sum version on K4's streams (H100 80GB
#     HBM3, 700 W; chip_draws.py seeds 7-11): the chain is held to the
#     float64-sum version on its own streams (`chain_streams`), under
#     max(K6_F32_MAX, k x the plain version's reading there).
#   * bf16 K6 against its plain version per tensor (phase 13, fault 3g:
#     each tensor's max within 2^-6 L, which K6 failed on some draws, a
#     flip of its own forward chain amplified by the backward as in the
#     chain's case): held by the chain's per-frame rule against the
#     float64-sum version's dx instead (above); the pooled mean against
#     the plain version (2^-13) is kept.
#   * bf16 K6 on the FMA bodies (phase 5b, fault 3h: each max within 2^-6
#     L): the per-frame rule on each frame's own scale (K6_WIDTHS_WITHIN,
#     whose note says why the batch's scale cannot), both wrong backwards
#     run at these widths: K6 0.8278 to 0.8478, the plain version 0.8337
#     to 0.8559, the wrong backwards 0.0091 to 0.0513 (3200 frames).
#   * the routes of long frames in bf16 (phase 17b, fault 3i: each call's
#     latent and gradients within 2^-6 L per tensor, and each route's
#     pooled means within 2^-18 (latent) and 2^-13 (gradients) of the plain
#     route): the plain route read 7.2e-6 to 3.0e-5 (latent) and up to
#     4.4e-4 (gradients) from float64 sums, the composed blocks' products
#     summed in float64 too (`exact_sums`). k = 2 (EXACT_K["long"]) on each
#     route's pooled means and on each call's largest max|err|/L over the
#     latent and the gradients: the kernels' route read at most 0.70 and
#     0.76 of those limits; the wrong routes (K7 with fp32 probabilities,
#     K7 with o unrounded, on every composed call) at least 1.68 and 2.96
#     x a route's limits.
#   * the composed routes in bf16 (phase 16, lead l: the K7 route's
#     GoT(dropout=0.1) means and the K8 route's attn_impl="pallas" actions
#     within 2^-4 of the PyTorch composition, which rounds every operation
#     to bf16 where the kernels keep fp32; the two functions' float64-sum
#     versions lie up to 0.149 L and 7.8e-2 apart): each route held to
#     the float64-sum version of its plain route, as phase 17b holds its
#     routes. k = 2 (EXACT_K["composed"]) on the pooled mean|err|/L over
#     the route's output and its four blocks' outputs, under max(2^-18,
#     k x plain's): the plain routes read 1.0e-6 to 2.9e-6 (K7) and
#     9.3e-7 to 2.8e-6 (K8), the kernels' routes at most 0.59 and 0.51 of
#     the limit, the wrong routes at least 2.98 x (K7 with fp32
#     probabilities; o unrounded 3.29 x) and 2.99 x (K8 with bf16
#     probabilities; bf16 scores 13.7 x), on seeds 7-11 in both orders
#     and on the draws where the old check failed (chip_draws.py on an
#     H100 80GB HBM3 at 700 W). The max|err| is held too, under max(2^-4,
#     k x plain's) (the kernels read 1.1e-3 to 1.5e-2): a bound on the
#     worst frame, which a wrong rounding point does not reach.
# Two checks meet (a) as they stand and keep their limits, their wrong
# versions added (phase 5's K3f, phase 15's K7: the pooled 2^-18 over the
# bf16 cases, each max 2^-6 L): the float64-sum version read at most 0.13
# (K3f) and 0.08 (K7) of the pooled limit, the kernels 0.36 and 0.10, the
# wrong versions at least 3.77 x (K3f's erf GELU; fp32 probabilities 21 x,
# k and v in fp32 22 x) and 1.80 x (K7's fp32 probabilities; o unrounded
# 2.2 x).
# Each prints its old reading (kernel against plain, old limit) beside the
# new one; READINGS keeps every restated reading of a run for
# chip_draws.py.
EXACT_K = {"fp32": 2.0, "K4": 1.65, "K1": 2.0, "long": 2.0,
           "composed": 2.0, "K2b": 2.0}
CHAIN_WITHIN = 0.5
READINGS: list = []


def check(ok, what: str) -> None:
    """A failed check ends the run (explicit, so `python -O` keeps it)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


@contextlib.contextmanager
def exact_sums():
    """The plain versions with every matrix product summed in float64 and
    rounded once to the dtype the product had, their rounding points where
    they are: it swaps `fused_transformer._prod`, the one product of `_mm`
    and `_tmm`, so it reaches every product of blocks_forward_plain,
    got_forward_plain, block_bwd_plain, cls_bwd_plain, cls_fwd_plain,
    attention_section_plain and trunk_bwd_plain; `layers._prod`, every
    product of the composed blocks and of `Linear` (and, under autograd,
    their backward products); and the two products of each of
    `ops.attention`'s plain attentions (`attention_xla`, the composed
    route's, and `attention_plain`, K8's plain version)."""
    import torch

    from dgvit_tpu_torch.models import layers
    from dgvit_tpu_torch.ops import attention as att
    from dgvit_tpu_torch.ops import fused_transformer as ft

    f64 = lambda a, b, dt: (a.double() @ b.double()).to(dt)

    def xla(q, k, v, scale):
        dots = f64(q, k.transpose(-1, -2), q.dtype) * scale
        return f64(torch.softmax(dots, dim=-1), v, q.dtype)

    def plain(q, k, v, scale):
        dots = f64(q, k.transpose(-1, -2), torch.float32) * scale
        e = torch.exp(dots - dots.amax(dim=-1, keepdim=True))
        return f64(e / e.sum(dim=-1, keepdim=True), v, torch.float32).to(
            q.dtype)

    kept = ft._prod, layers._prod, att.attention_xla, att.attention_plain
    ft._prod = lambda a, b: f64(a, b, torch.float32)
    layers._prod = lambda a, b: f64(a, b, a.dtype)
    att.attention_xla, att.attention_plain = xla, plain
    try:
        yield
    finally:
        (ft._prod, layers._prod, att.attention_xla,
         att.attention_plain) = kept


def exact(fn, *args):
    """fn(*args) under `exact_sums`."""
    with exact_sums():
        return fn(*args)


def float64_eval(fn, x, dy, w, heads, dim_head):
    """fn, a plain version of fused_transformer or cls_block (a backward
    fn(x, dy, w, heads, dim_head), or with dy None a forward fn(x, w,
    heads, dim_head)), evaluated in float64 throughout: its inputs in
    float64 and `_f32`, the cast each of its steps takes, casting to
    float64 in both modules, so every product, every sum and every
    elementwise step (the LayerNorms, the softmax and its backward, the
    GELU's erf polynomial) is float64 (chip_k2b_stages.py). Returns fn's
    outputs in float64."""
    import torch

    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft

    kept = ft._f32
    ft._f32 = cb._f32 = lambda t: t.to(torch.float64)
    try:
        ins = (x.double(),) + (() if dy is None else (dy.double(),))
        return fn(*ins, [t.double() for t in w], heads, dim_head)
    finally:
        ft._f32 = cb._f32 = kept


def rel_max(outs, refs):
    """The largest max|out - ref| / L over the tensors, L = max |ref|."""
    return max((o.float() - r.float()).abs().max().item()
               / max(r.float().abs().max().item(), 1e-30)
               for o, r in zip(outs, refs))


def pooled_mean(outs, refs):
    """mean |out - ref| over every value of the tensors, over L = the
    largest |ref| of all (phase 2's pooled statistic)."""
    err = sum((o.float() - r.float()).abs().sum().item()
              for o, r in zip(outs, refs))
    count = sum(o.numel() for o in outs)
    return err / count / max(max(r.float().abs().max().item()
                                 for r in refs), 1e-30)


def pooled_rel(outs, refs):
    """mean |out - ref| / L over every value of the tensors, L the largest
    |ref| of each tensor (phase 5's pooled statistic, TrainErrors)."""
    e = TrainErrors()
    e.add(zip(outs, refs))
    return e.mean


def f32_ratio(out, ref):
    """The largest |out - ref| / (F32_TOL (1 + |ref|)) over the values: the
    fp32 check of K1 (phases 2 and 22c) passes at 1 and below."""
    o, r = out.float(), ref.float()
    return ((o - r).abs() / (F32_TOL * (1 + r.abs()))).max().item()


def restated(stat, old, k, outs, plains, exacts):
    """A check restated against float64 sums: (ok, stat(outs, exacts),
    limit) with limit = max(old, k stat(plains, exacts)), the plain
    version's own distance on the same draw (see EXACT_K)."""
    got = stat(outs, exacts)
    limit = max(old, k * stat(plains, exacts))
    return got <= limit, got, limit


def record(check_name, **reading):
    """Keep one restated reading of this run (chip_draws.py prints and
    saves them)."""
    READINGS.append({"check": check_name, **reading})


def golden_inputs(seed=GOLDEN_SEED, frames=GOLDEN_FRAMES):
    """Depth frames in [0, 1] and polar goals, as tests/test_torch_policy.py
    draws them for the golden file."""
    import numpy as np

    rng = np.random.default_rng(seed)
    obs = rng.uniform(0, 1, (frames, 128, 160)).astype(np.float32)
    goal = np.stack([rng.uniform(0, 1, frames), rng.uniform(-1, 1, frames)],
                    axis=1).astype(np.float32)
    return obs, goal


def k1_work(cfg, batch: int, dtype: str):
    """FLOPs and bytes K1 needs for `batch` frames: 65 tokens (no padded
    rows), k/v for every row and q/attention/MLP for the CLS row in the
    last block; every input read once, the output written once."""
    m = cfg.model
    ph, pw = m.patch_size
    n_patch = (m.image_size[0] // ph) * (m.image_size[1] // pw)
    n, pd, d = n_patch + 1, ph * pw, m.latent_size
    inner, mlp, depth = m.head * m.dim_head, m.mlp_dim, m.block
    full = (2 * n * d * 3 * inner + 4 * m.head * n * n * m.dim_head
            + 2 * n * inner * d + 4 * n * d * mlp)
    cls = (2 * n * d * 2 * inner + 2 * d * inner + 4 * m.head * n * m.dim_head
           + 2 * inner * d + 4 * d * mlp)
    flops = batch * (2 * n_patch * pd * d + (depth - 1) * full + cls)
    esize = 2 if dtype == "bfloat16" else 4
    weights = (pd * d + d + n * d
               + depth * (3 * inner * d + inner * d + mlp * d * 2 + mlp + 6 * d))
    bytes_ = (batch * (n_patch * pd + 2 * d) + weights) * esize + 2 * d * 4
    return flops, bytes_


def bound_ms(flops, bytes_, dtype):
    """The least time of the work on an H100: the larger of its operations
    over the peak rate of their type and its bytes over the HBM rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], bytes_ / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, runs: int = 7) -> float:
    """Median over `runs` of the mean time of `reps` back-to-back calls,
    from CUDA events, after a warm-up call. Weights stay in L2 between
    calls, as they do in a serving loop."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_kernels_ms(fn, calls: int = 50, tries: int = 3):
    """The device time of one call of `fn` by CUDA kernel name ({name: ms
    a call}, from torch.profiler over `calls` calls after a warm-up). A
    window in which the profiler recorded nothing is taken again with four
    times the calls; after `tries` empty windows it raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by = {e.key: e.device_time_total / calls / 1e3
              for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.device_time_total > 0}
        if by:
            return by
        calls *= 4
    raise RuntimeError(f"torch.profiler recorded no device time in {tries} "
                       "windows")


def device_ms(fn, calls: int = 50, tries: int = 3):
    """The device time of one call of `fn`, its CUDA kernels summed
    (device_kernels_ms). Beside cuda_ms for the small kernels, whose
    back-to-back calls can wait on the host."""
    return sum(device_kernels_ms(fn, calls, tries).values())


def trunk_inputs(policy, batch, rng):
    """got_forward_fused's arguments for `batch` seeded frames, as GoT
    hands them to the trunk."""
    import torch

    dev = torch.device(DEVICE)
    img = torch.from_numpy(rng.uniform(0, 1, (batch, 128, 160))
                           .astype("float32")).to(dev)
    goal = torch.from_numpy(rng.uniform(-1, 1, (batch, 2))
                            .astype("float32")).to(dev)
    with torch.no_grad():
        return policy.trans.trunk_args(img, policy.fc_embed(goal))


@contextlib.contextmanager
def erf_gelu():
    """The plain versions with an erf GELU where the TPU kernel uses the
    tanh form (a wrong bf16 rounding point's worth of difference)."""
    import torch

    from dgvit_tpu_torch.ops import fused_transformer as ft

    tanh_gelu = ft._gelu32
    ft._gelu32 = lambda x, cdt: 0.5 * x * (1.0 + torch.erf(
        x * ft._INV_SQRT2))
    try:
        yield
    finally:
        ft._gelu32 = tanh_gelu


def trunk_erf_gelu(*args):
    """A wrong bf16 trunk: the plain version with an erf GELU where the
    TPU kernel uses the tanh form."""
    from dgvit_tpu_torch.ops.got_megakernel import got_forward_plain

    with erf_gelu():
        return got_forward_plain(*args)


def k4_erf_gelu(*args):
    """A wrong bf16 K4: its plain version with an erf GELU."""
    from dgvit_tpu_torch.ops.got_megakernel import blocks_forward_plain

    with erf_gelu():
        return blocks_forward_plain(*args)


def k4_f32_residual(x, blocks, fn, heads, dim_head, final_norm):
    """A wrong bf16 K4: its plain version with the residual stream kept in
    fp32 across blocks (no rounding after each block)."""
    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops import got_megakernel as gm
    from dgvit_tpu_torch.ops.cls_block import cls_block_plain

    x32 = x.float()
    for w in blocks[:-1]:
        x32 = ft.block_plain(x32, w, heads=heads, dim_head=dim_head,
                             cdt=x.dtype)
    cls = cls_block_plain(x32, blocks[-1], heads=heads, dim_head=dim_head,
                          cdt=x.dtype)
    return gm._final_norm32(cls, *fn, final_norm).to(x.dtype)


@contextlib.contextmanager
def swapped(module, name, fn):
    """module.name replaced by fn inside the block (a wrong version's
    rounding point or form)."""
    kept = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, kept)


def attention_rounded(p_dtype, o_dtype):
    """`fused_transformer._attention` with its probabilities rounded to
    p_dtype and each head's output to o_dtype instead of the compute dtype
    (fp32 for either: a wrong version's rounding point)."""
    import torch

    from dgvit_tpu_torch.ops import fused_transformer as ft

    def attend(q, k, v, heads, dim_head, cdt):
        b, nq, _ = q.shape
        n = k.shape[1]
        split = lambda t, r: t.reshape(b, r, heads, dim_head).transpose(1, 2)
        s = ft._mm(split(q, nq), ft._f32(split(k, n)).transpose(-1, -2))
        s = s * dim_head ** -0.5
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = (e / e.sum(dim=-1, keepdim=True)).to(p_dtype)
        o = ft._mm(p, split(v, n)).to(o_dtype)
        return o.transpose(1, 2).reshape(b, nq, heads * dim_head)
    return attend


def k2f_f32_probs(x, w, heads, dim_head):
    """A wrong bf16 K2f: its plain version with the attention
    probabilities left in fp32 before P.V (the TPU kernel rounds them to
    the compute dtype)."""
    import torch

    from dgvit_tpu_torch.ops import fused_transformer as ft

    with swapped(ft, "_attention", attention_rounded(torch.float32,
                                                     x.dtype)):
        return ft.block_fwd_plain(x, w, heads, dim_head)


def k3f_erf_gelu(x, w, heads, dim_head):
    """A wrong bf16 K3f: its plain version with an erf GELU."""
    from dgvit_tpu_torch.ops import cls_block as cb

    with erf_gelu():
        return cb.cls_fwd_plain(x, w, heads, dim_head)


def k3f_f32_probs(x, w, heads, dim_head):
    """A wrong bf16 K3f: its plain version with the CLS row's attention
    probabilities left in fp32 before P.V."""
    import torch

    from dgvit_tpu_torch.ops import cls_block as cb

    with swapped(cb, "_attention", attention_rounded(torch.float32,
                                                     x.dtype)):
        return cb.cls_fwd_plain(x, w, heads, dim_head)


def k3f_f32_kv(x, w, heads, dim_head):
    """A wrong bf16 K3f: its plain version with k and v of every row left
    in fp32 (the outputs of the tensor-core body's projection)."""
    from dgvit_tpu_torch.ops import cls_block as cb

    with swapped(cb, "_kv_rows", lambda h1, wkv, cdt: cb._mm(h1, wkv)):
        return cb.cls_fwd_plain(x, w, heads, dim_head)


def k7_unrounded(what):
    """A wrong bf16 K7: its plain version with the probabilities ("p") or
    each head's output ("o") left in fp32 (the TPU kernel rounds both to
    the compute dtype)."""
    import torch

    from dgvit_tpu_torch.ops import fused_block as fb

    def section(x, wqkv, wout, bout, heads, dim_head):
        dts = {"p": (torch.float32, x.dtype), "o": (x.dtype, torch.float32)}
        with swapped(fb, "_attention", attention_rounded(*dts[what])):
            return fb.attention_section_plain(x, wqkv, wout, bout, heads,
                                              dim_head)
    return section


def k3b_f32_kv(x, dy, w, heads, dim_head, saved=None):
    """A wrong bf16 K3b: its plain version with the recomputed k and v of
    every row left in fp32 (the TPU kernel rounds them to the compute
    dtype: the outputs of the tensor-core body's projection), and the
    CLS row recomputed from them (`saved` is not read)."""
    from dgvit_tpu_torch.ops import cls_block as cb

    with swapped(cb, "_kv_rows", lambda h1, wkv, cdt: cb._mm(h1, wkv)):
        return cb.cls_bwd_plain(x, dy, w, heads, dim_head)


def trunk_f32_residual(patches, goal, pe, pos, blocks, fn, heads, dim_head,
                       n_valid, final_norm):
    """A wrong bf16 trunk: the plain version with the residual stream kept
    in fp32 across blocks (no rounding after each block)."""
    import torch

    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops import got_megakernel as gm
    from dgvit_tpu_torch.ops.cls_block import cls_block_plain

    cdt = patches.dtype
    emb = (ft._mm(patches, pe[0]) + pe[1].float()).to(cdt)
    x = torch.cat([goal[:, None, :], emb], dim=1)
    x32 = (x.float() + pos.float()[None]).to(cdt).float()
    for w in blocks[:-1]:
        x32 = ft.block_plain(x32, w, heads=heads, dim_head=dim_head, cdt=cdt)
    cls = cls_block_plain(x32, blocks[-1], heads=heads, dim_head=dim_head,
                          cdt=cdt)
    return gm._final_norm32(cls, *fn, final_norm).to(cdt)


def trunk_f32_emb(patches, goal, pe, pos, blocks, fn, heads, dim_head,
                  n_valid, final_norm):
    """A wrong bf16 trunk: the plain version with the patch embedding left
    in fp32 before the positional add (the TPU kernel rounds it to the
    compute dtype first: the embedding prologue's rounding point)."""
    import torch

    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops import got_megakernel as gm

    cdt = patches.dtype
    emb = ft._mm(patches, pe[0]) + pe[1].float()
    x = torch.cat([goal[:, None, :].float(), emb], dim=1)
    x = (x + pos.float()[None]).to(cdt)
    return gm.blocks_forward_plain(x, blocks, fn, heads, dim_head,
                                   final_norm)


@contextlib.contextmanager
def mis_scaled_scores():
    """The plain versions with every block's scores scaled by 1 / dim_head
    where the model asks 1 / sqrt(dim_head) (phase 23b's wrong K8, in the
    blocks)."""
    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft

    attend = ft._attention

    def mis_scaled(q, k, v, heads, dim_head, cdt):
        return attend(q * dim_head ** -0.5, k, v, heads, dim_head, cdt)
    with swapped(ft, "_attention", mis_scaled), \
            swapped(cb, "_attention", mis_scaled):
        yield


def trunk_mis_scaled(*args):
    """A wrong fp32 trunk: K1's plain version with mis-scaled scores."""
    from dgvit_tpu_torch.ops.got_megakernel import got_forward_plain

    with mis_scaled_scores():
        return got_forward_plain(*args)


def trunk_tanh_gelu(*args):
    """A wrong fp32 trunk: K1's plain version with the tanh GELU where the
    TPU kernel takes the erf form."""
    from dgvit_tpu_torch.ops.got_megakernel import got_forward_plain

    with other_gelu():
        return got_forward_plain(*args)


def k4_mis_scaled(*args):
    """A wrong fp32 K4: its plain version with mis-scaled scores (K1's
    wrong trunk, from the blocks on)."""
    from dgvit_tpu_torch.ops.got_megakernel import blocks_forward_plain

    with mis_scaled_scores():
        return blocks_forward_plain(*args)


def k4_tanh_gelu(*args):
    """A wrong fp32 K4: its plain version with the tanh GELU where the TPU
    kernel takes the erf form."""
    from dgvit_tpu_torch.ops.got_megakernel import blocks_forward_plain

    with other_gelu():
        return blocks_forward_plain(*args)


def block_mis_scaled_bwd(x, dy, w, heads, dim_head):
    """A wrong fp32 K2b: the plain backward of the block whose scores are
    scaled by 1 / dim_head where the model asks 1 / sqrt(dim_head) (phase
    2's mis-scaled trunk, in one block): block_bwd_plain at wqkv with its
    q columns scaled by dim_head^-1/2, their gradient scaled back."""
    from dgvit_tpu_torch.ops import fused_transformer as ft

    inner, s = heads * dim_head, dim_head ** -0.5
    wq = w[2].clone()
    wq[:, :inner] *= s
    dx, grads = ft.block_bwd_plain(x, dy, [*w[:2], wq, *w[3:]], heads,
                                   dim_head)
    grads = list(grads)
    grads[2] = grads[2].clone()
    grads[2][:, :inner] *= s
    return dx, tuple(grads)


def block_tanh_gelu_bwd(x, dy, w, heads, dim_head):
    """A wrong fp32 K2b: its plain version with the tanh GELU where the
    TPU kernel takes the erf form."""
    from dgvit_tpu_torch.ops import fused_transformer as ft

    with other_gelu():
        return ft.block_bwd_plain(x, dy, w, heads, dim_head)


def q_scaled(w, heads, dim_head):
    """The block's weights with wqkv's q columns scaled by dim_head^-1/2:
    the block whose scores are scaled by 1 / dim_head where the model asks
    1 / sqrt(dim_head)."""
    inner = heads * dim_head
    wq = w[2].clone()
    wq[:, :inner] *= dim_head ** -0.5
    return [*w[:2], wq, *w[3:]]


def cls_mis_scaled_fwd(x, w, heads, dim_head):
    """A wrong fp32 K3f: its plain version with the scores scaled 1 /
    dim_head."""
    from dgvit_tpu_torch.ops import cls_block as cb

    return cb.cls_fwd_plain(x, q_scaled(w, heads, dim_head), heads,
                            dim_head)


def cls_tanh_gelu_fwd(x, w, heads, dim_head):
    """A wrong fp32 K3f: its plain version with the tanh GELU where the
    TPU kernel takes the erf form."""
    from dgvit_tpu_torch.ops import cls_block as cb

    with other_gelu():
        return cb.cls_fwd_plain(x, w, heads, dim_head)


def cls_mis_scaled_bwd(x, dy, w, heads, dim_head):
    """A wrong fp32 K3b: the plain backward (recomputing its CLS row) of
    the block whose scores are scaled 1 / dim_head, wq's gradient scaled
    back as `block_mis_scaled_bwd` does."""
    from dgvit_tpu_torch.ops import cls_block as cb

    inner = heads * dim_head
    dx, grads = cb.cls_bwd_plain(x, dy, q_scaled(w, heads, dim_head), heads,
                                 dim_head)
    grads = list(grads)
    grads[2] = grads[2].clone()
    grads[2][:, :inner] *= dim_head ** -0.5
    return dx, tuple(grads)


def cls_tanh_gelu_bwd(x, dy, w, heads, dim_head):
    """A wrong fp32 K3b: its plain version (recomputing its CLS row) with
    the tanh GELU where the TPU kernel takes the erf form."""
    from dgvit_tpu_torch.ops import cls_block as cb

    with other_gelu():
        return cb.cls_bwd_plain(x, dy, w, heads, dim_head)


def block_hid_plain(x, w, heads, dim_head):
    """The MLP hidden of a block's plain forward, (B, n, mlp):
    gelu(LN2(x1) w1 + b1) with x1 = x + (attention wout + bout), the steps
    of `block_plain` up to its GELU values (`exact_sums`, `other_gelu` and
    a swapped `_attention` reach it as they reach the block)."""
    from dgvit_tpu_torch.ops import fused_transformer as ft

    an_s, an_b, wqkv, wout, bout, fn_s, fn_b, w1, b1, _, _ = w
    cdt, inner = x.dtype, heads * dim_head
    x32 = x.float()
    h = ft._ln(x32, an_s, an_b).to(cdt)
    qkv = ft._mm(h, wqkv).to(cdt)
    o = ft._attention(qkv[..., :inner], qkv[..., inner:2 * inner],
                      qkv[..., 2 * inner:], heads, dim_head, cdt)
    x32 = x32 + (ft._mm(o, wout) + bout.float().reshape(-1))
    h = ft._ln(x32, fn_s, fn_b).to(cdt)
    return ft._gelu32(ft._mm(h, w1) + b1.float().reshape(-1), cdt).to(cdt)


# Gap p's check (phase 2, fp32): the pooled mean|err|/L of the first
# block's MLP hidden against its float64-sum version, under max(this, k x
# the plain version's) (EXACT_K's rule). On the flagship actor's frames
# (an H100 80GB HBM3 at 700 W, chip_draws.py's seeds 7-11) the tanh GELU
# read 4.2e-7 to 1.5e-6 (its gap to the erf form is largest at |pre| near
# 2.7, and most pre-activations are small), K1's body 1.8e-8 to 5.9e-8
# and the plain version 5.4e-9 to 2.6e-8: twice the plain version's would
# fail the kernel's 3xTF32 sums, and 2^-22 (2.4e-7) lies between. Each value's
# max is read too: rows whose LN2 variance is small magnify fp32 sums
# (the plain version read 2.0e-5 L from float64 sums at B=100, the tanh
# GELU 7.6e-6 to 2.1e-5), so no max limit separates the GELU form.
K1_HIDDEN_MEAN = 2.0 ** -22


def k1_hidden(args):
    """Gap p's check, phase 2 in fp32: the GELU values of the trunk's first
    block as K1's fp32 cluster form computes them (its body, tf32_block.cuh,
    summed as K1 sums it, cl32::Fast, through the fp32 forward probe) on
    the stream K1's plain version embeds, against the float64-sum version
    of `block_hid_plain`. It witnesses the body's instantiation that K1
    runs, not K1's launch: what k1_cluster_fp32_kernel adds around the body
    (its embedding, the CLS-only last block, the final norm) only the
    latent check above sees. Returns
    ({version: (pooled mean|err|/L, max|err|/L)} for the kernel's body, the
    plain version, the float64-sum version and a tanh GELU, the pooled
    limit max(K1_HIDDEN_MEAN, EXACT_K["fp32"] x the plain version's)). The
    latent cannot tell the GELU form apart (the tanh GELU reads 0.024-0.032
    of F32_TOL there, the kernel's forms up to 0.0125); the hidden can. A
    mis-scaled block is no wrong version here: the trained actor's first
    block attends one-hot on some frames (score spreads of thousands), and
    there 1 / dim_head computes the same hidden; the latent check above
    holds the scale."""
    import torch

    from dgvit_tpu_torch.ops import fused_transformer as ft

    patches, goal, pe, pos, blocks, _, heads, dim_head, n_valid, _ = args
    emb = ft._mm(patches, pe[0]) + pe[1].float()
    x = torch.cat([goal[:, None, :].float(), emb], dim=1)
    x = (x + pos[:n_valid].float()[None]).contiguous()
    w, hd = blocks[0], (heads, dim_head)
    ex = exact(block_hid_plain, x, w, *hd)
    outs = {"K1's body": forward_probe(x, w, *hd, False, k1=True)[1]["hid"],
            "plain": block_hid_plain(x, w, *hd), "float64 sums": ex}
    with other_gelu():
        outs["tanh GELU"] = block_hid_plain(x, w, *hd)
    read = {name: (pooled_mean([o], [ex]), rel_max([o], [ex]))
            for name, o in outs.items()}
    return read, max(K1_HIDDEN_MEAN, EXACT_K["fp32"] * read["plain"][0])


# fp32 K2b's, K3f's, K3b's and K4's wrong versions (phase 5) and K1's
# (phase 2's pooled latent): fp32 has no rounding point, so the wrong
# versions are a wrong form (the GELU) and a wrong scale
F32_BLOCK_WRONGS = {"tanh GELU": block_tanh_gelu_bwd,
                    "scores scaled 1 / dim_head": block_mis_scaled_bwd}
F32_TRUNK_WRONGS = {"tanh GELU": k4_tanh_gelu,
                    "scores scaled 1 / dim_head": k4_mis_scaled}
F32_CLS_FWD_WRONGS = {"tanh GELU": cls_tanh_gelu_fwd,
                      "scores scaled 1 / dim_head": cls_mis_scaled_fwd}
F32_CLS_BWD_WRONGS = {"tanh GELU": cls_tanh_gelu_bwd,
                      "scores scaled 1 / dim_head": cls_mis_scaled_bwd}
K1_F32_WRONGS = {"tanh GELU": trunk_tanh_gelu,
                 "scores scaled 1 / dim_head": trunk_mis_scaled}
K1_WRONGS = {"erf GELU": trunk_erf_gelu,
             "fp32 residual": trunk_f32_residual,
             "fp32 embedding": trunk_f32_emb}
# K1's forms. Each runs one batch of K1_SAMPLE_BATCH frames of phase 2's
# draw (the route takes the cluster there, the others are forced), and
# K1_SAMPLE launches of K1_SAMPLE_BATCH frames over the frames of the
# B=2048 draw: each form is held by itself at B=32 on 65 launches (2080
# frames). One batch of 32 is no sample for the pooled mean: a frame
# whose trunk flips one bf16 rounding moves its 64 latents, so a batch's
# mean counts its flipped frames, and its limit rises only where the
# plain version flips frames in the same batch. On seeds 7-11 a launch
# of 32 failed that limit alone in 48 of 325 launches of the cluster, 49
# of two frames a block and 14 of the FMA trunk_kernel (whose flips
# mostly fall on the plain version's: it reads 2.7e-6 from the plain
# version where the tensor-core forms read 8.0e-6, and all three the
# same from float64 sums), and 196 of 320 for the erf GELU. Its reading
# is printed beside the sample's. Each form also runs the B=2048 batch as
# one launch (the FMA kernel is what fp32, long frames and other widths
# take).
K1_FORM_NAMES = ("cluster", "mma", "fma")
K1_SAMPLE_BATCH, K1_SAMPLE, K1_LARGE = 32, 64, 2048
# chip_draws.py sets this: every form at every bf16 batch, each form's
# batches held as the route's are (the parent's FMA body beside the new)
K1_ALL_FORMS = False


@contextlib.contextmanager
def k1_forced(form):
    """got_forward_fused launching K1 in `form` whatever its route picks."""
    from dgvit_tpu_torch.ops import got_megakernel as gm

    route = gm.k1_form
    gm.k1_form = lambda *args: form
    try:
        yield
    finally:
        gm.k1_form = route


def k1_launch(form, args, lo=0, hi=None):
    """K1 in `form` on frames [lo, hi) of got_forward_fused's arguments,
    checked finite and equal to a second launch."""
    import torch

    from dgvit_tpu_torch.ops import got_megakernel as gm

    if lo or hi is not None:
        args = (args[0][lo:hi], args[1][lo:hi], *args[2:])
    with k1_forced(form):
        out = gm.got_forward_fused(*args)
        again = gm.got_forward_fused(*args)
    b = args[0].shape[0]
    check(bool(torch.isfinite(out.float()).all()),
          f"non-finite K1 output ({form}, B={b})")
    check(torch.equal(out, again),
          f"K1 ({form}, B={b}) differs between two launches")
    return out


def k1_verdict(triples, k):
    """K1's restated bf16 check on (out, plain, float64-sum) triples, one
    a launch: the pooled mean|err|/L (L the largest |latent| of them all)
    within max(BF16_MEAN, k x plain's) and every launch's max|err| over
    its own largest |latent| within max(BF16_MAX, k x plain's largest)."""
    o, r, e = ([t[i] for t in triples] for i in range(3))
    ok_mean, mean, mean_limit = restated(pooled_mean, BF16_MEAN, k, o, r, e)
    ok_max, top, top_limit = restated(rel_max, BF16_MAX, k, o, r, e)
    alone = sum(not restated(pooled_mean, BF16_MEAN, k, [x], [y], [z])[0]
                for x, y, z in triples)
    over = sum(pooled_mean([x], [z]) > mean_limit for x, _, z in triples)
    return {"rel": mean, "limit": mean_limit, "plain": pooled_mean(r, e),
            "alone_fail": alone, "alone_over_pooled_limit": over,
            "max": top, "max_limit": top_limit, "plain_max": rel_max(r, e),
            "old": pooled_mean(o, r),
            "old_max_ok": rel_max(o, r) <= BF16_MAX,
            "pass": ok_mean and ok_max, "launches": len(o),
            "frames": sum(x.shape[0] for x in o)}


def phase_kernel_vs_plain(cfg, policies, rng):
    """Phase 2: K1 against its plain version; in bf16 restated against
    float64 sums (see EXACT_K): the route's launches pooled ("K1"), each
    form by itself on 65 launches of 32 frames, and the wrong trunks on
    the same frames."""
    import torch

    from dgvit_tpu_torch.ops import got_megakernel as gm

    worst, k = {}, EXACT_K["K1"]
    f32_reads = {}  # fp32: the largest f32_ratio of each version
    f32_runs = []   # fp32: (batch, K1's f32_ratio, ({version: [latent]},
    #                 [float64 sums])) for gap s's pooled check
    pools = {}     # check name: [(out, plain, float64-sum)], one a launch
    single = {}    # form: its one batch of 32, read alone
    cases = [(dt, b) for dt, bs in CHECK_BATCHES.items() for b in bs]
    sb = K1_SAMPLE_BATCH
    for dtype, batch in cases:
        args = trunk_inputs(policies[dtype], batch, rng)
        form = gm.k1_form(*args)
        out = gm.got_forward_fused(*args)
        torch.cuda.synchronize()
        ref = gm.got_forward_plain(*args)
        torch.cuda.synchronize()
        check(out.shape == ref.shape == (batch, cfg.model.latent_size),
              f"K1 output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out.float()).all()),
              "non-finite K1 output")
        check(torch.equal(out, gm.got_forward_fused(*args)),
              f"K1 ({form}, {dtype}, B={batch}) differs between two launches")
        err = (out.float() - ref.float()).abs()
        worst[dtype] = max(worst.get(dtype, 0.0), err.max().item())
        if dtype == "float32":
            # the route, each fp32 form forced, the float64-sum version
            # (which must pass) and a tanh GELU (which must fail)
            outs = {"K1": out, **{f"K1 {f}": k1_launch(f, args)
                                  for f in K1_FP32_FORMS}}
            outs["float64 sums"] = exact(gm.got_forward_plain, *args)
            outs.update({what: fn(*args) for what, fn in
                         K1_F32_WRONGS.items()})
            ratios = {name: f32_ratio(o, ref) for name, o in outs.items()}
            for name, r in ratios.items():
                f32_reads[name] = max(f32_reads.get(name, 0.0), r)
            f32_runs.append((batch, ratios["K1"], (
                {"plain": [ref], **{n: [o] for n, o in outs.items()}},
                [outs["float64 sums"]])))
            hid, hid_limit = k1_hidden(args)
            ok_hid = (hid["K1's body"][0] <= hid_limit
                      and hid["float64 sums"][0] <= hid_limit)
            bad_hid = hid["tanh GELU"][0] <= hid_limit
            print(f"K1 fp32 B={batch}, the first block's MLP hidden against "
                  f"float64 sums, pooled mean|err|/L (limit max(2^-22, "
                  f"{EXACT_K['fp32']:g} x plain) = {hid_limit:.3e}) and max|"
                  "err|/L (read only): " + ", ".join(
                      f"{n} {v[0]:.3e} {v[1]:.3e}" for n, v in hid.items())
                  + f"; {'ok' if ok_hid else 'FAIL'} (the wrong ones must "
                  "fail)", flush=True)
            record("K1 fp32 hidden", batch=batch, limit=hid_limit,
                   k=EXACT_K["fp32"],
                   readings={n: v[0] for n, v in hid.items()},
                   max_read={n: v[1] for n, v in hid.items()})
            check(ok_hid, f"K1's fp32 body's MLP hidden disagrees with the "
                  f"float64-sum version (B={batch})")
            check(not bad_hid, f"K1's fp32 hidden check passes a tanh GELU "
                  f"(B={batch})")
            print(f"K1 ({form}) vs plain fp32 B={batch}: max|err| "
                  f"{err.max().item():.3e} mean|err| {err.mean().item():.3e}"
                  f" max|ref| {ref.abs().max().item():.3e}; max|err| over "
                  f"{F32_TOL:g} (1 + |ref|), passing at 1: " + ", ".join(
                      f"{n} {r:.3e}" for n, r in ratios.items()),
                  flush=True)
            continue
        ex = exact(gm.got_forward_plain, *args)
        outs = {"K1": out}
        for f in K1_FORM_NAMES:
            if K1_ALL_FORMS or batch in (sb, K1_LARGE):
                outs[f"K1 {f}"] = out if f == form else k1_launch(f, args)
        outs.update({name: wrong(*args) for name, wrong in K1_WRONGS.items()})
        line = (f"K1 bf16 B={batch} (route: {form}), against float64 sums, "
                f"max|err|/L of the batch and mean|err|/L: plain "
                f"{rel_max([ref], [ex]):.3e} {pooled_mean([ref], [ex]):.3e}")
        for name, o in outs.items():
            line += (f"; {name} {rel_max([o], [ex]):.3e} "
                     f"{pooled_mean([o], [ex]):.3e}")
            if name == "K1" or name in K1_WRONGS:
                pools.setdefault(name, []).append((o, ref, ex))
            elif K1_ALL_FORMS:
                pools.setdefault(f"{name}, every batch", []).append(
                    (o, ref, ex))
            elif batch == K1_LARGE:
                pools[f"{name} at B={batch}"] = [(o, ref, ex)]
            if batch == sb and name.startswith("K1 "):
                single[name] = (o, ref, ex)
                pools.setdefault(f"{name} at B={sb}", []).append((o, ref, ex))
        print(line, flush=True)
        if batch == K1_LARGE:
            cuts = [(i, i + sb) for i in range(0, sb * K1_SAMPLE, sb)]
            for f in K1_FORM_NAMES:
                pools.setdefault(f"K1 {f} at B={sb}", []).extend(
                    (k1_launch(f, args, lo, hi), ref[lo:hi], ex[lo:hi])
                    for lo, hi in cuts)
            for name in K1_WRONGS:
                pools[f"{name} at B={sb}"] = [
                    (outs[name][lo:hi], ref[lo:hi], ex[lo:hi])
                    for lo, hi in cuts]
    if f32_reads:
        print(f"K1 fp32 over the batches {CHECK_BATCHES['float32']}, the "
              f"largest max|err| over {F32_TOL:g} (1 + |ref|) against the "
              "plain version (passing at 1): " + ", ".join(
                  f"{n} {r:.3e}" for n, r in f32_reads.items())
              + " (the mis-scaled trunk must fail; the tanh GELU is read "
              "only here: the hidden check above and the pooled check below "
              "hold the GELU form)",
              flush=True)
        record("K1 fp32", readings=dict(f32_reads))
        for name, r in f32_reads.items():
            if name.startswith("scores"):
                check(r > 1, f"K1's fp32 check passes a wrong trunk "
                      f"({name})")
            elif name.startswith(("K1", "float64")):
                check(r <= 1, f"{name} disagrees with K1's plain version "
                      "(fp32)")
        # gap s: the latent pooled over the fp32 batches against float64
        # sums under phase 5's rule, which the tanh GELU must fail too (the
        # F32_TOL check above cannot tell the GELU form apart)
        f32_check("K1", [b for b, _, _ in f32_runs],
                  [r for _, _, r in f32_runs], [o for _, o, _ in f32_runs])
    readings = {name: k1_verdict(t, k) for name, t in pools.items()}
    for name, t in single.items():
        readings[f"{name}, one batch of {sb}"] = {
            **k1_verdict([t], k), "read_only": True}
    for name, v in readings.items():
        kind = ("read only: one batch is no sample" if v.get("read_only")
                else "must fail" if not name.startswith("K1") else "")
        print(f"{name} ({v['launches']} launches, {v['frames']} frames), "
              f"bf16: old reading vs plain mean|err|/L {v['old']:.3e} "
              f"(limit {BF16_MEAN:.3e}), each max within 2^-7 L: "
              f"{v['old_max_ok']}; restated vs float64 sums: mean "
              f"{v['rel']:.3e} (limit max(2^-17, {k:g} x plain "
              f"{v['plain']:.3e}) = {v['limit']:.3e}), the launches' largest"
              f" max|err|/L {v['max']:.3e} (limit max(2^-7, {k:g} x plain "
              f"{v['plain_max']:.3e}) = {v['max_limit']:.3e}); launches "
              f"whose mean fails the limit alone: {v['alone_fail']} of "
              f"{v['launches']}, over the pooled limit: "
              f"{v['alone_over_pooled_limit']}; "
              f"{'passes' if v['pass'] else 'FAILS'}"
              + (f" ({kind})" if kind else ""), flush=True)
    record("K1 latent", k=k, readings=readings)
    for name, v in readings.items():
        if v.get("read_only"):
            continue
        if name.startswith("K1"):
            check(v["pass"], f"{name} disagrees with the float64-sum version"
                  " of its plain version (bf16)")
        else:
            check(not v["pass"], f"the restated bf16 limits pass a wrong "
                  f"trunk ({name})")
    return worst


def phase_policy(cfg, flat):
    import numpy as np
    import torch

    from dgvit_tpu_torch.ops.got_megakernel import got_forward_plain
    from dgvit_tpu_torch.serve import make_action_fn

    g = np.load(GOLDEN)
    check(int(g["seed"]) == GOLDEN_SEED, "golden file seed")
    obs, goal = golden_inputs()
    act = make_action_fn(cfg, flat, device=DEVICE)         # bf16
    a = act(obs, goal)
    check(a.shape == (GOLDEN_FRAMES, cfg.sac.action_dim) and
          bool(np.isfinite(a).all()), "served actions: shape or non-finite")
    with torch.no_grad():
        o = torch.from_numpy(obs).to(DEVICE)
        gl = torch.from_numpy(goal).to(DEVICE)
        pol = act.policy
        lat = got_forward_plain(*pol.trans.trunk_args(o, pol.fc_embed(gl)))
        a_plain = torch.tanh(pol.from_latent(lat)[0]).float()
    d_plain = np.abs(a - a_plain.cpu().numpy())
    e_plain = d_plain.max()
    e_gold = np.abs(a - g["actions"]).max()
    act32 = make_action_fn(cfg, flat, dtype=torch.float32, device=DEVICE)
    e_gold32 = np.abs(act32(obs, goal) - g["actions"]).max()
    with torch.no_grad():
        pol = act32.policy
        lat = pol.trans(o, pol.fc_embed(gl), inference=True).cpu().numpy()
    e_lat32 = np.abs(lat - g["latents"]).max()
    print(f"policy bf16 kernel vs bf16 plain on card: max|err| {e_plain:.3e}"
          f" mean|err| {d_plain.mean():.3e}")
    print(f"policy bf16 kernel vs JAX fp32 golden: max|err| {e_gold:.3e}")
    print(f"policy fp32 kernel vs JAX fp32 golden: actions {e_gold32:.3e}, "
          f"latents {e_lat32:.3e}", flush=True)
    check(e_plain <= ACTION_BF16, "bf16 actions: kernel vs plain")
    check(e_gold <= ACTION_BF16_VS_FP32, "bf16 actions vs JAX golden")
    check(e_gold32 <= ACTION_FP32 and e_lat32 <= ACTION_FP32,
          "fp32 kernel path vs JAX golden")
    return act


def phase_serving(act, rng):
    """The main path: concurrent clients through the batching server."""
    import numpy as np

    from dgvit_tpu_torch.ops.got_megakernel import got_forward_fused
    from dgvit_tpu_torch.serve import BatchingActorServer

    n_cli, reqs, buckets = 32, 4, (1, 8, 16, 32)
    frames = rng.uniform(0, 1, (n_cli, 128, 160)).astype(np.float32)
    goals = np.stack([rng.uniform(0, 1, n_cli), rng.uniform(-1, 1, n_cli)],
                     axis=1).astype(np.float32)
    # the direct answer for each row (one frame a call), and a warm bucket
    # grid, before the counted run
    direct = np.concatenate([act(frames[i:i + 1], goals[i:i + 1])
                             for i in range(n_cli)])
    for b in buckets:
        act(frames[:b], goals[:b])
    answers = [[None] * reqs for _ in range(n_cli)]

    got_forward_fused.launches = 0
    with BatchingActorServer(act, max_wait_ms=4.0, buckets=buckets) as srv:
        barrier = threading.Barrier(n_cli)

        def client(i):
            barrier.wait()
            for r in range(reqs):
                answers[i][r] = srv.act(frames[i], goals[i], timeout=120)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_cli)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - t0
        stats = srv.stats()
    launches = got_forward_fused.launches

    check(stats["requests"] == n_cli * reqs and all(
        a is not None and a.shape == (2,) for row in answers for a in row),
        "a client got no answer")
    # the heads' bf16 matmuls may take another library kernel at another
    # batch size, so a row can differ from its batch-of-one answer by a
    # bf16 rounding of the action (2^-8 at |a| < 1)
    worst = max(np.abs(answers[i][r] - direct[i]).max()
                for i in range(n_cli) for r in range(reqs))
    print(f"serving: {n_cli * reqs} requests from {n_cli} clients in "
          f"{elapsed:.4f} s = {n_cli * reqs / elapsed:.1f} actions/s (host "
          f"clock); {stats['dispatches']} dispatches, mean batch "
          f"{stats['mean_batch']:.2f}, padded rows {stats['padded_rows']}; "
          f"K1 launches {launches}; max|answer - direct| {worst:.3e}",
          flush=True)
    check(worst <= 2.0 ** -7, "served answers differ from direct act")
    check(launches >= 1 and launches == stats["dispatches"],
          "serving did not go through K1")
    check_serving_kernels(act, frames, goals, buckets)
    return launches


def check_serving_kernels(act, frames, goals, buckets):
    """Each serving bucket's CUDA kernels by name (torch.profiler): on a
    card of 4 SMs or more a frame, K1's cluster form, k1_cluster_kernel;
    else k1_mma_kernel; never the FMA trunk_kernel."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b in buckets:
        want = ("k1_cluster_kernel" if 4 * b <= sms else "k1_mma_kernel")
        seen = device_kernels_ms(lambda: act(frames[:b], goals[:b]),
                                 calls=10)
        names = [k for k in seen if "k1_" in k or "trunk_kernel" in k]
        print(f"serving bucket {b}: K1's CUDA kernels {names}", flush=True)
        check(any(want in k for k in names) and len(names) == 1,
              f"serving bucket {b} ran {names}, designed {want}")


def phase_times(cfg, policies, rng):
    """Phase 8: K1 and its plain version at each timed batch, K1 in every
    form beside the bound; then the cluster and the two-frame form at the
    batches of K1_CROSSOVER, where k1_form_for's boundary lies."""
    from dgvit_tpu_torch.ops import got_megakernel as gm

    rows = {}
    for batch, reps in TIMED_BATCHES:
        args = trunk_inputs(policies["bfloat16"], batch, rng)
        route = gm.k1_form(*args)
        ms = cuda_ms(lambda: gm.got_forward_fused(*args), reps)
        plain = cuda_ms(lambda: gm.got_forward_plain(*args),
                        max(1, reps // 5), runs=5)
        forms = {route: ms}
        for form in K1_FORM_NAMES:
            if form not in forms:
                with k1_forced(form):
                    forms[form] = cuda_ms(lambda: gm.got_forward_fused(*args),
                                          reps)
        bnd, by = bound_ms(*k1_work(cfg, batch, "bfloat16"), "bfloat16")
        rows[batch] = dict(ms=ms, form=route, forms=forms, plain_ms=plain,
                           bound_ms=bnd, bound_by=by)
        print(f"K1 bf16 B={batch}: kernel ({route}) {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bnd:.5f} ms ({by}), "
              f"{batch / ms * 1e3:.0f} frames/s; by form: " + ", ".join(
                  f"{f} {t:.4f} ms" for f, t in forms.items()), flush=True)
    # the sweep's frames from a generator of its own, so that the phases
    # after this one draw what they drew before the sweep was added
    own = rng.spawn(1)[0]
    for batch in K1_CROSSOVER:
        args = trunk_inputs(policies["bfloat16"], batch, own)
        route, forms = gm.k1_form(*args), {}
        for form in ("cluster", "mma"):
            with k1_forced(form):
                forms[form] = cuda_ms(lambda: gm.got_forward_fused(*args), 10)
        rows.setdefault("crossover", {})[batch] = dict(route=route, **forms)
        print(f"K1 bf16 B={batch} (route: {route}): cluster "
              f"{forms['cluster']:.4f} ms, two frames a block "
              f"{forms['mma']:.4f} ms", flush=True)
    return rows


# --------------------------------------------------------------------------
# the SAC slice
# --------------------------------------------------------------------------

# Tolerances of the training kernels against their plain versions on the
# card, per tensor (the output, or dx and each of the 11 weight grads),
# with L the largest |value| of the plain version's tensor.
# fp32: another summation order; max |err| <= 1e-5 L.
# bf16: the same rounding points, so most values agree bit for bit; a sum
# taken in another order can flip one bf16 rounding, and a flip in an
# intermediate (qkv, p, dpre, dqkv) moves what follows by about one ulp of
# its own magnitude. Each tensor: max |err| <= 2^-6 L; pooled over every
# tensor of a kernel's bf16 batches: mean |err| / L <= 2^-18. An H100
# read pooled 1.2e-6 (K4) and <= 5e-8 (K2f, K3f, K3b), and 1.9e-5 / 2.8e-5
# for the wrong K2b / K3b backward (autograd of the plain forward); every
# max stayed within 2^-6 L for both. K2b read 3.3e-7 with an FMA body and
# 1.3e-6 with its tensor-core body (an H100 80GB HBM3 at 700 W): the
# tensor cores' fp32 sums flip more bf16 roundings, still 3x under the
# limit and 15x under the wrong backward. K3b at B=256 read 1.6e-7 with
# its FMA body and 7.1e-7 with its tensor-core body on the same draws;
# pooled, the tensor-core K3b read 4.7e-8 and its wrong versions 2.8e-5
# (autograd) and 2.7e-5 (k and v in fp32). ds, dq and dk|dv left in fp32
# read only 1.7e-6 to 2.2e-6 by batch: these weights' dx is carried by
# its CLS row, which that rounding barely reaches, so it is no wrong
# version the limits can see.
# fp32 K2b, K3b and K4 and K4's pooled bf16 latent are held to the
# float64-sum version of the plain version, these limits restated (see
# EXACT_K).
TRAIN_F32_MAX = 1e-5
TRAIN_BF16_MAX, TRAIN_BF16_MEAN = 2.0 ** -6, 2.0 ** -18
# The fp32 SAC update through the kernels against the same update through
# the plain versions on the card, and against the JAX golden update on the
# CPU (fp32, other summation orders): the six metrics and each gradient's
# norm within rtol 1e-4 + atol 1e-6, every gradient element within 1e-4 of
# its tensor's largest |value| (kernel against plain). Each parameter's
# update norm within rtol 1e-2 + 2^-22 |p| + 1e-6, and every parameter
# within 2.2 lr of the plain update's. The update is looser because the
# golden state takes Adam's first step, lr * g / (|g| + 1e-8): 22% of the
# gradient elements are below 1e-6 (most exact zeros behind dead ReLUs),
# and those near 1e-8 take steps anywhere in (0, lr) set by the low bits
# of their gradients, which another summation order changes (an H100 read
# 0.24% on one norm, the CPU 0.11%); and new - old of a parameter p
# carries the fp32 rounding of p (the target's Polyak step, tau * lr, is a
# few ulps).
METRICS = ("qf1_loss", "qf2_loss", "policy_loss", "alpha_loss", "alpha",
           "entropy")
SAC_RTOL, SAC_ATOL, UPDATE_RTOL = 1e-4, 1e-6, 1e-2


def golden_ref(g, metrics=METRICS):
    """The golden file as a run of `golden_update` (metrics and norms)."""
    return {"metrics": {k: float(g[k]) for k in metrics},
            **{kind: {str(n): float(v) for n, v in
                      zip(g[f"{kind}_names"], g[f"{kind}_norms"])}
               for kind in ("grad", "update")}}


def update_mismatches(run, ref):
    """Each metric, gradient norm and update norm of `run` off `ref` beyond
    its tolerance, and the largest relative difference of each kind."""
    bad, worst = [], {}
    for kind in ("metrics", "grad", "update"):
        for name, r in ref[kind].items():
            a = run[kind][name]
            tol = SAC_RTOL * abs(r) + SAC_ATOL
            if kind == "update":
                tol = (UPDATE_RTOL * abs(r) + SAC_ATOL
                       + 2.0 ** -22 * run["param_norm"].get(name, 0.0))
            if not abs(a - r) <= tol:
                bad.append(f"{kind} {name}: {a:.7g} vs {r:.7g}")
            worst[kind] = max(worst.get(kind, 0.0),
                              abs(a - r) / max(abs(r), 1e-30))
    return bad, worst


def unflatten(flat):
    """'/'-joined flat parameter paths -> the nested tree."""
    tree = {}
    for key, val in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def critic_params(seed=CRITIC_SEED, d=64, heads=4, dim_head=64, mlp=2048,
                  n_patch=64, pd=320, depth=4, action=2, pstate=2):
    """A flagship GoT critic's parameters in the JAX package's flat layout,
    drawn with numpy: Xavier-uniform kernels, torch-default uniform biases,
    a standard-normal positional embedding, norm scales near 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    out = {}

    def dense(name, fi, fo, bias=True):
        b = math.sqrt(6.0 / (fi + fo))
        out[f"{name}/kernel"] = f32(rng.uniform(-b, b, (fi, fo)))
        if bias:
            c = 1.0 / math.sqrt(fi)
            out[f"{name}/bias"] = f32(rng.uniform(-c, c, fo))

    def norm(name):
        out[f"{name}/scale"] = f32(1 + 0.1 * rng.standard_normal(d))
        out[f"{name}/bias"] = f32(0.05 * rng.standard_normal(d))

    inner = heads * dim_head
    dense("fc_embed", pstate, d)
    dense("trans/patch_embed", pd, d)
    out["trans/pos_embedding"] = f32(rng.standard_normal((1, n_patch + 1, d)))
    for i in range(depth):
        blk = f"trans/transformer/block_{i}"
        norm(f"{blk}/attn_norm")
        dense(f"{blk}/attn/to_qkv", d, 3 * inner, bias=False)
        b = math.sqrt(6.0 / (inner + d))
        out[f"{blk}/attn/to_out/kernel"] = f32(rng.uniform(-b, b, (inner, d)))
        c = 1.0 / math.sqrt(inner)
        out[f"{blk}/attn/to_out/bias"] = f32(rng.uniform(-c, c, d))
        norm(f"{blk}/ff_norm")
        dense(f"{blk}/ff/fc1", d, mlp)
        dense(f"{blk}/ff/fc2", mlp, d)
    out["trans/norm_out/g"] = f32(1 + 0.1 * rng.standard_normal(d))
    for heads_ in (("fc1", "fc2", "fc3"), ("fc11", "fc21", "fc31")):
        for name, fi, fo in zip(heads_, (d + action, 128, 32),
                                (128, 32, action)):
            dense(name, fi, fo)
    return out


def golden_params():
    """(actor, critic) flat parameters of the golden SAC state: the trained
    actor and the seeded critic."""
    import numpy as np

    with np.load(ACTOR) as data:
        actor = {k: np.asarray(data[k]) for k in data.files}
    return actor, critic_params()


def golden_batch(seed=GOLDEN_SAC_SEED, b=GOLDEN_SAC_BATCH):
    """A seeded replay batch of flagship (128, 160) depth frames."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    return {"obs": f(b, 128, 160), "pobs": f(b, 2),
            "act": rng.uniform(-1, 1, (b, 2)).astype(np.float32),
            "rew": rng.normal(0, 1, (b, 1)).astype(np.float32),
            "next_obs": f(b, 128, 160), "next_pobs": f(b, 2),
            "done": np.zeros((b, 1), np.float32)}


GUIDED_METRICS = ("qf1_loss", "qf2_loss", "policy_loss", "alpha_loss",
                  "alpha", "n_expert", "guidence_weight")
GOLDEN_SAC_GUIDED = ROOT / "tests" / "data" / "torch_sac_guided_golden.npz"
# the golden guided update's expert rows: 5 of GOLDEN_SAC_BATCH valid; its
# agent rows 1 and 6 engaged
GOLDEN_N_EXPERT, GOLDEN_ENGAGED = 5, (1, 6)


def golden_guided_batches(seed=GOLDEN_SAC_SEED, b=GOLDEN_SAC_BATCH):
    """The golden guided update's agent batch (golden_batch, with engage
    flags) and expert batch (another seeded batch, the expert's action as
    'act')."""
    import numpy as np

    agent, expert = golden_batch(seed, b), golden_batch(seed + 1, b)
    agent["engage"] = np.zeros((b, 1), np.float32)
    agent["engage"][list(GOLDEN_ENGAGED)] = 1.0
    return agent, expert


def sac_state(agent, actor_flat, critic_flat):
    """The agent's fresh state with these actor and critic parameters (the
    target a copy of the critic; fresh Adam; log_alpha = log sac.alpha)."""
    from dgvit_tpu_torch.models import params_from_jax

    state = agent.init_state()
    state.actor.load_state_dict(params_from_jax(actor_flat))
    critic = params_from_jax(critic_flat)
    state.critic.load_state_dict(critic)
    state.critic_target.load_state_dict(critic)
    return state


def golden_update(device, g, guided=False):
    """One fp32 update of the golden state on `device` with the golden
    noise, dropout off (`guided`: the guided update on
    golden_guided_batches, GOLDEN_N_EXPERT valid expert rows): metrics,
    per-parameter gradients and their norms, update norms, and the
    parameters after it (port names)."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.config import Config

    cfg = Config.from_dict({"model": {"emb_dropout": 0.0}})
    agent = SACAgent(cfg, dtype=torch.float32, device=device,
                     seed=GOLDEN_SAC_SEED)
    state = sac_state(agent, *golden_params())
    before = update_start(state)
    noise = (g["noise_next"], g["noise_pi"])
    if guided:
        state, m = agent.learn_guidence(state, *golden_guided_batches(),
                                        GOLDEN_N_EXPERT, noise=noise)
    else:
        state, m = agent.learn(state, golden_batch(), noise=noise)
    return update_record(state, m, before)


UPDATED = ("actor", "critic", "critic_target")


def update_start(state):
    """The train state's parameters (port names) and log_alpha before an
    update, for `update_record`."""
    return ({f"{k}.{n}": p.detach().clone() for k in UPDATED
             for n, p in getattr(state, k).named_parameters()},
            state.log_alpha.item())


def update_record(state, metrics, before):
    """One update in the form `update_mismatches` reads: its metrics, the
    actor's and critic's per-parameter gradients and their norms, the
    parameters after it, their norms, and each one's update norm against
    `before` (`update_start`)."""
    params0, alpha0 = before
    grads = {f"{k}.{n}": p.grad.detach().clone() for k in UPDATED[:2]
             for n, p in getattr(state, k).named_parameters()}
    params = {f"{k}.{n}": p.detach().clone() for k in UPDATED
              for n, p in getattr(state, k).named_parameters()}
    update = {n: (p - params0[n]).norm().item() for n, p in params.items()}
    update["log_alpha"] = abs(state.log_alpha.item() - alpha0)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "params": params, "update": update,
            "grad": {k: v.norm().item() for k, v in grads.items()},
            "param_norm": {k: v.norm().item() for k, v in params.items()}}


def kernel_counters():
    """Each kernel wrapper of the port, by the kernel's short name."""
    from dgvit_tpu_torch.ops.attention import attention_fused
    from dgvit_tpu_torch.ops.cls_block import cls_bwd_fused, cls_fwd_fused
    from dgvit_tpu_torch.ops.fused_block import fused_attention_section
    from dgvit_tpu_torch.ops.fused_preprocess import preprocess_depth_fused
    from dgvit_tpu_torch.ops.fused_transformer import (block_bwd_fused,
                                                       block_fwd_fused)
    from dgvit_tpu_torch.ops.got_megakernel import (blocks_cls_forward_fused,
                                                    got_forward_fused)
    from dgvit_tpu_torch.ops.trunk_train import trunk_bwd_fused

    return {"K1": got_forward_fused, "K4": blocks_cls_forward_fused,
            "K2f": block_fwd_fused, "K2b": block_bwd_fused,
            "K3f": cls_fwd_fused, "K3b": cls_bwd_fused,
            "K5": preprocess_depth_fused, "K6": trunk_bwd_fused,
            "K7": fused_attention_section, "K8": attention_fused}


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls (K1-K4, K6, K7, K8) to the plain
    versions (on the same card), for the kernel-against-plain comparison
    of a whole update or a whole route."""
    from dgvit_tpu_torch.ops import attention as att
    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_block as fb
    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops import got_megakernel as gm
    from dgvit_tpu_torch.ops.trunk_train import trunk_bwd_plain

    # the autograd Functions pass the form their forward took: the plain
    # versions have none
    swaps = [(ft, "block_fwd_fused",
              lambda *a, form=None: ft.block_fwd_plain(*a)),
             (ft, "block_bwd_fused",
              lambda *a, form=None: ft.block_bwd_plain(*a)),
             (cb, "cls_fwd_fused",
              lambda *a, form=None, **k: cb.cls_fwd_plain(*a, **k)),
             (cb, "cls_bwd_fused",
              lambda *a, form=None: cb.cls_bwd_plain(*a)),
             (gm, "_launch_blocks", gm.blocks_forward_plain),
             (gm, "trunk_bwd_fused", trunk_bwd_plain),
             (gm, "_launch", lambda *a, form=None: gm.got_forward_plain(
                 *a[:10])),
             (fb, "_launch", fb.attention_section_plain),
             (att, "_launch", lambda *a: att.attention_plain(*a))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def autograd_bwd(plain_fwd):
    """A wrong bf16 backward: autograd of the plain forward, which rounds
    gradients wherever the forward casts, not at the TPU kernel's
    points."""
    import torch

    def bwd(x, dy, w, heads, dim_head, saved=None):
        xr = x.detach().requires_grad_()
        wr = [t.detach().requires_grad_() for t in w]
        gs = torch.autograd.grad(plain_fwd(xr, wr, heads, dim_head),
                                 [xr, *wr], dy)
        return gs[0], tuple(gs[1:])
    return bwd


class TrainErrors:
    """Per-tensor |err| of one kernel (or a wrong version of it) against
    the plain version over the bf16 batches: each tensor's max against
    2^-6 L, the pooled mean of |err| / L against TRAIN_BF16_MEAN."""

    def __init__(self):
        self.sum = self.count = 0.0
        self.max_ok, self.worst = True, 0.0

    def add(self, pairs):
        for out, ref in pairs:
            err = (out.float() - ref.float()).abs()
            scale = max(ref.float().abs().max().item(), 1e-30)
            self.sum += err.sum().item() / scale
            self.count += err.numel()
            self.worst = max(self.worst, err.max().item())
            self.max_ok &= err.max().item() <= TRAIN_BF16_MAX * scale

    @property
    def mean(self):
        return self.sum / self.count

    @property
    def ok(self):
        return self.max_ok and self.mean <= TRAIN_BF16_MEAN


def train_inputs(nets, batch, rng):
    """Per net ('actor', 'critic'): the embedded stream of seeded frames,
    the stream entering the last block, the blocks' and final norm's
    weights as the kernels take them, and seeded output gradients."""
    import torch
    import torch.nn.functional as F

    from dgvit_tpu_torch.ops.fused_transformer import block_fwd_plain

    dev = torch.device(DEVICE)
    img = torch.from_numpy(rng.uniform(0, 1, (batch, 128, 160))
                           .astype("float32")).to(dev)
    goal = torch.from_numpy(rng.uniform(-1, 1, (batch, 2))
                            .astype("float32")).to(dev)
    out = {}
    with torch.no_grad():
        for name, net in nets.items():
            tok = net.fc_embed(goal)
            if name == "critic":
                tok = F.relu(tok)
            x = net.trans.embed(img, tok).contiguous()
            cdt = x.dtype
            _, _, blocks, fn = net.trans.fused_params(cdt)
            heads, dh = net.trans.heads, net.trans.dim_head
            last = x
            for w in blocks[:-1]:
                last = block_fwd_plain(last, w, heads, dh)
            dy = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
                "float32")).to(dev).to(cdt)
            out[name] = dict(x=x, last=last, blocks=blocks, fn=fn,
                             heads=heads, dh=dh, dy2=dy(batch, 65, x.shape[2]),
                             dy3=dy(batch, x.shape[2]))
    return out


def train_cases(inp):
    """(name, kernel call, plain call, {what: wrong call}) of each
    training kernel on these inputs: K4 on the actor's trunk, K2 on the
    actor's first block, K3 on the critic's last block. Each wrong call
    is the plain version with one rounding point or form moved (or, for
    the backwards, autograd's rounding points), which the bf16 limits must
    see."""
    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops import got_megakernel as gm

    a, c = inp["actor"], inp["critic"]
    hd = (a["heads"], a["dh"])
    k4 = (a["x"], a["blocks"], a["fn"], *hd, "rms")
    k2 = (a["x"], a["blocks"][0], *hd)
    k2b = (a["x"], a["dy2"], a["blocks"][0], *hd)
    k3 = (c["last"], c["blocks"][-1], *hd)
    # K3b differentiates the CLS row K3f computed: both versions read the
    # records K3f keeps under autograd
    k3b = (c["last"], c["dy3"], c["blocks"][-1], *hd,
           cb.cls_fwd_fused(*k3, save=True)[1])
    autograd = "autograd of the plain forward"
    return [
        ("K4", lambda: gm.blocks_cls_forward_fused(*k4),
         lambda: gm.blocks_forward_plain(*k4),
         {"erf GELU": lambda: k4_erf_gelu(*k4),
          "fp32 residual": lambda: k4_f32_residual(*k4)}),
        ("K2f", lambda: ft.block_fwd_fused(*k2),
         lambda: ft.block_fwd_plain(*k2),
         {"fp32 probabilities": lambda: k2f_f32_probs(*k2)}),
        ("K2b", lambda: ft.block_bwd_fused(*k2b),
         lambda: ft.block_bwd_plain(*k2b),
         {autograd: lambda: autograd_bwd(ft.block_fwd_plain)(*k2b)}),
        ("K3f", lambda: cb.cls_fwd_fused(*k3),
         lambda: cb.cls_fwd_plain(*k3),
         {"erf GELU": lambda: k3f_erf_gelu(*k3),
          "fp32 probabilities": lambda: k3f_f32_probs(*k3),
          "k and v in fp32": lambda: k3f_f32_kv(*k3)}),
        ("K3b", lambda: cb.cls_bwd_fused(*k3b),
         lambda: cb.cls_bwd_plain(*k3b),
         {autograd: lambda: autograd_bwd(cb.cls_fwd_plain)(*k3b),
          "k and v in fp32": lambda: k3b_f32_kv(*k3b)}),
    ]


def tensors(result):
    """The output, or dx and the 11 grads, as one list."""
    if isinstance(result, tuple):
        return [result[0], *result[1]]
    return [result]


def build_nets(actor_flat, critic_flat):
    """The trained actor and the seeded critic on the card, per dtype."""
    import torch

    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.models import build_actor, build_critic
    from dgvit_tpu_torch.models import params_from_jax

    cfg = Config()
    nets = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        actor, critic = build_actor(cfg, dtype=dt), build_critic(cfg, dtype=dt)
        actor.load_state_dict(params_from_jax(actor_flat))
        critic.load_state_dict(params_from_jax(critic_flat))
        nets[dtype] = {"actor": actor.to(DEVICE).eval(),
                       "critic": critic.to(DEVICE).eval()}
    return nets


RESTATED_F32 = ("K2b", "K3f", "K3b", "K4")   # fp32 checks, restated
# Phase 5's pooled fp32 statistic (gap r of ROADMAP.md, and fp32 K4): the
# mean |err| / L of every value, L each tensor's largest |value| of the
# yardstick, pooled over the tensors and the fp32 batches, under
# max(F32_POOLED, k x the plain version's own reading); see EXACT_K
F32_POOLED = 2.0 ** -22


def tensor_stats(outs, refs):
    """(mean|err|/L, max|err|/L, size) of each output against its
    yardstick, L the yardstick's largest |value|, in float64: the raw
    readings phase 5's restated statistics are taken from."""
    read = []
    for o, r in zip(outs, refs):
        r64 = r.double()
        err = (o.double() - r64).abs()
        scale = max(r64.abs().max().item(), 1e-30)
        read.append((err.mean().item() / scale, err.max().item() / scale,
                     err.numel()))
    return read


def pooled_stat(read):
    """The mean|err|/L of every value of tensor_stats' tensors, pooled."""
    return (sum(m * c for m, _, c in read)
            / max(sum(c for _, _, c in read), 1))


def max_stat(read):
    """The largest max|err|/L over tensor_stats' tensors (rel_max)."""
    return max(x for _, x, _ in read)


def f32_versions(name, args, out, ref, ex):
    """One batch of phase 5's restated fp32 check of K2b, K3f, K3b or K4:
    ({version: tensors}: the kernel (the route's form: the fp32 cluster at
    these widths), the FMA body (forced; K3b on the records K3f's FMA body
    writes, a backward reading the forward that ran), the plain and the
    float64-sum versions and the wrong versions (F32_SPECS); the
    yardstick's tensors: the plain version evaluated in float64 throughout
    for K2b, K3f and K3b (`float64_eval`; K3b's recomputing the CLS row),
    its float64-sum version `ex` for K4)."""
    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops import got_megakernel as gm

    _, wrongs, _ = F32_SPECS[name]
    if name == "K2b":
        fma = ft.launch_block_bwd(*args, False, form=0)
        yard = tensors(float64_eval(ft.block_bwd_plain, *args))
    elif name == "K3f":
        fma = ft.launch_block_fwd(*args, True, form=0)
        x, w, heads, dh = args
        yard = tensors(float64_eval(cb.cls_fwd_plain, x, None, w, heads, dh))
    elif name == "K3b":
        x, dy, w, heads, dh = args
        rec = cb.saved_buffer(x, w, heads, dh)
        ft.launch_block_fwd(x, w, heads, dh, True, saved=rec, form=0)
        fma = ft.launch_block_bwd(*args, True, saved=rec, form=0)
        yard = tensors(float64_eval(cb.cls_bwd_plain, *args))
    else:
        blocks, fn = gm._flat_vectors(args[1], args[2])
        fma = gm._launch_blocks(args[0], blocks, fn, *args[3:],
                                body=gm.K4_FORMS["fma"])
        yard = ex
    return {"kernel": out, "FMA body": tensors(fma), "plain": ref,
            "float64 sums": ex,
            **{what: tensors(fn(*args)) for what, fn in wrongs.items()}}, yard


def verdicts(errs):
    """{version: its pooled mean, every max within 2^-6 L, passes} of
    TrainErrors by version (a reading for chip_draws.py)."""
    return {name: {"mean": e.mean, "max_ok": e.max_ok, "pass": e.ok}
            for name, e in errs.items()}


# The restated fp32 checks (see EXACT_K), by kernel: (the yardstick, the
# wrong versions, whether each batch's largest max|err|/L is held too).
# K2b, K3f and K3b against the plain version evaluated in float64
# throughout, K4 and K1's latent against their float64-sum versions.
F32_SPECS = {
    "K2b": ("the float64 evaluation", F32_BLOCK_WRONGS, False),
    "K3f": ("the float64 evaluation", F32_CLS_FWD_WRONGS, False),
    "K3b": ("the float64 evaluation", F32_CLS_BWD_WRONGS, False),
    "K4": ("float64 sums", F32_TRUNK_WRONGS, True),
    "K1": ("float64 sums", K1_F32_WRONGS, False)}


def f32_rule(name, runs):
    """The restated fp32 rule (`f32_check`) of K2b, K3f, K3b, K4 (phase 5)
    or K1's latent (phase 2) over `runs`, one ({version: tensors}, the
    yardstick's tensors) a batch: (the raw readings by batch, each
    version's mean|err|/L pooled over every tensor of every batch, the
    pooled limit max(F32_POOLED, k x the plain version's), each version's
    largest max|err|/L by batch, the max limits by batch, max(TRAIN_F32_MAX,
    k x the plain version's), {version: passes}). K4 is held by each
    batch's largest max|err|/L too, the others by the pooled mean alone."""
    k = EXACT_K["fp32"]
    raw = [{v: tensor_stats(o, yard) for v, o in versions.items()}
           for versions, yard in runs]
    pooled = {v: pooled_stat([t for r in raw for t in r[v]]) for v in raw[0]}
    limit = max(F32_POOLED, k * pooled["plain"])
    mx = {v: [max_stat(r[v]) for r in raw] for v in raw[0]}
    max_limit = [max(TRAIN_F32_MAX, k * m) for m in mx["plain"]]
    per_batch = F32_SPECS[name][2]
    verdict = {v: pooled[v] <= limit and (not per_batch or all(
        m <= lim for m, lim in zip(mx[v], max_limit))) for v in raw[0]}
    return raw, pooled, limit, mx, max_limit, verdict


def f32_check(name, batches, runs, old):
    """The restated fp32 check of K2b, K3f, K3b, K4 (phase 5) or K1's
    latent (phase 2; see EXACT_K) over its fp32 batches (`f32_rule` on
    `runs`, `f32_versions`' a batch): the kernel, the FMA body, the plain
    and the float64-sum versions must pass it, the wrong versions fail it.
    `old`: the kernel's old reading by batch (printed beside). Returns the
    largest ratio of a correct version's reading to the limit and the
    smallest of a wrong one's (the margins)."""
    raw, pooled, limit, mx, max_limit, verdict = f32_rule(name, runs)
    k = EXACT_K["fp32"]
    against, wrongs, per_batch = F32_SPECS[name]
    wrong = set(wrongs)
    print(f"{name} fp32 B={'+'.join(map(str, batches))}: old readings "
          f"{', '.join(f'{o:.3e}' for o in old)}; against "
          f"{against}, mean|err|/L pooled over the batches (limit max("
          f"{F32_POOLED:.3e}, {k:g} x plain {pooled['plain']:.3e}) = "
          f"{limit:.3e})" + ("" if not per_batch else
                              " and each batch's max|err|/L (limits max("
                              f"{TRAIN_F32_MAX:g}, {k:g} x plain) = " +
                              ", ".join(f"{m:.3e}" for m in max_limit) + ")")
          + ": " + ", ".join(
              f"{v} {pooled[v]:.3e} (max " + ", ".join(
                  f"{m:.3e}" for m in mx[v]) + ") " + (
                  ("fails" if not verdict[v] else "PASSES") if v in wrong
                  else ("ok" if verdict[v] else "FAIL"))
              for v in pooled), flush=True)
    margins = {"correct": max(pooled[v] / limit for v in pooled
                              if v not in wrong),
               "wrong": min(pooled[v] / limit for v in pooled if v in wrong)}
    record("fp32 train", kernel=name, batches=list(batches), stat="pooled",
           against=against, limit=limit, max_limit=max_limit, old=old, k=k,
           floor=F32_POOLED, readings=pooled, max=mx, verdict=verdict,
           wrong=sorted(wrong), raw=raw, margins=margins)
    print(f"{name} fp32 margins: correct versions at most "
          f"{margins['correct']:.3f} of the pooled limit, wrong ones at "
          f"least {margins['wrong']:.3f} x", flush=True)
    for v, ok in verdict.items():
        if v in wrong:
            check(not ok, f"the restated fp32 rule passes a wrong {name} "
                  f"({v})")
        else:
            check(ok, f"fp32 {name}: the {v} disagrees with {against}")
    return margins


def k2b_bf16_rule(runs):
    """Gap q's rule (`k2b_bf16_check`) on `runs`, ({version: dx and the 11
    gradients}, the float64-sum version's) a batch: ({version: the share
    of its dx frames within 2^-18}, {version: its mean|err|/L pooled over
    dx and the 11 gradients of every batch}, the pooled limit, {version:
    passes}, the frames, the raw readings by batch)."""
    frames, every, raw = {}, {}, []
    for versions, ex in runs:
        entry = {}
        for v, o in versions.items():
            f = frame_errs(o[0], ex[0], own_scale=True)
            frames.setdefault(v, []).extend(f)
            st = tensor_stats(o, ex)
            every.setdefault(v, []).extend(st)
            entry[v] = {"frames": f, "tensors": st}
        raw.append(entry)
    within = {v: sum(x <= TRAIN_BF16_MEAN for x in f) / len(f)
              for v, f in frames.items()}
    pooled = {v: pooled_stat(t) for v, t in every.items()}
    limit = max(TRAIN_BF16_MEAN, EXACT_K["K2b"] * pooled["plain"])
    verdict = {v: within[v] >= CHAIN_WITHIN and pooled[v] <= limit
               for v in within}
    return within, pooled, limit, verdict, len(frames["plain"]), raw


def k2b_bf16_check(runs, old):
    """Phase 5's bf16 K2b check (gap q of ROADMAP.md; see EXACT_K), over
    the bf16 batches: each version's dx frames within TRAIN_BF16_MEAN of
    the float64-sum version's (each frame's mean |err| over its own largest
    |dx|, phase 13's rule), at least CHAIN_WITHIN of them; and its
    mean|err|/L pooled over dx and the 11 gradients (each over its largest
    |value|, the old check's statistic) against the float64-sum version's
    under max(TRAIN_BF16_MEAN, EXACT_K["K2b"] x the plain version's). The
    kernel and the plain version must pass, the wrong version (autograd of
    the plain forward) fail. `runs`: ({version: tensors}, float64-sum
    tensors) a batch; `old`: TrainErrors of the kernel against the plain
    version (the old reading, printed)."""
    import math

    within, pooled, limit, verdict, n, raw = k2b_bf16_rule(runs)
    k = EXACT_K["K2b"]
    se = math.sqrt(CHAIN_WITHIN * (1 - CHAIN_WITHIN) / n)
    print(f"K2b bf16 batches pooled: old reading vs plain mean|err|/L "
          f"{old.mean:.3e} (limit {TRAIN_BF16_MEAN:.3e}), every max within "
          f"2^-6 L: {old.max_ok}; restated vs float64 sums: dx frames within"
          f" 2^-18 (own scale; at least {CHAIN_WITHIN:g} of {n}, standard "
          f"error {se:.4f}) and the mean|err|/L pooled over the tensors "
          f"(limit max(2^-18, {k:g} x plain {pooled['plain']:.3e}) = "
          f"{limit:.3e}): " + ", ".join(
              f"{v} {within[v]:.4f} / {pooled[v]:.3e} " + (
                  ("ok" if verdict[v] else "FAIL") if v in ("K2b", "plain")
                  else ("fails" if not verdict[v] else "PASSES"))
              for v in within), flush=True)
    record("K2b bf16", within=within, pooled=pooled, limit=limit, k=k,
           share=CHAIN_WITHIN, frames=n, verdict=verdict,
           old={"mean": old.mean, "max_ok": old.max_ok}, raw=raw)
    for v, ok in verdict.items():
        if v in ("K2b", "plain"):
            check(ok, f"bf16 K2b: the {v} disagrees with the float64-sum "
                  "version (gap q's rule)")
        else:
            check(not ok, f"bf16 K2b: the restated rule passes a wrong K2b "
                  f"({v})")


def phase_train_kernels(nets, rng):
    """Phase 5: each training kernel against its plain version; fp32 K2b,
    K3f, K3b and K4 and K4's pooled bf16 latent restated against float64
    sums or the float64 evaluation (see EXACT_K, F32_SPECS)."""
    import torch

    errs = {name: TrainErrors() for name in ("K2f", "K3f", "K3b")}
    k3f_exact = TrainErrors()   # K3f's float64-sum version (EXACT_K's (a))
    k2b_runs, k2b_old = [], TrainErrors()   # bf16 K2b (gap q)
    f32_runs = {}   # fp32 K2b, K3f, K3b, K4: [(batch, old, f32_versions)]
    k4_runs = {}         # K4 and its wrong versions: [(out, plain, exact)]
    wrong = {}
    worst = {}
    for dtype, batches in TRAIN_BATCHES.items():
        for batch in batches:
            inp = train_inputs(nets[dtype], batch, rng)
            for name, kern, plain, bads in train_cases(inp):
                out = tensors(kern())
                torch.cuda.synchronize()
                ref = tensors(plain())
                check(all(o.shape == r.shape and o.dtype == r.dtype
                          for o, r in zip(out, ref)) and len(out) == len(ref),
                      f"{name} output shapes/dtypes")
                check(all(bool(torch.isfinite(o.float()).all()) for o in out),
                      f"non-finite {name} output")
                pairs = list(zip(out, ref))
                mx = max((o.float() - r.float()).abs().max().item()
                         for o, r in pairs)
                key = (name, dtype)
                worst[key] = max(worst.get(key, 0.0), mx)
                old = max((o.float() - r.float()).abs().max().item()
                          / max(r.float().abs().max().item(), 1e-30)
                          for o, r in pairs)
                if dtype == "float32" and name in RESTATED_F32:
                    a, c = inp["actor"], inp["critic"]
                    hd = (a["heads"], a["dh"])
                    args = {"K2b": (a["x"], a["dy2"], a["blocks"][0], *hd),
                            "K3f": (c["last"], c["blocks"][-1], *hd),
                            "K3b": (c["last"], c["dy3"], c["blocks"][-1],
                                    *hd),
                            "K4": (a["x"], a["blocks"], a["fn"], *hd,
                                   "rms")}[name]
                    f32_runs.setdefault(name, []).append(
                        (batch, old, f32_versions(name, args, out, ref,
                                                  tensors(exact(plain)))))
                    continue
                if dtype == "float32":
                    ok = old <= TRAIN_F32_MAX
                    print(f"{name} vs plain fp32 B={batch}: max|err| "
                          f"{mx:.3e}, max|err|/L {old:.3e} "
                          f"{'ok' if ok else 'FAIL'}", flush=True)
                    check(ok, f"{name} disagrees with its plain version "
                          f"(fp32, B={batch})")
                    continue
                e = TrainErrors()
                e.add(pairs)
                line = (f"{name} vs plain bf16 B={batch}: max|err| {mx:.3e}, "
                        f"mean|err|/L {e.mean:.3e}, every max within 2^-6 L:"
                        f" {e.max_ok}")
                if name == "K2b":   # gap q: held to float64 sums by frame
                    k2b_runs.append(({"K2b": out, "plain": ref, **{
                        what: tensors(bad()) for what, bad in bads.items()}},
                        tensors(exact(plain))))
                    k2b_old.add(pairs)
                    print(line + " (the old reading)", flush=True)
                    continue
                if name == "K4":
                    ex = tensors(exact(plain))
                    versions = {"K4": out, **{what: tensors(bad())
                                              for what, bad in bads.items()}}
                    for what, o in versions.items():
                        k4_runs.setdefault(what, []).append(
                            (o[0], ref[0], ex[0]))
                    line += "; against float64 sums: " + ", ".join(
                        f"{what} {pooled_rel(o, ex):.3e}"
                        for what, o in versions.items()) + \
                        f", plain {pooled_rel(ref, ex):.3e}"
                else:
                    errs[name].add(pairs)
                    if name == "K3f":
                        k3f_exact.add(zip(tensors(exact(plain)), ref))
                    for what, bad in bads.items():
                        w = TrainErrors()
                        got = tensors(bad())
                        w.add(zip(got, ref))
                        wrong.setdefault((name, what), TrainErrors()).add(
                            zip(got, ref))
                        line += (f"; wrong ({what}) mean|err|/L {w.mean:.3e}"
                                 f", max {w.worst:.3e}")
                print(line, flush=True)
                check(e.max_ok, f"{name} disagrees with its plain version "
                      f"(bf16, B={batch})")
    for name, e in errs.items():
        print(f"{name} bf16 batches pooled: mean|err|/L {e.mean:.3e} (limit "
              f"{TRAIN_BF16_MEAN:.3e}) {'ok' if e.ok else 'FAIL'}", flush=True)
        check(e.ok, f"{name} disagrees with its plain version (bf16 pooled)")
    for (name, what), e in wrong.items():
        print(f"wrong {name} ({what}), bf16 pooled: mean|err|/L "
              f"{e.mean:.3e}, every max within 2^-6 L: {e.max_ok}; "
              f"{'FAIL' if not e.ok else 'passes'}", flush=True)
        check(not e.ok, f"the bf16 limits pass a wrong {name} ({what})")
    for name, rs in f32_runs.items():
        f32_check(name, [b for b, _, _ in rs], [r for _, _, r in rs],
                  [o for _, o, _ in rs])
    k2b_bf16_check(k2b_runs, k2b_old)
    e = k3f_exact
    print(f"K3f's float64-sum version vs its plain version, bf16 pooled: "
          f"mean|err|/L {e.mean:.3e} (limit {TRAIN_BF16_MEAN:.3e}), every "
          f"max within 2^-6 L: {e.max_ok}; {'passes' if e.ok else 'FAILS'}",
          flush=True)
    record("K3f bf16", limit=TRAIN_BF16_MEAN, readings=verdicts({
        "K3f": errs["K3f"], "float64 sums": e,
        **{what: w for (n, what), w in wrong.items() if n == "K3f"}}))
    check(e.ok, "the float64-sum version of K3f's plain version fails its "
          "bf16 check (EXACT_K's rule (a))")
    k, readings = EXACT_K["K4"], {}
    for what, rs in k4_runs.items():
        o, r, e = ([x[i] for x in rs] for i in range(3))
        ok, got, limit = restated(pooled_rel, TRAIN_BF16_MEAN, k, o, r, e)
        within = TrainErrors()
        within.add(zip(o, e))
        old = TrainErrors()
        old.add(zip(o, r))
        ok = ok and within.max_ok
        readings[what] = {"mean": got, "limit": limit, "old": old.mean,
                          "max_ok": within.max_ok, "pass": ok}
        print(f"{'K4' if what == 'K4' else 'wrong K4 (' + what + ')'}, bf16 "
              f"batches pooled: old reading vs plain mean|err|/L "
              f"{old.mean:.3e} (limit {TRAIN_BF16_MEAN:.3e}, "
              f"{'ok' if old.ok else 'FAIL'}); restated vs float64 sums "
              f"{got:.3e} (limit max(2^-18, {k:g} x plain "
              f"{pooled_rel(r, e):.3e}) = {limit:.3e}), every max within "
              f"2^-6 L: {within.max_ok}; {'passes' if ok else 'FAILS'}",
              flush=True)
    _, r, e = ([x[i] for x in k4_runs["K4"]] for i in range(3))
    record("K4 pooled latent", k=k, plain=pooled_rel(r, e),
           readings=readings)
    check(readings["K4"]["pass"], "K4 disagrees with the float64-sum version "
          "of its plain version (bf16 pooled)")
    for what in readings:
        if what != "K4":
            check(not readings[what]["pass"], f"the restated bf16 limits "
                  f"pass a wrong K4 ({what})")
    return worst


# 16 more tokens for phase 5b: 81, a 128x160 frame in 16x16 patches, one
# more row than the tensor-core bodies hold
EXTRA_TOKENS = 16
# K4's latent in one batch of phase 5b is held by frame, as phase 13
# holds K6's dx. A flip anywhere in a frame moves that frame's
# CLS row through four blocks, so a few frames carry a batch's pooled
# mean: the unchanged FMA K4 pooled 1.26e-5 on phase 5b's batch of 32 at
# 81 tokens (an H100 80GB HBM3 at 700 W), and the plain K4 with exact
# (float64) sums pools 5.6e-6 to 1.1e-5 on such batches against the fp32
# plain K4 (chip_numerics.py 7 8, on the CPU), over phase 5's 2^-18. By
# frame the same exact sums keep 69-88% of frames within 2^-18, an erf
# GELU 53-59% and an fp32 residual none: phase 13's rule, two thirds of
# the frames, separates them.


def narrow_block(w, heads=2, dim_head=32, mlp=256):
    """A full block of 2 x 32 heads and a 256-wide MLP cut from a trained
    block (its first head's q, k, v columns and out-projection rows, its
    first MLP columns): off the flagship widths, with trained magnitudes."""
    import torch

    inner, cut = w[3].shape[0], heads * dim_head
    wqkv = torch.cat([w[2][:, p * inner:p * inner + cut] for p in range(3)],
                     dim=1)
    return tuple(t.contiguous() for t in (
        w[0], w[1], wqkv, w[3][:cut], w[4], w[5], w[6], w[7][:, :mlp],
        w[8][:mlp], w[9][:mlp], w[10]))


def off_by_one(t):
    """A copy of t whose data starts 2 bytes past a 16-byte boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view_as(t)
    out.copy_(t)
    return out


def latent_frames_within(out, ref):
    """The share of frames whose latent (a row of K4's output) is within
    phase 5's pooled limit of the plain latent: mean |err| / L over the
    frame's values, L the plain batch's largest |value|."""
    scale = ref.float().abs().max().clamp(min=1e-30)
    per = (out.float() - ref.float()).abs().mean(dim=-1) / scale
    return (per <= TRAIN_BF16_MEAN).float().mean().item()


# Phase 5b holds K6 on the FMA bodies (the actor's trunk) by phase 13's
# per-frame rule against the float64-sum version's dx, each frame's mean
# |err| taken over its own largest |dx| (K6_WIDTHS_WITHIN; the pooled mean
# against the plain version, 2^-13, kept), with phase 13's two wrong
# backwards run at the same widths; its frames: the B=32 cases and
# K6_WIDTHS_EXTRA more draws of K6_WIDTHS_BATCH frames for each of the four
# K6 cases, from a generator spawned off the phase's (later phases keep
# their draws). Phase 13's scale, the batch's largest |dx|, sees nothing
# here: the trained actor's dx reaches its largest values on a few frames,
# and on an H100 80GB HBM3 at 700 W K6 and the plain version read 0.994-
# 0.998 of the frames within 2^-18 of it, both wrong backwards 0.970-0.990
# (chip_draws.py, seeds 7-11; printed as a record). On each frame's own
# scale K6 read 0.8278-0.8478 of the frames within, the plain version
# 0.8337-0.8559, the wrong backwards 0.0091-0.0513.
K6_WIDTHS_EXTRA, K6_WIDTHS_BATCH = 3, 256
K6_WIDTHS_WITHIN = 0.5


def width_cases(a, rng=None):
    """Phase 5b's off-flagship inputs from train_inputs' actor entry:
    (label, x, blocks, heads, dim_head, dy2) with 16 more tokens (81), 2 x
    32 heads with a 256-wide MLP, and an unaligned x; dy2 drawn from rng
    (None: no draw)."""
    import torch

    x, blocks = a["x"], a["blocks"]
    longer = torch.cat([x, x.roll(1, 0)[:, 1:1 + EXTRA_TOKENS]], dim=1)
    cases = [
        (f"{longer.shape[1]} tokens", longer.contiguous(), blocks, 4, 64),
        ("2 x 32 heads, mlp 256", x, [narrow_block(w) for w in blocks], 2,
         32),
        ("flagship widths, x unaligned", off_by_one(x), blocks, 4, 64)]
    return [(*case, None if rng is None else torch.from_numpy(
        rng.standard_normal(case[1].shape).astype("float32")).to(
            DEVICE).bfloat16()) for case in cases]


def unaligned_w1(blocks):
    """The blocks with only the CLS block's w1 off a 16-byte boundary."""
    return [*blocks[:-1], tuple(off_by_one(t) if j == 7 else t
                                for j, t in enumerate(blocks[-1]))]


def phase_bwd_widths(nets, rng):
    """Phase 5b: the bf16 full-block forward (K2f, K3f, K4) and backward
    (K2b, K3b, K6) take the tensor-core bodies at the flagship widths and
    the FMA bodies elsewhere (more tokens than 80, narrow heads, an
    unaligned x); there K2f, K3f, K2b and K3b agree with their plain
    versions within phase 5's limits, K4 within phase 5's per-tensor max
    and phase 13's per-frame rule (see the note at EXTRA_TOKENS), and K6
    within phase 13's pooled mean and its per-frame rule against the
    float64-sum version, which both wrong backwards must fail (see
    K6_WIDTHS_WITHIN). K6 also with only its CLS block's w1 unaligned (the
    FMA bodies, no launch error). The actor's trained blocks on its
    embedded stream of seeded frames, at B=32 (K3f, K3b: its last block on
    the stream that enters it, from the plain forward of the blocks
    before)."""
    import torch

    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops import got_megakernel as gm
    from dgvit_tpu_torch.ops.trunk_train import (tensor_core_trunk,
                                                 trunk_bwd_fused,
                                                 trunk_bwd_plain)

    a = train_inputs(nets["bfloat16"], 32, rng)["actor"]
    x, blocks, dy3 = a["x"], a["blocks"], a["dy3"]
    check(ft.tensor_core_bwd(x, blocks[0], a["dh"], a["dy2"])
          and ft.tensor_core_bwd(x, blocks[-1], a["dh"], dy3)
          and all(ft.tensor_core_fwd(x, w, a["dh"]) for w in blocks),
          "the flagship bf16 blocks do not take the tensor-core bodies")
    k6_frames = {name: [] for name in ("K6", "plain", *K6_WRONGS)}
    batch_scale = {name: [] for name in k6_frames}   # phase 13's, a record
    by_case = {}

    def k6_read(what, args):
        """K6 against its plain version (returned), and K6, the plain
        version and the wrong backwards against the float64-sum version
        by frame."""
        out = trunk_tensors(trunk_bwd_fused(*args))
        ref = trunk_tensors(trunk_bwd_plain(*args))
        ex = trunk_tensors(exact(trunk_bwd_plain, *args))
        versions = {"K6": out, "plain": ref, **{
            name: trunk_tensors(wrong(*args))
            for name, wrong in K6_WRONGS.items()}}
        for name, v in versions.items():
            errs = frame_errs(v[0], ex[0], own_scale=True)
            k6_frames[name] += errs
            batch_scale[name] += frame_errs(v[0], ex[0])
            by_case.setdefault(what, {}).setdefault(name, []).extend(errs)
        e6 = TrainErrors()
        e6.add(zip(out, ref))
        return e6

    for what, xs, bl, heads, dh, dy2 in width_cases(a, rng):
        last = xs
        for w in bl[:-1]:
            last = ft.block_fwd_plain(last, w, heads, dh)
        if xs.data_ptr() % 16:
            last = off_by_one(last)
        check(not ft.tensor_core_bwd(xs, bl[0], dh, dy2)
              and not ft.tensor_core_bwd(last, bl[-1], dh, dy3)
              and not any(ft.tensor_core_fwd(xs, w, dh) for w in bl)
              and not ft.tensor_core_fwd(last, bl[-1], dh),
              f"bf16, {what}: would take a tensor-core body")
        e2 = TrainErrors()
        e2.add(zip(tensors(ft.block_fwd_fused(xs, bl[0], heads, dh)),
                   tensors(ft.block_fwd_plain(xs, bl[0], heads, dh))))
        e3f = TrainErrors()
        e3f.add([(cb.cls_fwd_fused(last, bl[-1], heads, dh),
                  cb.cls_fwd_plain(last, bl[-1], heads, dh))])
        k4 = (xs, bl, a["fn"], heads, dh, "rms")
        out, ref = (gm.blocks_cls_forward_fused(*k4),
                    gm.blocks_forward_plain(*k4))
        e4 = TrainErrors()
        e4.add([(out, ref)])
        within = latent_frames_within(out, ref)
        ok = e2.ok and e3f.ok and e4.max_ok and within >= K6_FRAMES_WITHIN
        print(f"bf16 forward, {what}, FMA body: K2f vs plain mean|err|/L "
              f"{e2.mean:.3e}, K3f {e3f.mean:.3e} (limit "
              f"{TRAIN_BF16_MEAN:.3e}); K4 vs plain "
              f"mean|err|/L {e4.mean:.3e}, frames within "
              f"{TRAIN_BF16_MEAN:.3e}: {within:.3f} (at least "
              f"{K6_FRAMES_WITHIN:.3f}); every max within 2^-6 L: "
              f"{e2.max_ok and e3f.max_ok and e4.max_ok} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"bf16 forward, {what}: K2f, K3f or K4 disagrees with its"
              " plain version")
        e = TrainErrors()
        e.add(zip(tensors(ft.block_bwd_fused(xs, dy2, bl[0], heads, dh)),
                  tensors(ft.block_bwd_plain(xs, dy2, bl[0], heads, dh))))
        e3 = TrainErrors()
        rec = cb.cls_fwd_fused(last, bl[-1], heads, dh, save=True)[1]
        e3.add(zip(tensors(cb.cls_bwd_fused(last, dy3, bl[-1], heads, dh,
                                            rec)),
                   tensors(cb.cls_bwd_plain(last, dy3, bl[-1], heads, dh,
                                            rec))))
        e6 = k6_read(what, with_streams((xs, dy3, bl, a["fn"], heads, dh,
                                         "rms")))
        ok = e.ok and e3.ok and e6.mean <= K6_BF16_MEAN
        print(f"bf16 backward, {what}, FMA body: K2b vs plain mean|err|/L "
              f"{e.mean:.3e}, K3b {e3.mean:.3e} (limit "
              f"{TRAIN_BF16_MEAN:.3e}), every max within 2^-6 L: "
              f"{e.max_ok and e3.max_ok}; K6 vs plain mean|err|/L "
              f"{e6.mean:.3e} (limit {K6_BF16_MEAN:.3e}), old reading: "
              f"every max within 2^-6 L: {e6.max_ok} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"bf16 backward, {what}: disagrees with its plain version")
    # K6 with only its CLS block's w1 off a 16-byte boundary: every block
    # on the FMA bodies (the launch holds all of them to the tensor-core
    # bodies' alignment)
    bl = unaligned_w1(blocks)
    check(tensor_core_trunk(x, blocks, a["dh"])
          and not tensor_core_trunk(x, bl, a["dh"]), "K6 with the CLS "
          "block's w1 unaligned would take the tensor-core bodies")
    what = "flagship widths, the CLS block's w1 unaligned"
    e6 = k6_read(what, with_streams((x, dy3, bl, a["fn"], a["heads"],
                                     a["dh"], "rms")))
    ok = e6.mean <= K6_BF16_MEAN
    print(f"bf16 backward, {what}, FMA bodies: K6 vs plain mean|err|/L "
          f"{e6.mean:.3e} (limit {K6_BF16_MEAN:.3e}), old reading: every "
          f"max within 2^-6 L: {e6.max_ok} {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, "K6 with the CLS block's w1 unaligned disagrees with its plain "
          "version")
    # more frames for the per-frame rule, from a generator of their own
    own = rng.spawn(1)[0]
    for _ in range(K6_WIDTHS_EXTRA):
        b = train_inputs(nets["bfloat16"], K6_WIDTHS_BATCH, own)["actor"]
        for what, xs, bl, heads, dh, _ in width_cases(b):
            k6_read(what, with_streams((xs, b["dy3"], bl, b["fn"], heads,
                                        dh, "rms")))
        k6_read("flagship widths, the CLS block's w1 unaligned",
                with_streams((b["x"], b["dy3"], unaligned_w1(b["blocks"]),
                              b["fn"], b["heads"], b["dh"], "rms")))
    share = lambda errs: sum(f <= TRAIN_BF16_MEAN for f in errs) / len(errs)
    for what, names in by_case.items():
        print(f"K6 on the FMA bodies, {what}: dx frames within 2^-18 of the "
              "float64-sum version (each frame's own L): " + ", ".join(
                  f"{name} {share(errs):.3f}" for name, errs in names.items())
              + f" ({len(names['K6'])} frames)", flush=True)
    print("K6 on the FMA bodies, dx frames within 2^-18 of the float64-sum "
          "version on the batch's scale (phase 13's; a record): " + ", ".join(
              f"{name} {share(errs):.4f}"
              for name, errs in batch_scale.items()), flush=True)
    within = {name: share(errs) for name, errs in k6_frames.items()}
    n = len(k6_frames["K6"])
    se = math.sqrt(K6_WIDTHS_WITHIN * (1 - K6_WIDTHS_WITHIN) / n)
    verdict = {name: v >= K6_WIDTHS_WITHIN for name, v in within.items()}
    for name, v in within.items():
        print(f"K6 on the FMA bodies, {name}: dx frames within 2^-18 of the "
              f"float64-sum version (each frame's own L) {v:.4f} of {n} (at "
              f"least {K6_WIDTHS_WITHIN:g}), "
              f"{(v - K6_WIDTHS_WITHIN) / se:+.2f} "
              f"standard errors ({se:.4f}); " + (
                  "" if name == "plain" else "passes" if verdict[name]
                  else "fails"), flush=True)
    record("K6 widths", within=within, share=K6_WIDTHS_WITHIN, frames=n,
           verdict=verdict, by_case={w: {k: share(v) for k, v in c.items()}
                                     for w, c in by_case.items()},
           batch_scale={k: share(v) for k, v in batch_scale.items()})
    check(verdict["K6"], "K6 on the FMA bodies disagrees with the "
          "float64-sum version of its plain version (bf16, dx by frame)")
    for name in K6_WRONGS:
        check(not verdict[name], f"phase 5b's per-frame rule passes a wrong "
              f"backward ({name})")


# Phase 5c: the weight products of the backwards (wgrad_mma_kernel for
# bf16 where it takes the operands, else wgrad_kernel) against
# wgrad_plain, which sums the kernels' row segments in their order.
# (rows, K, N, row stride of A): the default update's at B=256 (K2b's
# four, then K3b's CLS operands, row 0 of each 65-row frame), then
# awkward ones: rows not a multiple of the 64-row chunk with K and N not
# multiples of 64, 2 x 32 heads' qkv at 81 tokens, K not a multiple of 8
# (the FMA kernel). Each also with A one element off a 16-byte boundary
# (the FMA kernel). Both sum in fp32 within a segment in another order,
# so bf16 results agree but for a flipped rounding now and then: phase
# 5's limits (each max 2^-6 L, pooled mean 2^-18); fp32 1e-5 L.
WGRAD_SHAPES = ((16640, 64, 768, 64), (16640, 256, 64, 256),
                (16640, 64, 2048, 64), (16640, 2048, 64, 2048),
                (256, 64, 256, 65 * 64), (256, 64, 2048, 64),
                (1000, 40, 96, 40), (2592, 64, 192, 64), (500, 36, 64, 36))
WGRAD_SEED = 8


def wgrad_work(rows, k, n, esize=2):
    """FLOPs and bytes of one weight product: A and B read once, C
    written once."""
    return 2 * rows * k * n, (rows * (k + n) + k * n) * esize


def product_times(fn, a, b) -> dict:
    """One weight product's time from CUDA events (`ms`; with the
    wrapper's host work, which bounds the small products) and from the
    profiler (`device_ms`, its kernels alone): `fn(a, b)` (the kernel's
    wrapper) beside `a.t() @ b` (`library_ms`, `library_device_ms`:
    cuBLAS with its sums kept in fp32, no reduced-precision split-K, as
    the kernels keep them)."""
    import torch

    flags = torch.backends.cuda.matmul
    keep = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        return dict(ms=cuda_ms(lambda: fn(a, b), 10, runs=5),
                    device_ms=device_ms(lambda: fn(a, b)),
                    library_ms=cuda_ms(lambda: a.t() @ b, 10, runs=5),
                    library_device_ms=device_ms(lambda: a.t() @ b))
    finally:
        flags.allow_bf16_reduced_precision_reduction = keep


def phase_weight_products():
    """Phase 5c: the weight products against their plain version, whose
    row segments (`wgrad_splits`) must be the library's; at the default
    update's shapes their times on the tensor cores beside the FMA
    kernel's (the same call with A unaligned), one PyTorch call for the
    same product (`a.t() @ b`, cuBLAS: fp32 sums, a bf16 result) and the
    bound. Its operands come from a generator of their own (WGRAD_SEED),
    so the later phases draw what they drew before this phase existed."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.ops.fused_transformer import (_block_lib,
                                                       weight_product,
                                                       wgrad_plain,
                                                       wgrad_splits)

    lib = _block_lib()
    for rows, k, n, _ in WGRAD_SHAPES:
        segs = (lib.weight_product_segments(rows, k, n),
                wgrad_splits(rows, k, n))
        check(segs[0] == segs[1], f"weight product {rows} x ({k}, {n}): the "
              f"library splits it into {segs[0]} row segments, wgrad_splits "
              f"into {segs[1]}")
    times, rng = {}, np.random.default_rng(WGRAD_SEED)
    for dtype in ("bfloat16", "float32"):
        dt, pooled = getattr(torch, dtype), TrainErrors()
        for rows, k, n, lda in WGRAD_SHAPES:
            base = torch.from_numpy(rng.standard_normal(
                rows * lda + 8).astype("float32")).to(DEVICE).to(dt)
            b = torch.from_numpy(rng.standard_normal((rows, n)).astype(
                "float32")).to(DEVICE).to(dt)
            for off in (0, 1):
                a = base[off:].as_strided((rows, k), (lda, 1))
                out, ref = weight_product(a, b), wgrad_plain(a, b)
                torch.cuda.synchronize()
                scale = ref.float().abs().max().item()
                mx = (out.float() - ref.float()).abs().max().item()
                what = (f"weight product {dtype} {rows} x ({k}, {n}), A "
                        f"{'un' if off else ''}aligned")
                if dtype == "float32":
                    check(mx <= TRAIN_F32_MAX * scale, f"{what}: max|err| "
                          f"{mx:.3e} over {TRAIN_F32_MAX:.0e} L")
                    continue
                e = TrainErrors()
                e.add([(out, ref)])
                pooled.add([(out, ref)])
                check(e.max_ok, f"{what}: max|err| {mx:.3e} over 2^-6 L")
                if rows in (SAC_BATCH * 65, SAC_BATCH) and off == 0:
                    bnd, by = bound_ms(*wgrad_work(rows, k, n), dtype)
                    times[f"{rows} x ({k}, {n})"] = dict(
                        **product_times(weight_product, a, b),
                        fma_ms=cuda_ms(lambda: weight_product(
                            base[1:].as_strided((rows, k), (lda, 1)), b),
                            3, runs=5),
                        bound_ms=bnd, bound_by=by)
        if dtype == "bfloat16":
            print(f"weight products bf16, {2 * len(WGRAD_SHAPES)} against "
                  f"wgrad_plain: pooled mean|err|/L {pooled.mean:.3e} "
                  f"(limit {TRAIN_BF16_MEAN:.3e}), every max within 2^-6 L:"
                  f" {pooled.max_ok}", flush=True)
            check(pooled.ok, "the bf16 weight products disagree with "
                  "wgrad_plain")
    print("weight products fp32: every max within 1e-5 L", flush=True)
    for shape, t in times.items():
        print(f"weight product bf16 {shape}: tensor cores {t['ms']:.4f} ms "
              f"(device {t['device_ms']:.4f}), FMA kernel {t['fma_ms']:.4f} "
              f"ms, a.t() @ b {t['library_ms']:.4f} ms (device "
              f"{t['library_device_ms']:.4f}), bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']})", flush=True)
    return times


@contextlib.contextmanager
def trunk_grad_switch():
    """The JAX package's opt-in switch, set while networks are built."""
    import os

    os.environ["DGVIT_TRUNK_GRAD"] = "1"
    try:
        yield
    finally:
        del os.environ["DGVIT_TRUNK_GRAD"]


def phase_sac(actor_flat, critic_flat, per_update=PER_UPDATE, label="SAC",
              guided=False):
    """Phases 6a, 14a and 18, main paths: 5 bf16 learn steps at B=256, or
    with `guided` 5 learn_guidence steps on B agent rows (every 16th
    engaged) and B expert rows (GUIDED_EXPERT valid), every step launching
    exactly `per_update`. Returns the launch counts of the run, the median
    update time, and a closure that runs one more update (for the
    profile)."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.config import Config

    cfg = Config.from_dict({"model": {"compute_dtype": "bfloat16"},
                            "sac": {"batch_size": SAC_BATCH}})
    agent = SACAgent(cfg, device=DEVICE, seed=SEED)
    check(agent.dtype == torch.bfloat16 and cfg.model.emb_dropout == 0.1,
          "the main path's agent is bf16 with emb-dropout 0.1")
    state = sac_state(agent, actor_flat, critic_flat)
    dev = lambda d: {k: torch.from_numpy(v).to(DEVICE) for k, v in d.items()}
    batch = golden_batch(seed=SEED, b=SAC_BATCH)
    if guided:
        batch["engage"] = (np.arange(SAC_BATCH) % 16 == 3).astype(
            np.float32)
        expert = dev(golden_batch(seed=SEED + 1, b=SAC_BATCH))
        update = lambda st: agent.learn_guidence(st, batch, expert,
                                                 GUIDED_EXPERT)
    else:
        update = lambda st: agent.learn(st, batch)
    batch = dev(batch)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    times = []
    for step in range(SAC_STEPS):
        before = {k: fn.launches for k, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = update(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        delta = {k: fn.launches - before[k] for k, fn in counters.items()}
        vals = {k: float(v) for k, v in m.items()}
        print(f"{label} step {step}: {times[-1] * 1e3:.2f} ms (host clock), "
              f"launches {delta}, " + ", ".join(
                  f"{k} {v:.5g}" for k, v in vals.items()), flush=True)
        check(all(math.isfinite(v) for v in vals.values()),
              f"non-finite {label} metrics at step {step}")
        check(delta == per_update, f"{label} step {step} launches {delta}, "
              f"expected {per_update}")
    launches = {k: fn.launches for k, fn in counters.items()}
    steady = statistics.median(times[1:])
    print(f"{label} bf16 B={SAC_BATCH}: {SAC_STEPS} updates, median of steps "
          f"1-{SAC_STEPS - 1} {steady * 1e3:.2f} ms = {1 / steady:.3f} "
          f"updates/s (host clock, synchronized); first step "
          f"{times[0] * 1e3:.2f} ms; launches over the run {launches}",
          flush=True)
    return launches, steady, lambda: update(state)


def phase_sac_fp32():
    """Phase 6b: one fp32 update through the kernels against the same
    update through the plain versions on the card and the JAX golden."""
    import numpy as np
    import torch

    g = np.load(GOLDEN_SAC)
    counters = kernel_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    kern = golden_update(DEVICE, g)
    check(all(counters[k].launches - before[k] == n
              for k, n in PER_UPDATE.items()), "the fp32 update did not go "
          "through the kernels")
    before = {k: fn.launches for k, fn in counters.items()}
    with plain_kernels():
        plain = golden_update(DEVICE, g)
    check(all(fn.launches == before[k] for k, fn in counters.items()),
          "the plain fp32 update launched a kernel")
    bad_g, worst_g = update_mismatches(kern, golden_ref(g))
    bad_p, worst_p = update_mismatches(kern, plain)
    gerr = max(((a - plain["grads"][n]).abs().max()
                / plain["grads"][n].abs().max().clamp(min=1e-30)).item()
               for n, a in kern["grads"].items())
    pmax = max((a - plain["params"][n]).abs().max().item()
               for n, a in kern["params"].items())
    print(f"SAC fp32 update through the kernels: largest relative "
          f"differences from the JAX golden {worst_g}, from the plain "
          f"versions on the card {worst_p}; grads max|err|/L vs plain "
          f"{gerr:.3e}; parameters vs plain: max|diff| {pmax:.3e}",
          flush=True)
    check(not bad_g, f"the fp32 update disagrees with the golden: {bad_g}")
    check(not bad_p, f"the fp32 update disagrees with the plain: {bad_p}")
    check(gerr <= SAC_RTOL, "the fp32 update's grads disagree")
    check(pmax <= 2.2e-3, "the fp32 update's parameters disagree")
    return {"vs_golden": worst_g, "vs_plain": worst_p}, kern


def phase_guided(actor_flat, critic_flat, plain_updates):
    """Phase 18, the expert-guided update (learn_guidence), main path:
    one fp32 guided update at the flagship width through the kernels,
    held to the JAX golden (GOLDEN_SAC_GUIDED) and to the same update
    through the plain versions on the card, as phase 6b holds learn; then
    5 bf16 guided updates at B=256 (B agent ++ B expert rows) on the
    default route and on the trunk-gradient route, each step's launches
    exactly PER_GUIDED / PER_GUIDED_TRUNK, its losses finite; the device
    time and host clock of an update beside the plain update's
    (`plain_updates`: {route: (host seconds, one-update closure)}), and
    one guided update of each route profiled by CUDA kernel. Returns the
    bf16 runs' launch counts and the times."""

    import numpy as np

    g = np.load(GOLDEN_SAC_GUIDED)
    counters = kernel_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    kern = golden_update(DEVICE, g, guided=True)
    check(all(counters[k].launches - before[k] == n
              for k, n in PER_GUIDED.items()), "the fp32 guided update did "
          "not go through the kernels")
    before = {k: fn.launches for k, fn in counters.items()}
    with plain_kernels():
        plain = golden_update(DEVICE, g, guided=True)
    check(all(fn.launches == before[k] for k, fn in counters.items()),
          "the plain fp32 guided update launched a kernel")
    bad_g, worst_g = update_mismatches(kern, golden_ref(g, GUIDED_METRICS))
    bad_p, worst_p = update_mismatches(kern, plain)
    gerr = max(((a - plain["grads"][n]).abs().max()
                / plain["grads"][n].abs().max().clamp(min=1e-30)).item()
               for n, a in kern["grads"].items())
    pmax = max((a - plain["params"][n]).abs().max().item()
               for n, a in kern["params"].items())
    print(f"guided fp32 update through the kernels: largest relative "
          f"differences from the JAX golden {worst_g}, from the plain "
          f"versions on the card {worst_p}; grads max|err|/L vs plain "
          f"{gerr:.3e}; parameters vs plain: max|diff| {pmax:.3e}",
          flush=True)
    check(not bad_g, f"the fp32 guided update disagrees with the golden: "
          f"{bad_g}")
    check(not bad_p, f"the fp32 guided update disagrees with the plain: "
          f"{bad_p}")
    check(gerr <= SAC_RTOL, "the fp32 guided update's grads disagree")
    check(pmax <= 2.2e-3, "the fp32 guided update's parameters disagree")

    out = {"fp32": {"vs_golden": worst_g, "vs_plain": worst_p}}
    for route, per, switch in (
            ("default", PER_GUIDED, contextlib.nullcontext),
            ("trunk-gradient", PER_GUIDED_TRUNK, trunk_grad_switch)):
        with switch():
            launches, host_s, one = phase_sac(
                actor_flat, critic_flat, per, f"guided SAC ({route})",
                guided=True)
        plain_s, plain_one = plain_updates[route]
        phase_profile(one, f"guided ({route} route) bf16")
        dev_ms, plain_dev_ms = device_ms(one, calls=3), device_ms(
            plain_one, calls=3)
        out[route] = dict(launches=launches, per_update=per,
                          host_ms=host_s * 1e3, device_ms=dev_ms,
                          plain_host_ms=plain_s * 1e3,
                          plain_device_ms=plain_dev_ms)
        print(f"guided update ({route} route, bf16, B={SAC_BATCH} agent + "
              f"{SAC_BATCH} expert rows, {GUIDED_EXPERT} valid): device "
              f"time {dev_ms:.2f} ms against the plain update's "
              f"{plain_dev_ms:.2f} ms ({dev_ms / plain_dev_ms:.2f}x); host "
              f"clock {host_s * 1e3:.2f} ms against {plain_s * 1e3:.2f} ms "
              f"(medians of steps 1-{SAC_STEPS - 1}; {card()})", flush=True)
    return out


def train_work(kind, batch, n=65, d=64, heads=4, dh=64, mlp=2048, depth=4,
               esize=2, records=False):
    """FLOPs and bytes a training kernel needs at the flagship width: each
    input read once, each output written once. The backward recomputes
    the forward and does two products per forward product (3x); K3 runs
    q, attention, out-proj and MLP on one row per frame. That is the
    function's own need, the bound of the kernel table. With `records`,
    the port's design instead: K3f also writes the CLS row's fp32 records
    (as under autograd, the main path's calls) and K3b reads them,
    recomputing only k and v."""
    from dgvit_tpu_torch.ops.cls_block import cls_saved_width

    inner = heads * dh
    record = batch * cls_saved_width(n, d, heads, dh, mlp) * 4
    w = d * 3 * inner + inner * d + 2 * d * mlp + mlp + 6 * d   # one block
    full = n * (2 * d * 3 * inner + 4 * heads * n * dh + 2 * inner * d
                + 4 * d * mlp)
    cls = (n * 2 * d * 2 * inner + 2 * d * inner + 4 * heads * n * dh
           + 2 * inner * d + 4 * d * mlp)
    rows = batch * n * d
    if kind == "K4":
        return (batch * ((depth - 1) * full + cls),
                (rows + batch * d + depth * w) * esize + 2 * d * 4)
    if kind == "K2f":
        return batch * full, (2 * rows + w) * esize
    if kind == "K2b":
        return 3 * batch * full, (3 * rows + 2 * w) * esize
    if kind == "K3f":
        return batch * cls, ((rows + batch * d + w) * esize
                             + (record if records else 0))
    if records:
        return (batch * (n * 2 * d * 2 * inner + 2 * cls),
                (2 * rows + batch * d + 2 * w) * esize + record)
    return 3 * batch * cls, (2 * rows + batch * d + 2 * w) * esize


def phase_train_times(nets, rng):
    """Phase 8b: each training kernel and its plain version at B=256, and
    K4 by depth (its CLS-only block alone, one full block before it) for
    the split of its time; the backwards (K2b, K3b) also by device time,
    split into the per-frame pass, the weight products (wgrad_kernel,
    wgrad_finish) and the vector finish; K3f also in its FMA kernel (an
    unaligned x)."""
    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import got_megakernel as gm

    reps = {"K4": 5, "K2f": 10, "K2b": 5, "K3f": 10, "K3b": 10}
    rows = {}
    inp = train_inputs(nets["bfloat16"], SAC_BATCH, rng)
    a = inp["actor"]
    by_depth = {depth: cuda_ms(lambda: gm.blocks_cls_forward_fused(
        a["x"], a["blocks"][-depth:], a["fn"], a["heads"], a["dh"], "rms"),
        10, runs=5) for depth in (1, 2)}
    print(f"K4 bf16 B={SAC_BATCH} by depth: the CLS-only block "
          f"{by_depth[1]:.4f} ms, one full block and the CLS block "
          f"{by_depth[2]:.4f} ms", flush=True)
    for name, kern, plain, _ in train_cases(inp):
        if name == "K3f":   # as the update calls it: keeping its records
            c = inp["critic"]
            kern = lambda: cb.cls_fwd_fused(c["last"], c["blocks"][-1],
                                            c["heads"], c["dh"], save=True)
        ms = cuda_ms(kern, reps[name], runs=5)
        pms = cuda_ms(plain, max(1, reps[name] // 2), runs=5)
        bnd, by = bound_ms(*train_work(name, SAC_BATCH), "bfloat16")
        rows[name] = dict(ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by)
        split = ""
        if name in ("K3f", "K3b"):   # the port's design: the CLS records
            rb, rby = bound_ms(*train_work(name, SAC_BATCH, records=True),
                               "bfloat16")
            rows[name].update(bound_with_records_ms=rb,
                              bound_with_records_by=rby)
            split = f"; bound with the CLS records {rb:.5f} ms ({rby})"
        if name == "K3f":   # its FMA kernel in this run: x unaligned
            c = inp["critic"]
            xu = off_by_one(c["last"])
            rows[name]["fma_ms"] = cuda_ms(lambda: cb.cls_fwd_fused(
                xu, c["blocks"][-1], c["heads"], c["dh"]), reps[name], runs=5)
            split += (f"; its FMA kernel (x unaligned) "
                      f"{rows[name]['fma_ms']:.4f} ms")
        if name in ("K2b", "K3b"):
            by_kernel = device_kernels_ms(kern, calls=20)
            part = lambda word: sum(t for k, t in by_kernel.items()
                                    if word in k)
            rows[name].update(pass_device_ms=part("bwd_kernel"),
                              products_device_ms=part("wgrad"),
                              finish_device_ms=part("vec_finish"))
            split += (f"; device time a call (torch.profiler): per-frame "
                      f"pass {part('bwd_kernel'):.4f} ms, weight products "
                      f"{part('wgrad'):.4f} ms, vector finish "
                      f"{part('vec_finish'):.4f} ms")
        print(f"{name} bf16 B={SAC_BATCH}: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, bound {bnd:.5f} ms ({by})"
              + (earlier(ms, FMA_DESIGN_MS[name])
                 if name in FMA_DESIGN_MS else "") + split, flush=True)
    return rows


# The CUDA kernels one bf16 update launches by design, counted by name in
# the profile (a name counts every kernel whose name holds it). Default:
# K4 x3, K2f x6 and K3f x2 on the tensor-core forward kernels (the FMA
# forms trunk_kernel and block_fwd_kernel launch nothing), K2b x6, K3b x2
# on the tensor-core CLS body (its FMA form cls_bwd_kernel<bf16, false>
# launches nothing),
# and behind them the 34 weight products on the tensor cores (the FMA
# wgrad_kernel launches nothing) with a finish each and the blocks' vector
# finishes. Trunk-gradient: K4 x5 on the tensor-core kernel, K6's
# per-frame pass x2, and behind K6 the 17 weight products of a trunk
# (3 x 4 + 5), on the tensor cores, with a finish each, the blocks' four
# vector finishes and the final norm's.
DEFAULT_CUDA_LAUNCHES = {
    "trunk_mma_kernel": 3, "trunk_kernel": 0, "block_fwd_mma_kernel": 6,
    "cls_fwd_mma_kernel": 2, "block_fwd_kernel": 0, "block_bwd_kernel": 6,
    "cls_bwd_kernel<__nv_bfloat16, true>": 2,
    "cls_bwd_kernel<__nv_bfloat16, false>": 0,
    "trunk_bwd_kernel": 0, "wgrad_mma_kernel": 34, "wgrad_kernel": 0,
    "wgrad_finish": 34, "vec_finish": 8}
TRUNK_CUDA_LAUNCHES = {
    "trunk_mma_kernel": 5, "trunk_kernel": 0, "block_fwd_mma_kernel": 0,
    "cls_fwd_mma_kernel": 0, "block_fwd_kernel": 0, "block_bwd_kernel": 0,
    "cls_bwd_kernel": 0,
    "trunk_bwd_kernel": 2, "wgrad_mma_kernel": 34, "wgrad_kernel": 0,
    "wgrad_finish": 34, "vec_finish": 10}


# spin kernels ahead of the update in each retried profile window
PROFILE_LEADS = (0, 97, 389)


def check_profile(update, want, label, profile_label="bf16", windows=3):
    """Hold a profiled update's CUDA launches (by kernel name) to the
    design; nothing to hold when the profiler recorded nothing.
    torch.profiler can lose a kernel's record from a window but never
    invents one (on an H100, one window of phase 16 once held 3 of the 4
    K7 launches that the wrapper's counter read for the same pass, and one
    run lost the same three records, a K7 and two PyTorch kernels about
    it, in each of three windows, which a fresh process did not repeat):
    a window that shows fewer launches than designed is profiled
    again, up to `windows` times, each retry with more spin kernels ahead
    of the update (PROFILE_LEADS), so that a loss at a fixed place in the
    window's records falls elsewhere; a kernel seen more often than
    designed (a wrong form taken) fails at once."""
    for window in range(1, windows + 1):
        seen = phase_profile(update, profile_label,
                             PROFILE_LEADS[(window - 1) % len(PROFILE_LEADS)])
        if seen is None:
            return
        got = {w: sum(c for k, c in seen.items() if w in k) for w in want}
        print(f"CUDA launches of one {label} update: {got}", flush=True)
        if got == want:
            return
        check(all(got[w] <= want[w] for w in want),
              f"a {label} update launched {got}, designed {want}")
        if window < windows:
            print(f"  profile window {window} recorded fewer launches "
                  f"than designed; profiling the {label} update again",
                  flush=True)
    check(False, f"a {label} update launched {got}, designed {want}, in "
          f"each of {windows} profile windows")


def phase_profile(update, label="bf16", lead=0):
    """Phases 7, 14c and 16: one bf16 update (or training pass) under
    torch.profiler: device time
    by CUDA kernel (returned as {kernel name: launches}, None when the
    profiler recorded nothing) and the device's busy share of the update's
    wall time. `lead` spin kernels (`torch.cuda._sleep`) run first in the
    window, before its clock starts; their records are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"
            and "spin_kernel" not in e.key]
    busy = sum(t for _, t, _ in rows) / 1e3
    if not rows:
        print("profile: no device time recorded (device busy share not "
              "measured)", flush=True)
        return None
    print(f"profile of one {label} update: wall {wall * 1e3:.2f} ms, device "
          f"kernels {busy:.2f} ms = busy share {busy / (wall * 1e3):.3f}",
          flush=True)
    for key, t, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {t / 1e3:9.3f} ms  x{count:<4d} {t / 1e3 / count:8.3f} ms "
              f"a call  {key[:80]}", flush=True)
    products = [(t, c) for k, t, c in rows if "wgrad" in k]
    print(f"  weight products (wgrad*, their finishes included): "
          f"{sum(t for t, _ in products) / 1e3:.3f} ms over "
          f"{sum(c for _, c in products)} launches", flush=True)
    return {key: count for key, _, count in rows}


# --------------------------------------------------------------------------
# the ingest slice: K5, camera to action, train and evaluate
# --------------------------------------------------------------------------

def camera_frames(n, seed):
    """`n` raw (512, 640) depth frames in metres and their polar goals, as
    a depth camera on the port's kinematic robot would send them: the env
    renders at the camera's own resolution while a seeded random walk
    drives it."""
    import numpy as np

    from dgvit_tpu_torch.envs import KinematicNavEnv

    env = KinematicNavEnv(seed=seed, image_hw=(512, 640))
    rng = np.random.default_rng(seed)
    frames, goals = [], []
    r = env.reset()
    state, goal, t = r.state, r.to_goal, 0
    while len(frames) < n:
        frames.append(state[..., 0] * env.CAM_CLIP[1])
        goals.append(goal[:2])
        s = env.step([float(rng.uniform(0.1, 0.5)),
                      float(rng.uniform(-1.0, 1.0))], t)
        state, goal, t = s.state, s.to_goal, t + 1
        if s.done or t >= 12:
            r = env.reset()
            state, goal, t = r.state, r.to_goal, 0
    return (np.stack(frames).astype(np.float32),
            np.stack(goals).astype(np.float32))


def wrong_chain(raw, seed, sigma, fault):
    """K5's plain chain with one fault: 'image-edge reflect' blurs the
    whole image with the 11-tap kernel and pastes the band's rows, so the
    blur reflects into the image instead of at the band's own edges;
    'round' rounds where the normalisation truncates."""
    import torch

    from dgvit_tpu_torch.ops import fused_preprocess as fp
    from dgvit_tpu_torch.ops import preprocess as pp

    x = raw.float()
    if fault == "round":
        lo = x.amin(dim=(-2, -1), keepdim=True)
        hi = x.amax(dim=(-2, -1), keepdim=True)
        x = torch.clamp(torch.round((x - lo) * (x.new_tensor(255.0)
                        / torch.clamp(hi - lo, min=1e-20))), 0.0, 255.0)
    else:
        x = pp.normalize_depth_f32(x)
    if sigma > 0.0:
        seeds = seed + torch.arange(x.shape[0], device=x.device)
        x = torch.clamp(x + sigma * fp.irwin_hall_noise(seeds, 512, 640),
                        0.0, 255.0)
    x = pp.gaussian_blur(x, 5)
    if fault == "image-edge reflect":
        y1, y2 = pp.center_band(512)
        x = torch.cat([x[:, :y1], pp.gaussian_blur(x, 11)[:, y1:y2],
                       x[:, y2:]], dim=1)
    else:
        x = pp.band_blur(x, 11)
    x = pp.resize_bilinear(x, (128, 160))
    return x / x.new_tensor(255.0)     # a tensor: a true division on CUDA


def phase_k5(rng):
    """Phase 9: K5 against its plain version, its wrong chains and its
    noise."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.ops import fused_preprocess as fp
    from dgvit_tpu_torch.ops import preprocess as pp

    dev = torch.device(DEVICE)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        dev)
    uniform = up(rng.uniform(0.3, 8.0, (max(K5_BATCHES), 512, 640)))
    cases = [(f"uniform B={b}", uniform[:b].contiguous()) for b in K5_BATCHES]
    constant = torch.full((1, 512, 640), 3.25, device=dev)
    cases += [
        ("env frames B=8", up(camera_frames(8, SEED)[0])),
        ("constant B=1", constant),
        ("extreme range B=2", up(rng.uniform(-1e30, 1e30, (2, 512, 640)))),
    ]
    worst = 0.0
    for name, raw in cases:
        for sigma in K5_SIGMAS:
            out = fp.preprocess_depth_fused(raw, SEED, sigma)
            torch.cuda.synchronize()
            ref = fp.preprocess_depth_plain(raw, SEED, sigma)
            check(out.shape == ref.shape == (raw.shape[0], 128, 160)
                  and out.dtype == torch.float32, f"K5 output shape ({name})")
            check(bool(torch.isfinite(out).all()) and out.min().item() >= 0.0
                  and out.max().item() <= 1.0,
                  f"K5 output outside [0, 1] ({name}, sigma {sigma})")
            err = (out - ref).abs()
            mx = err.max().item()
            step = (err > 1e-4).float().mean().item()
            print(f"K5 vs plain {name} sigma={sigma:g}: max|err| {mx:.3e}, "
                  f"share of states off by a u8 step's worth (> 1e-4) "
                  f"{step:.3e}, off at all {(err > 0).float().mean().item():.3e}"
                  f" {'ok' if mx <= K5_MAX else 'FAIL'}", flush=True)
            check(mx <= K5_MAX, f"K5 disagrees with its plain version "
                  f"({name}, sigma {sigma})")
            worst = max(worst, mx)
    check(fp.preprocess_depth_fused(constant, 0, 0.0).abs().max().item()
          == 0.0, "a constant frame must give zeros")

    raw = uniform[:3].contiguous()
    for fault in ("image-edge reflect", "round"):
        for sigma in K5_SIGMAS:
            out = fp.preprocess_depth_fused(raw, SEED, sigma)
            err = (out - wrong_chain(raw, SEED, sigma, fault)).abs()
            right = (out - wrong_chain(raw, SEED, sigma, None)).abs()
            print(f"  wrong chain ({fault}) sigma={sigma:g}: max|err| "
                  f"{err.max().item():.3e}, states over 1e-4 "
                  f"{(err > 1e-4).float().mean().item():.3e} (the same "
                  f"code without the fault: {right.max().item():.3e})",
                  flush=True)
            check(right.max().item() <= K5_MAX, "the chain the wrong "
                  "versions are made from is not K5's plain version")
            check(err.max().item() > K5_MAX,
                  f"K5's limit passes a wrong chain ({fault})")

    # noise: statistics against the chain with torch.randn noise, and the
    # generator's contract
    raw = uniform[:32].contiguous()
    out = fp.preprocess_depth_fused(raw, 7, 50.0)
    gen = torch.Generator(dev).manual_seed(7)
    ref = pp.preprocess_depth(raw, gen, noise_level=50.0)
    d_mean = abs(out.mean().item() - ref.mean().item())
    d_std = abs(out.std().item() - ref.std().item())
    again = fp.preprocess_depth_fused(raw, 7, 50.0)
    other = fp.preprocess_depth_fused(raw, 8, 50.0)
    alone = fp.preprocess_depth_fused(raw[5:6].contiguous(), 7 + 5, 50.0)
    print(f"K5 noise at sigma 50, 32 frames: mean {out.mean().item():.5f} vs "
          f"randn chain {ref.mean().item():.5f}, std {out.std().item():.5f} "
          f"vs {ref.std().item():.5f}; same seed equal "
          f"{torch.equal(out, again)}, next seed equal "
          f"{torch.equal(out, other)}, frame 5 alone with seed + 5 equal "
          f"{torch.equal(alone[0], out[5])}", flush=True)
    check(d_mean <= K5_NOISE_STATS and d_std <= K5_NOISE_STATS,
          "K5's noise statistics differ from the randn chain's")
    check(torch.equal(out, again), "K5 is not deterministic for a seed")
    check(not torch.allclose(out, other), "K5's seeds give the same noise")
    check(not torch.allclose(out[0], out[1]), "K5's frames share their noise")
    check(torch.equal(alone[0], out[5]), "K5: frame alone != frame in batch")
    # seed + 1 shifts the frames' streams by one
    check(torch.equal(other[4], fp.preprocess_depth_fused(
        raw[4:5].contiguous(), 12, 50.0)[0]), "K5: seed + frame")
    return worst


def phase_camera(cfg, flat, k5_per_call):
    """Phase 10, a main path: raw camera frames to velocity commands. K5's
    wrapper launches once, and (phase 1's profile, `k5_per_call`) one
    CUDA kernel a call."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.ops import preprocess_depth_auto
    from dgvit_tpu_torch.ops.fused_preprocess import preprocess_depth_plain
    from dgvit_tpu_torch.ops.got_megakernel import got_forward_plain
    from dgvit_tpu_torch.serve import make_action_fn

    frames, goals = camera_frames(CAMERA_FRAMES, CAMERA_SEED)
    raw = torch.from_numpy(frames).to(DEVICE)
    act = make_action_fn(cfg, flat, env_units=True, device=DEVICE)   # bf16
    act(preprocess_depth_auto(raw, CAMERA_SEED, 50.0), goals)        # warm
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = preprocess_depth_auto(raw, CAMERA_SEED, 50.0)
    cmd = act(states, goals)
    elapsed = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}

    e = cfg.env
    with torch.no_grad():
        ref_states = preprocess_depth_plain(raw, CAMERA_SEED, 50.0)
        pol = act.policy
        gl = torch.from_numpy(goals).to(DEVICE)
        lat = got_forward_plain(*pol.trans.trunk_args(ref_states,
                                                      pol.fc_embed(gl)))
        a = torch.clamp(torch.tanh(pol.from_latent(lat)[0]).float(),
                        -e.max_action, e.max_action)
        ref = torch.stack([(a[:, 0] + 1.0) * e.linear_cmd_scale,
                           a[:, 1] * e.angular_cmd_scale], dim=1).cpu().numpy()
    worst = np.abs(cmd - ref).max()
    print(f"camera to action: {CAMERA_FRAMES} raw frames -> commands in "
          f"{elapsed * 1e3:.2f} ms (host clock, synchronized by the copy "
          f"back); launches {launches}; linear in [{cmd[:, 0].min():.3f}, "
          f"{cmd[:, 0].max():.3f}] m/s, angular in [{cmd[:, 1].min():.3f}, "
          f"{cmd[:, 1].max():.3f}] rad/s; max|command - plain path| "
          f"{worst:.3e}", flush=True)
    check(cmd.shape == (CAMERA_FRAMES, 2) and bool(np.isfinite(cmd).all()),
          "camera to action: shape or non-finite commands")
    check(bool((cmd[:, 0] >= 0).all()
               and (cmd[:, 0] <= 2 * e.linear_cmd_scale).all()
               and (np.abs(cmd[:, 1]) <= e.angular_cmd_scale).all()),
          "camera to action: commands outside the robot's range")
    check(worst <= ACTION_BF16, "camera to action: kernels vs plain path")
    want = {k: int(k in ("K5", "K1")) for k in counters}
    check(launches == want, f"camera to action launched {launches}, "
          f"expected {want}")
    print("camera to action: K5's CUDA launches a call of its wrapper "
          + ("not measured (phase 1's profile recorded nothing)"
             if k5_per_call is None else f"{k5_per_call:g} (phase 1)"),
          flush=True)
    check(k5_per_call in (None, 1), "K5 launches more than one CUDA kernel "
          "a call")
    return launches


class FakeTeleop:
    """A human-intervention source for the trainer (`train`'s
    `intervention`): engaged every other env step (the trainer asks once a
    step), one fixed [linear, angular] command."""

    def __init__(self):
        self.asked = self.reads = 0

    @property
    def engaged(self):
        self.asked += 1
        return self.asked % 2 == 0

    def read_action(self):
        self.reads += 1
        return [0.3, 0.2]


def phase_train(out_dir):
    """Phase 11, a main path: the env-in-the-loop trainer at the flagship
    width, resume, the saved actor, and the evaluator; then the guided
    trainer: an expert buffer of demos the port records itself
    (train.pre_buffer), and human intervention from a fake teleop with no
    expert buffer, every update through learn_guidence."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.core.checkpoint import (latest_checkpoint,
                                                 load_params_npz)
    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.replay import (BatchPrefetcher, ReplayBuffer,
                                        reference_schema)
    from dgvit_tpu_torch.serve import make_action_fn
    from dgvit_tpu_torch.train.demo_record import (record_episodes,
                                                   scripted_pilot)
    from dgvit_tpu_torch.train.evaluate import run_eval
    from dgvit_tpu_torch.train.train_rl import train

    cfg = Config.from_dict({
        "model": {"compute_dtype": "bfloat16"},
        "sac": {"batch_size": SAC_BATCH, "buffer_size": TRAIN_BUFFER},
        "env": {"max_steps": TRAIN_MAX_STEPS},
        "train": {"seed": SEED, "pre_buffer": False, "plot_interval": 10 ** 6,
                  "reward_threshold": 1e9}})
    m = cfg.model
    check((m.block, m.head, m.dim_head, m.mlp_dim, m.latent_size,
           tuple(m.image_size)) == (4, 4, 64, 2048, 64, (128, 160)),
          "the trainer's model is not the flagship")
    counters = kernel_counters()

    def drive(cfg, out_dir, label, per_update=PER_UPDATE,
              episodes=TRAIN_EPISODES, min_updates=50, **kw):
        """`train` from the seed for `episodes` episodes, with its launch
        counts (`per_update` an update), metrics and the split of its loop
        checked."""
        for fn in counters.values():
            fn.launches = 0
        timings = {}
        env = KinematicNavEnv(seed=SEED, world="rrc")
        t0 = time.perf_counter()
        out = train(cfg, env, out_dir=out_dir, max_episodes=episodes,
                    device=DEVICE, timings=timings, **kw)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        steps, updates = timings["env_steps"], timings["updates"]
        print(f"train ({label}): {out['episodes']} episodes, {steps} env "
              f"steps, {updates} updates in {wall:.2f} s (host clock); "
              f"launches {launches}", flush=True)
        check(updates >= min_updates and out["state"].itera == updates,
              f"the trainer ({label}) took {updates} updates, expected at "
              f"least {min_updates}")
        want = {**{k: n * updates for k, n in per_update.items()},
                "K1": steps}
        check(launches == want, f"train ({label}) launched {launches}, "
              f"expected {want}: every action K1 x1, every update "
              f"{per_update}")
        rows = [json.loads(line) for line in
                (Path(out_dir) / "train_gtrl_98.jsonl").read_text()
                .splitlines()]
        check(len(rows) == out["episodes"] and all(
            math.isfinite(v) for r in rows for v in r.values()
            if isinstance(v, float)),
            f"non-finite training metrics ({label})")
        check("qf1_loss" in rows[-1],
              f"the last episode logged no SAC metrics ({label})")
        loop = sum(timings[k] for k in ("env", "act", "sample", "learn"))
        print(f"train loop ({label}): {steps / loop:.2f} env steps/s, "
              f"{updates / loop:.3f} updates/s over the loop's {loop:.2f} s; "
              f"per env step: env {timings['env'] / steps * 1e3:.3f} ms, act "
              f"{timings['act'] / steps * 1e3:.3f} ms; per update: "
              f"sample+copy {timings['sample'] / updates * 1e3:.3f} ms, "
              f"learn {timings['learn'] / updates * 1e3:.3f} ms (host clock, "
              f"synchronized); last episode: " + ", ".join(
                  f"{k} {v:.5g}" for k, v in rows[-1].items()
                  if k not in ("step", "wall_s")), flush=True)
        return out, launches, {"env_steps_per_s": steps / loop,
                               "updates_per_s": updates / loop}

    out, launches, rates = drive(cfg, out_dir, "serial batches")
    state, updates = out["state"], out["state"].itera

    # the saved actor reloads through the flat npz and acts the same
    agent = SACAgent(cfg, device=DEVICE, seed=SEED)
    saved = sorted((Path(out_dir) / "models").glob("*_actor.npz"))
    check(len(saved) == 1, f"saved actors: {saved}")
    act = make_action_fn(cfg, load_params_npz(str(saved[0])), device=DEVICE)
    obs, goal = golden_inputs()
    with torch.no_grad():
        direct = agent.act_batch(state.actor, obs, goal,
                                 evaluate=True).float().cpu().numpy()
    adiff = np.abs(act(obs, goal) - direct).max()
    print(f"saved actor {saved[0].name}: reloaded actions differ from the "
          f"train state's by {adiff:.3e}", flush=True)
    check(adiff == 0.0, "the saved actor does not act as the trained one")

    # a checkpoint was written; resume restores it, and the next update
    # equals the one taken without the restart
    latest = latest_checkpoint(str(Path(out_dir) / "checkpoints"))
    check(latest is not None and latest.endswith(f"step_{updates}"),
          f"no checkpoint of step {updates}: {latest}")
    resumed = train(cfg, KinematicNavEnv(seed=SEED, world="rrc"),
                    out_dir=out_dir, max_episodes=0, resume=True,
                    device=DEVICE)["state"]
    check(resumed is not state and resumed.itera == updates,
          "resume did not restore the update counter")
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             golden_batch(seed=SEED + 1, b=SAC_BATCH).items()}
    _, m1 = agent.learn(state, batch)
    _, m2 = agent.learn(resumed, batch)
    diff = max(abs(float(m1[k]) - float(m2[k])) for k in m1)
    pdiff = max((a - b).abs().max().item()
                for kind in ("actor", "critic", "critic_target")
                for a, b in zip(getattr(state, kind).parameters(),
                                getattr(resumed, kind).parameters()))
    print(f"resume: the next update's metrics differ by {diff:.3e}, the "
          f"parameters after it by {pdiff:.3e}", flush=True)
    check(diff == 0.0 and pdiff == 0.0,
          "the update after resume differs from the one without a restart")

    # the prefetcher on the card: a background thread samples into pinned
    # memory and copies on a side stream. Its batches are the rows the
    # buffer's own sampler gives, and `train` with `sac.prefetch_batches`
    # takes the same run from the same seed: the same launches per action
    # and per update, its own split of the loop.
    rows = {k: v[:, 0] if v.shape[1:] == (1,) else v for k, v in
            golden_batch(seed=SEED + 2, b=300).items()}

    def filled(seed):
        buf = ReplayBuffer(512, reference_schema(), seed=seed)
        buf.add(**rows, engage=np.zeros(300, np.float32))
        return buf

    def take(buf):
        return {k: v for k, v in buf.sample(SAC_BATCH).items()
                if k != "engage"}

    ours, twin = filled(SEED), filled(SEED)
    pf = BatchPrefetcher(lambda: take(ours), device=DEVICE)
    try:
        for _ in range(4):
            got, want = next(pf), take(twin)
            check(all(got[k].is_cuda and torch.equal(
                got[k].cpu(), torch.from_numpy(want[k])) for k in want),
                "a prefetched batch is not the sampler's batch")
    finally:
        pf.close()
    cfg.sac.prefetch_batches = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as prefetch_dir:
        _, _, prefetch_rates = drive(cfg, prefetch_dir, "prefetched batches")
    cfg.sac.prefetch_batches = False
    check(not [t for t in threading.enumerate()
               if t.name == "BatchPrefetcher"],
          "train left its prefetch thread running")

    # the guided trainer: demos the port records (the scripted pilot, in
    # policy units), an expert buffer of them, and every update guided;
    # then human intervention alone, on an all-masked expert batch
    demo_env = KinematicNavEnv(seed=SEED + 3, world="rrc")
    e = cfg.env
    demos = record_episodes(
        demo_env, scripted_pilot, str(Path(out_dir) / "Data"),
        episodes=DEMO_EPISODES, max_steps=TRAIN_MAX_STEPS,
        action_to_env=lambda a: [(a[0] + 1) * e.linear_cmd_scale,
                                 a[1] * e.angular_cmd_scale])
    check(bool(demos), "the recorder wrote no demo")
    cfg.train.pre_buffer = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as guided_dir:
        _, guided_launches, guided_rates = drive(
            cfg, guided_dir, "expert buffer", PER_GUIDED,
            expert_glob=str(Path(out_dir) / "Data" / "RRC" / "torch"
                            / "*.npz"))
    cfg.train.pre_buffer = False
    cfg.train.human_intervention = True
    tele = FakeTeleop()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tele_dir:
        _, tele_launches, tele_rates = drive(
            cfg, tele_dir, "human intervention", PER_GUIDED,
            INTERVENTION_EPISODES, INTERVENTION_UPDATES, intervention=tele)
    cfg.train.human_intervention = False
    print(f"human intervention: the teleop engaged on {tele.reads} of "
          f"{tele.asked} env steps", flush=True)
    check(tele.reads > 0, "the trainer never read the teleop")

    cfg.env.max_steps = EVAL_MAX_STEPS
    for fn in counters.values():
        fn.launches = 0
    eval_env = KinematicNavEnv(seed=SEED + 1, world="rrc")
    t0 = time.perf_counter()
    rep = run_eval(cfg, eval_env, load_params_npz(str(saved[0])),
                   max_episodes=EVAL_EPISODES, out_dir=out_dir,
                   name=saved[0].name, device=DEVICE)
    eval_s = time.perf_counter() - t0
    k1 = counters["K1"].launches
    print(f"run_eval: {EVAL_EPISODES} episodes, {k1} steps in {eval_s:.2f} s"
          f" = {k1 / eval_s:.1f} steps/s (host clock, the actor's set-up included); "
          f"{rep}", flush=True)
    check(k1 >= EVAL_EPISODES and all(
        fn.launches == 0 for k, fn in counters.items() if k != "K1"),
        "run_eval did not act through K1 alone")
    check(0.0 <= rep["success_rate"] <= 1.0 and rep["collisions"] >= 0
          and (Path(out_dir) / "testing_data.txt").exists(),
          "run_eval's report")
    return (launches, {**rates, "prefetch": prefetch_rates,
                       "expert_buffer": guided_rates,
                       "human_intervention": tele_rates},
            {"expert_buffer": guided_launches,
             "human_intervention": tele_launches})


def k5_work(batch, sigma):
    """The least operations and bytes the function needs for `batch`
    frames, whatever kernel computes it. Every pixel is behind some state
    (a sampled row or column 4i+1, 4i+2 with the 5-tap halo reaches all of
    them), so each takes 2 for the frame's min and max, 5 to normalise
    (subtract, scale, floor, two clips) and, with noise, 20: one operation
    for each of the three random words (the least any generator spends),
    11 to add their 12 bytes, 2 for z, 2 for x + sigma z, 2 clips. A k-tap
    pass costs 2k - 1 an output (k products, k - 1 sums) and runs only
    where a state reads it: outside the band the 5-tap pass down the rows
    on the 204 sampled rows, then along them at the sampled half of the
    columns; in the band both 5-tap passes on all 102 rows (the 11-tap
    pass down the rows reads every one), then the 11-tap passes on the 52
    sampled rows and at the sampled columns of those. 10 per state for
    the bilinear average and the division. Integer operations are counted
    at the fp32 rate. Each frame is read once, each state written once."""
    px, outs = 512 * 640, 128 * 160
    band, sampled_band, sampled_rest = 102, 52, 256 - 52
    taps5 = 9 * ((sampled_rest + band) * 640
                 + sampled_rest * 320 + band * 640)
    taps11 = 21 * (sampled_band * 640 + sampled_band * 320)
    ops = px * (7 + (20 if sigma > 0 else 0)) + taps5 + taps11 + outs * 10
    return batch * ops, batch * (px + outs) * 4


def phase_k5_times(rng):
    """Phase 12: K5 and its plain version, sigma 50, beside the bound and
    the two-launch design's recorded time (REPLACED_MS)."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.ops import fused_preprocess as fp

    ranks, smem_bytes, clusters = fp.kernel_occupancy()
    print(f"K5 on {card()}: {smem_bytes} bytes of shared memory a CTA, "
          f"clusters of {ranks} CTAs the card holds at once: "
          + ("not measured (the query failed)" if clusters is None
             else str(clusters)), flush=True)
    raw = torch.from_numpy(rng.uniform(0.3, 8.0, (256, 512, 640)).astype(
        np.float32)).to(DEVICE)
    rows = {}
    for batch, reps in K5_TIMED:
        x = raw[:batch].contiguous()
        ms = cuda_ms(lambda: fp.preprocess_depth_fused(x, SEED, 50.0), reps,
                     runs=5)
        plain = cuda_ms(lambda: fp.preprocess_depth_plain(x, SEED, 50.0), 1,
                        runs=5)
        ops, nbytes = k5_work(batch, 50.0)
        bnd, by = bound_ms(ops, nbytes, "float32")
        rows[batch] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)
        was = REPLACED_MS["K5"][batch]
        print(f"K5 fp32 B={batch} sigma=50 ({card()}): kernel {ms:.4f} ms, "
              f"bound {bnd:.5f} ms ({by}: operations "
              f"{ops / PEAK_FLOPS['float32'] * 1e3:.5f} ms, bytes "
              f"{nbytes / PEAK_BYTES * 1e3:.5f} ms; {bnd / ms:.3f} of it), "
              f"two-launch design {was:.4f} ms (recorded, not this run; "
              f"now {was / ms:.2f}x faster), plain {plain:.4f} ms, "
              f"{batch / ms * 1e3:.0f} frames/s", flush=True)

    return rows


def k5_cuda_kernels():
    """The CUDA kernels behind K5's wrapper, from torch.profiler over
    K5_PROFILED calls at B=CAMERA_FRAMES: one launch of
    preprocess_cluster_kernel a call and nothing else (returned as the
    launches a call, None when the profiler recorded nothing), with its
    device time a call. It runs first, before any SAC update: once an
    update has run in the process, an H100 gave back windows of a few
    launches with their first device events missing, or with none. As in
    check_profile, a window that holds only K5's kernel, fewer times than
    called, is profiled again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dgvit_tpu_torch.ops import fused_preprocess as fp

    x = torch.rand((CAMERA_FRAMES, 512, 640), device=DEVICE) * 8.0
    fp.preprocess_depth_fused(x, SEED, 50.0)
    torch.cuda.synchronize()
    ours = "preprocess_cluster_kernel"
    for window in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(K5_PROFILED):
                fp.preprocess_depth_fused(x, SEED, 50.0)
            torch.cuda.synchronize()
        seen = {(ours if f"{ours}(" in e.key else e.key):
                (e.count, e.device_time_total / 1e3)
                for e in prof.key_averages()
                if e.device_time_total > 0 and e.device_type.name == "CUDA"}
        if set(seen) != {ours} or seen[ours][0] >= K5_PROFILED:
            break
        print(f"K5's profile window {window} recorded {seen[ours][0]} of "
              f"{K5_PROFILED} launches", flush=True)
    if not seen:
        print("K5's CUDA kernels: no device events recorded (not measured)",
              flush=True)
        return None
    print(f"K5's CUDA kernels in {K5_PROFILED} calls of the wrapper at B="
          f"{CAMERA_FRAMES} (torch.profiler): " + ", ".join(
              f"{k} x{c}, {t / c:.4f} ms device time a launch"
              for k, (c, t) in seen.items()), flush=True)
    counts = {k: c for k, (c, _) in seen.items()}
    check(counts == {ours: K5_PROFILED},
          f"K5's wrapper should launch {ours} once a call and nothing else,"
          f" the profiler saw {counts}")
    return counts[ours] / K5_PROFILED

# --------------------------------------------------------------------------
# the attention slice: K6 (whole-trunk backward), K7 (attention section),
# K8 (attention), the trunk-gradient update and the composed routes
# --------------------------------------------------------------------------

K6_BATCHES = (1, 3, 8, 256)
K6_SMALL_N = 17            # a smaller token count (a 32x80 frame's)
K6_DEPTH = 4
GRAD_NAMES = ("an_s", "an_b", "wqkv", "wout", "bout", "fn_s", "fn_b", "w1",
              "b1", "w2", "b2")
# the chain's share rule counts dx frames over K6_BATCHES' bf16 cases and
# CHAIN_EXTRA more draws of CHAIN_EXTRA_BATCH frames (see CHAIN_WITHIN)
CHAIN_EXTRA, CHAIN_EXTRA_BATCH = 7, 256
CHAIN_TENSOR_K = 2.0
# K6 against its plain version and against the chain of per-block kernels,
# per tensor as in phase 5, with L the plain tensor's largest |value|.
# K6 runs no forward: it differentiates the streams K4 wrote (fault j's
# repair), and K6, its plain version, the float64-sum version and the
# wrong backwards that read streams (dx kept in fp32) are all given the
# same streams, those of K4's route on the card (with_streams). So they
# differ only in the backward's own sums and rounding points. Autograd of
# the plain forward runs its own forward, and the K3b + K2b chain takes
# the streams of K2f and K3f, as the default route does.
# fp32: another summation order through four blocks' backward; held to
# the float64-sum version (EXACT_K, fault 3f): max |err| <= max(1e-3 L,
# 2 x the plain version's distance).
# bf16: each tensor's max <= 2^-6 L, as in phase 5, printed and not held
# (fault 3g: the per-frame rule below). The pooled mean against the plain
# version, all cases pooled, <= 2^-13, cannot see a wrong rounding point
# (the two wrong backwards pool 6e-5 to 8e-5), so the sharp check is per
# frame: the mean of |err| / L over one frame's dx, next to nothing for a
# frame where no rounding flipped and about 1e-5 for the median frame of
# a wrong backward. Against the plain version, with L the batch's
# largest |dx|, K6_FRAMES_WITHIN of the frames of all bf16 cases must lie
# within phase 5's pooled limit 2^-18; against the float64-sum version,
# with L each frame's own largest |dx| (as phase 5b; the batch's scale is
# printed beside as a record), CHAIN_WITHIN of them (K6 and the chain).
# Both wrong backwards must fall short of both lines. See EXACT_K for the
# readings.
K6_F32_MAX = 1e-3
K6_BF16_MEAN = 2.0 ** -13
K6_FRAMES_WITHIN = 2 / 3
# K7 and K8 against their plain versions: fp32 max |err| <= 1e-5 L; bf16
# max <= 2^-6 L and the pooled mean of |err| / L <= 2^-18 (phase 5's
# limits: the same rounding points, rare flips; an H100 read 7e-9 for K7;
# the bf16 K8, its probabilities split into bf16 hi + lo halves on the
# tensor cores, read 1.8e-7 on an H100 80GB HBM3 at 700 W, where its
# probabilities rounded to bf16 once fail, as tests/test_torch_attention.py
# shows). The backwards recompute the plain version, so they are held to
# the same limits against autograd of the plain version (read 0).
ATTN_SHAPES = ((256, 4, 65, 64), (64, 4, 257, 64), (8, 2, 65, 160))
SECTION_SHAPES = ((256, 65), (8, 256))          # (B, n) at d 64, 4 x 64
# The composed routes through the model. fp32, the sharp checks: the K7
# route against the same pass composed in PyTorch, means within 1e-4 L
# (read 2.1e-6 of 3.6) and every gradient within 1e-3 L (read 2.4e-5);
# the K8 route's actions within 1e-4 of the composition's (read 0) and of
# the fused K1 route's (read 2.6e-6: summation order and the erf
# polynomial). bf16: kernel and composition round at different points
# (K7 and K8 keep fp32 where the composition rounds every operation), and
# the trained actor's activations reach 1e4, so means agree to 2^-4 L
# (read 1.1e-2 to 1.7e-2 L) and actions to 2^-4 (read 1.3e-2); the
# composed and the fused bf16 models differ by their whole bf16 model
# error (the composed stream stays bf16, its GELU is the erf form):
# actions within 2^-2 (read 2.7e-2 and 7.0e-2 on two draws of frames).
COMPOSED_BF16, COMPOSED_FP32 = 2.0 ** -4, 1e-4
COMPOSED_BF16_VS_FUSED, COMPOSED_FP32_GRAD = 2.0 ** -2, 1e-3
# The fp32 trunk-gradient update against the default-route update from
# the same state: the same kernel bodies in another launch, the final
# norm's backward by hand instead of autograd; held to phase 6b's limits
# (an H100 read metrics equal, grads 2.3e-5 L, parameters 3.5e-4).


def trunk_autograd_bwd(x, dy, blocks, fn, heads, dim_head, final_norm,
                       streams=None):
    """A wrong bf16 trunk backward: autograd of K4's plain forward, which
    rounds gradients wherever the forward casts (on the streams of its own
    forward; `streams` is not read)."""
    import torch

    from dgvit_tpu_torch.ops.got_megakernel import blocks_forward_plain

    xr = x.detach().requires_grad_()
    wr = [[t.detach().requires_grad_() for t in w] for w in blocks]
    fr = [t.detach().requires_grad_() for t in fn]
    leaves = [xr, *[t for w in wr for t in w], *fr]
    gs = torch.autograd.grad(
        blocks_forward_plain(xr, wr, fr, heads, dim_head, final_norm),
        leaves, dy, allow_unused=True)
    gs = [torch.zeros_like(t) if g is None else g
          for g, t in zip(gs, leaves)]
    n = 1 + 11 * len(blocks)
    return (gs[0], tuple(tuple(gs[i:i + 11]) for i in range(1, n, 11)),
            tuple(gs[n:]))


def trunk_fp32_dx_bwd(x, dy, blocks, fn, heads, dim_head, final_norm,
                      streams=None):
    """A wrong bf16 trunk backward: `trunk_bwd_plain`'s chain with dx
    handed from block to block in fp32 instead of the compute dtype, on
    the streams given (recomputed when None). The block backwards return
    dx rounded, so the fp32 dx is put together from its parts: dy + the
    two LayerNorm backwards' input gradients, which a wrapper around
    `_ln_bwd` keeps."""
    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops.trunk_train import (final_norm_bwd_plain,
                                                 trunk_streams_plain)

    cdt = x.dtype
    if streams is None:
        streams = trunk_streams_plain(x, blocks, heads, dim_head)
    xs = [x, *streams[0]]
    cls = streams[1].float()
    dcls, dfs, dfb = final_norm_bwd_plain(dy.float(), cls, fn[0], fn[1],
                                          final_norm)
    kept, real = [], ft._ln_bwd

    def keeping(*args):
        out = real(*args)
        kept.append(out[0])
        return out

    ft._ln_bwd = cb._ln_bwd = keeping
    try:
        dy_c = dcls.to(cdt)
        _, g = cb.cls_bwd_plain(xs[-1], dy_c, blocks[-1], heads, dim_head,
                                streams[2])
        dln2, dx32 = kept
        dx32 = dx32.clone()
        dx32[:, 0] += dy_c.float() + dln2
        grads = [g]
        for xi, w in zip(reversed(xs[:-1]), reversed(blocks[:-1])):
            del kept[:]
            _, g = ft.block_bwd_plain(xi, dx32, w, heads, dim_head)
            dx32 = dx32 + kept[0] + kept[1]
            grads.append(g)
    finally:
        ft._ln_bwd = cb._ln_bwd = real
    return dx32.to(cdt), tuple(reversed(grads)), (dfs, dfb)


K6_WRONGS = {"autograd of the plain forward": trunk_autograd_bwd,
             "dx kept in fp32 between blocks": trunk_fp32_dx_bwd}


def chain_streams(x, blocks, heads, dim_head):
    """The forward the per-block kernels run (K2f on each full block, K3f
    with its records on the last) as K6's streams (xs, cls, saved): what
    the chain of per-block backwards differentiates."""
    import torch

    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft

    xs = [x]
    for w in blocks[:-1]:
        xs.append(ft.block_fwd_fused(xs[-1], w, heads, dim_head))
    cls, rec = cb.cls_fwd_fused(xs[-1], blocks[-1], heads, dim_head,
                                save=True)
    return torch.stack(xs[1:]).contiguous(), cls, rec


def trunk_chain_bwd(x, dy, blocks, fn, heads, dim_head, final_norm,
                    streams=None):
    """The per-block kernels chained as the default route chains them:
    K2f, K3f forward, the final norm's backward in PyTorch, K3b, K2b (on
    the streams K2f and K3f give, `chain_streams`; `streams` is not
    read)."""
    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops.trunk_train import final_norm_bwd_plain

    st, cls, rec = chain_streams(x, blocks, heads, dim_head)
    xs = [x, *st]
    dcls, dfs, dfb = final_norm_bwd_plain(dy.float(), cls.float(), fn[0],
                                          fn[1], final_norm)
    dx, g = cb.cls_bwd_fused(xs[-1], dcls.to(x.dtype), blocks[-1], heads,
                             dim_head, rec)
    grads = [g]
    for xi, w in zip(reversed(xs[:-1]), reversed(blocks[:-1])):
        dx, g = ft.block_bwd_fused(xi, dx, w, heads, dim_head)
        grads.append(g)
    return dx, tuple(reversed(grads)), (dfs, dfb)


def frame_errs(dx, ref, own_scale=False):
    """Each frame's mean |dx - ref| over L, L the largest |ref| of the
    batch (phase 13's per-frame statistic) or, with own_scale, of the
    frame itself (phase 5b's)."""
    ref = ref.float()
    scale = (ref.abs().amax(dim=(1, 2)) if own_scale
             else ref.abs().max()).clamp(min=1e-30)
    return ((dx.float() - ref).abs().mean(dim=(1, 2)) / scale).tolist()


def with_streams(args):
    """trunk_bwd_fused's arguments (x, dy, blocks, fn, heads, dim_head,
    final_norm) with the streams K4 writes for them on the card, in the
    form K4's route takes (its K4 form at the flagship bf16 widths, else
    the FMA body), as the trunk-gradient route hands them to K6. K6, its
    plain version, its float64-sum version and the wrong backwards are all
    given the same streams."""
    from dgvit_tpu_torch.ops import got_megakernel as gm

    x, dy, blocks, fn, heads, dim_head, final_norm = args
    return (*args, gm._blocks_forward(x, blocks, fn, heads, dim_head,
                                      final_norm, streams=True)[1])


def trunk_tensors(result):
    """dx, the blocks' 44 gradients and the final norm's, as one list; an
    all-zero bias gradient (RMS norm has none) is left out, the checks
    scale by a tensor's largest |value|."""
    dx, gblocks, dfn = result
    dfn = [g for g in dfn if g.abs().max().item() > 0]
    return [dx, *[g for gb in gblocks for g in gb], *dfn]


def k6_cases(nets, dtype, batch, rng):
    """(label, arguments of trunk_bwd_fused, K4's streams last): the
    actor's trunk with its RMS norm, the critic's with a Layer norm of
    seeded bias, and at B=3 the actor's on a smaller token count."""
    import torch

    inp = train_inputs(nets[dtype], batch, rng)
    a, c = inp["actor"], inp["critic"]
    bias = torch.from_numpy((0.1 * rng.standard_normal(64)).astype(
        "float32")).to(DEVICE)
    cases = [
        ("actor rms n=65", (a["x"], a["dy3"], a["blocks"], a["fn"],
                            a["heads"], a["dh"], "rms")),
        ("critic layer n=65", (c["x"], c["dy3"], c["blocks"],
                               (c["fn"][0], bias), c["heads"], c["dh"],
                               "layer"))]
    if batch == 3:
        cases.append((f"actor rms n={K6_SMALL_N}", (
            a["x"][:, :K6_SMALL_N].contiguous(), a["dy3"], a["blocks"],
            a["fn"], a["heads"], a["dh"], "rms")))
    return [(label, with_streams(args)) for label, args in cases]


def phase_k6(nets, rng):
    """Phase 13: K6 against its plain version and against two wrong
    backwards; the chain of per-block kernels (and K6) against the
    float64-sum version of the plain version (see CHAIN_WITHIN)."""
    import torch

    from dgvit_tpu_torch.ops.trunk_train import (trunk_bwd_fused,
                                                 trunk_bwd_plain)

    wrongs = K6_WRONGS
    pooled = {name: TrainErrors() for name in ("K6", *wrongs)}
    frames = {name: [] for name in ("K6", *wrongs)}
    versus_exact = {name: TrainErrors()
                    for name in ("chain", "K6", "plain", *wrongs)}
    exact_frames = {name: [] for name in versus_exact}
    batch_frames = {name: [] for name in versus_exact}   # a record
    chain_old, fp32_exact = TrainErrors(), {}

    per_tensor = {}   # version: its worst weight gradient against exact
    tensor_sums = {}  # version: [sum |err| / L, count] by weight gradient

    def against_exact(versions, ex, what):
        """Each version's dx by frame and every tensor pooled against the
        float64-sum version; each weight gradient's max|err|/L against
        max(2^-6, k x the plain version's), the worst kept."""
        plain = [rel_max([r], [e]) for r, e in zip(versions["plain"], ex)]
        for name, got in versions.items():
            versus_exact[name].add(zip(got, ex))
            exact_frames[name] += frame_errs(got[0], ex[0], own_scale=True)
            batch_frames[name] += frame_errs(got[0], ex[0])
            for i, (g, e) in enumerate(zip(got, ex)):
                if i == 0 or i > 11 * K6_DEPTH:
                    continue   # dx, the final norm's
                acc = tensor_sums.setdefault(name, {}).setdefault(i, [0, 0])
                acc[0] += ((g.float() - e.float()).abs().sum().item()
                           / max(e.float().abs().max().item(), 1e-30))
                acc[1] += g.numel()
                r = rel_max([g], [e])
                limit = max(TRAIN_BF16_MAX, CHAIN_TENSOR_K * plain[i])
                if r / limit > per_tensor.get(name, {}).get("ratio", -1):
                    per_tensor[name] = dict(
                        ratio=r / limit, got=r, plain=plain[i], limit=limit,
                        tensor=f"block {(i - 1) // 11} "
                               f"{GRAD_NAMES[(i - 1) % 11]}", case=what)

    worst = {}
    for dtype in ("float32", "bfloat16"):
        for batch in K6_BATCHES:
            for label, args in k6_cases(nets, dtype, batch, rng):
                out = trunk_tensors(trunk_bwd_fused(*args))
                torch.cuda.synchronize()
                ref = trunk_tensors(trunk_bwd_plain(*args))
                chain = trunk_tensors(trunk_chain_bwd(*args))
                what = f"K6 {dtype} B={batch} {label}"
                check(len(out) == len(ref) == len(chain) and all(
                    o.shape == r.shape and o.dtype == r.dtype
                    for o, r in zip(out, ref)), f"{what}: shapes or dtypes")
                check(all(bool(torch.isfinite(o.float()).all())
                          for o in out), f"{what}: non-finite")
                mx = max((o.float() - r.float()).abs().max().item()
                         for o, r in zip(out, ref))
                worst[dtype] = max(worst.get(dtype, 0.0), mx)
                if dtype == "float32":
                    e, ec = rel_max(out, ref), rel_max(out, chain)
                    ex = trunk_tensors(exact(trunk_bwd_plain, *args))
                    got, chain_k4, own = (rel_max(v, ex)
                                          for v in (out, chain, ref))
                    k = EXACT_K["fp32"]
                    limit = max(K6_F32_MAX, k * own)
                    # the chain differentiates its own forward (K2f's fp32
                    # cluster form, whose streams are not K4's bit for
                    # bit): it is held to the float64-sum version on those
                    # streams, against the plain version's there
                    own_args = (*args[:7], chain_streams(
                        args[0], args[2], args[4], args[5]))
                    ex_c = trunk_tensors(exact(trunk_bwd_plain, *own_args))
                    got_chain = rel_max(chain, ex_c)
                    own_c = rel_max(trunk_tensors(trunk_bwd_plain(
                        *own_args)), ex_c)
                    limit_c = max(K6_F32_MAX, k * own_c)
                    ok = got <= limit and got_chain <= limit_c
                    fp32_exact[what] = [got, got_chain, own]
                    print(f"{what}: old reading vs plain max|err|/L {e:.3e},"
                          f" vs the K3b + K2b chain {ec:.3e} (limit "
                          f"{K6_F32_MAX:g}, "
                          f"{'ok' if max(e, ec) <= K6_F32_MAX else 'FAIL'}); "
                          f"restated vs float64 sums: K6 {got:.3e} (limit "
                          f"max({K6_F32_MAX:g}, {k:g} x plain {own:.3e}) = "
                          f"{limit:.3e}); the chain on its own streams "
                          f"{got_chain:.3e} (limit max({K6_F32_MAX:g}, {k:g} "
                          f"x plain there {own_c:.3e}) = {limit_c:.3e}), on "
                          f"K4's {chain_k4:.3e} (read only) "
                          f"{'ok' if ok else 'FAIL'}", flush=True)
                    record("fp32 K6", case=what, got=got, chain=got_chain,
                           plain=own, limit=limit, chain_plain=own_c,
                           chain_limit=limit_c, chain_on_k4=chain_k4,
                           old=max(e, ec), k=k)
                    check(ok, f"{what}: K6 or the per-block chain disagrees "
                          "with the float64-sum version of its plain "
                          "version")
                    continue
                e = TrainErrors()
                e.add(zip(out, ref))
                pooled["K6"].add(zip(out, ref))
                chain_old.add(zip(out, chain))
                frames["K6"] += frame_errs(out[0], ref[0])
                ex = trunk_tensors(exact(trunk_bwd_plain, *args))
                versions = {"chain": chain, "K6": out, "plain": ref}
                line = (f"{what}: vs plain max|err| {mx:.3e}, mean|err|/L "
                        f"{e.mean:.3e}")
                for name, wrong in wrongs.items():
                    w = TrainErrors()
                    bad = trunk_tensors(wrong(*args))
                    versions[name] = bad
                    w.add(zip(bad, ref))
                    pooled[name].add(zip(bad, ref))
                    frames[name] += frame_errs(bad[0], ref[0])
                    line += f"; wrong ({name}) mean|err|/L {w.mean:.3e}"
                against_exact(versions, ex, what)
                old = rel_max(chain, out)
                print(line + f"; K6 vs plain, old reading: every max "
                      f"within 2^-6 L: {e.max_ok}; the chain vs K6: old "
                      f"reading max|err|/L {old:.3e} (limit 2^-6, "
                      f"{'ok' if old <= TRAIN_BF16_MAX else 'FAIL'}); "
                      "against float64 sums max|err|/L: " + ", ".join(
                          f"{n} {rel_max(v, ex):.3e}"
                          for n, v in versions.items()), flush=True)
    own = rng.spawn(1)[0]   # as in phase_times: later phases keep their draws
    for i in range(CHAIN_EXTRA):
        for label, args in k6_cases(nets, "bfloat16", CHAIN_EXTRA_BATCH, own):
            versions = {"chain": trunk_tensors(trunk_chain_bwd(*args)),
                        "K6": trunk_tensors(trunk_bwd_fused(*args)),
                        "plain": trunk_tensors(trunk_bwd_plain(*args))}
            versions.update({name: trunk_tensors(wrong(*args))
                             for name, wrong in wrongs.items()})
            against_exact(versions, trunk_tensors(
                exact(trunk_bwd_plain, *args)),
                f"extra draw {i} B={CHAIN_EXTRA_BATCH} {label}")
    tensor_mean = {}
    for name, sums in tensor_sums.items():
        top = max(sums, key=lambda i: sums[i][0] / sums[i][1] / max(
            K6_BF16_MEAN, CHAIN_TENSOR_K * tensor_sums["plain"][i][0]
            / tensor_sums["plain"][i][1]))
        got = sums[top][0] / sums[top][1]
        plain = tensor_sums["plain"][top][0] / tensor_sums["plain"][top][1]
        limit = max(K6_BF16_MEAN, CHAIN_TENSOR_K * plain)
        tensor_mean[name] = dict(
            got=got, plain=plain, limit=limit, ratio=got / limit,
            tensor=f"block {(top - 1) // 11} {GRAD_NAMES[(top - 1) % 11]}")
        print(f"{name} vs the float64-sum version, each weight gradient's "
              f"mean|err|/L pooled over the bf16 cases, the worst: "
              f"{tensor_mean[name]['tensor']} {got:.3e}, the plain version "
              f"{plain:.3e}, limit max(2^-13, {CHAIN_TENSOR_K:g} x plain) = "
              f"{limit:.3e} ({got / limit:.2f} x the limit)", flush=True)
    for name, w in per_tensor.items():
        print(f"{name} vs the float64-sum version, the worst weight gradient"
              f" over the bf16 cases: {w['tensor']} ({w['case']}) max|err|/L"
              f" {w['got']:.3e}, the plain version {w['plain']:.3e}, limit "
              f"max(2^-6, {CHAIN_TENSOR_K:g} x plain) = {w['limit']:.3e} "
              f"({w['ratio']:.2f} x the limit)", flush=True)
    for name, e in pooled.items():
        print(f"{name} vs K6's plain version, bf16 cases pooled: mean|err|/L "
              f"{e.mean:.3e} (limit {K6_BF16_MEAN:.3e}), every max within "
              f"2^-6 L: {e.max_ok} (the old per-tensor reading)", flush=True)
    check(pooled["K6"].mean <= K6_BF16_MEAN,
          "K6 vs K6's plain version: they disagree (bf16 pooled)")
    within = {name: sum(f <= TRAIN_BF16_MEAN for f in fs) / len(fs)
              for name, fs in exact_frames.items()}
    verdict = {name: within[name] >= CHAIN_WITHIN
               and versus_exact[name].mean <= K6_BF16_MEAN
               for name in within}
    print(f"the K3b + K2b chain vs K6, bf16 cases pooled: old reading "
          f"mean|err|/L {chain_old.mean:.3e} (limit {K6_BF16_MEAN:.3e}), "
          f"every max within 2^-6 L: {chain_old.max_ok}", flush=True)
    for name in versus_exact:
        if name == "plain":
            continue
        print(f"{name} vs the float64-sum version, bf16 cases ("
              f"{len(exact_frames[name])} frames): pooled mean|err|/L "
              f"{versus_exact[name].mean:.3e} (limit {K6_BF16_MEAN:.3e}), "
              f"dx frames within {TRAIN_BF16_MEAN:.3e} (each frame's own "
              f"L): {within[name]:.3f} "
              f"(at least {CHAIN_WITHIN:g}; the plain version "
              f"{within['plain']:.3f}); "
              f"{'passes' if verdict[name] else 'FAILS'}", flush=True)
    n = len(exact_frames["chain"])
    se = math.sqrt(CHAIN_WITHIN * (1 - CHAIN_WITHIN) / n)
    for name, v in within.items():
        print(f"{name}: dx frames within 2^-18 {v:.4f} of {n}, "
              f"{(v - CHAIN_WITHIN) / se:+.2f} standard errors ({se:.4f}) "
              f"from the line {CHAIN_WITHIN:g}", flush=True)
    batch_share = {name: sum(f <= TRAIN_BF16_MEAN for f in fs) / len(fs)
                   for name, fs in batch_frames.items()}
    print("dx frames within 2^-18 of the float64-sum version on the batch's"
          " scale (the rule before fault j's repair, at least 0.52; a "
          "record): " + ", ".join(f"{name} {v:.4f}"
                                  for name, v in batch_share.items()),
          flush=True)
    record("chain", within=within, share=CHAIN_WITHIN, frames=n,
           batch_scale=batch_share,
           per_tensor=per_tensor, tensor_mean=tensor_mean,
           pooled={n: e.mean for n, e in versus_exact.items()},
           verdict=verdict, fp32=fp32_exact,
           old={"max_ok": chain_old.max_ok, "mean": chain_old.mean,
                "k6_max_ok": pooled["K6"].max_ok,
                "k6_mean": pooled["K6"].mean})
    check(verdict["chain"] and verdict["K6"], "the K3b + K2b chain or K6 "
          "disagrees with the float64-sum version (bf16, dx by frame)")
    for name in wrongs:
        check(not verdict[name], f"the restated chain check passes a wrong "
              f"backward ({name})")
    for name, errs in frames.items():
        share = sum(e <= TRAIN_BF16_MEAN for e in errs) / len(errs)
        ok = share >= K6_FRAMES_WITHIN
        print(f"{name} vs K6's plain version, dx by frame over the bf16 "
              f"cases ({len(errs)} frames): median mean|err|/L "
              f"{statistics.median(errs):.3e}, frames within "
              f"{TRAIN_BF16_MEAN:.3e}: {share:.3f} (at least "
              f"{K6_FRAMES_WITHIN:.3f}); {'passes' if ok else 'FAILS'}",
              flush=True)
        if name in wrongs:
            check(not ok, f"K6's bf16 limits pass a wrong backward ({name})")
        else:
            check(ok, "K6 disagrees with its plain version (bf16, dx by "
                  "frame)")
    return worst


FAULT_J_BATCH = 256


def phase_fault_j(nets, rng):
    """Phase 13a, fault j's magnitude (K6 used to recompute the block
    inputs on the FMA body while K4's route ran its K4 form). K4's two
    bodies on the same x at the flagship bf16 widths: the FMA body
    (trunk_kernel, the body of K6's removed forward chain) and the K4
    form (trunk_mma_kernel<true>, K4's route), each writing its streams.
    Read: the share of frames whose streams differ, block by block and
    in any block; K6's dx on each set of streams against the float64-sum
    plain backward on the K4 form's streams, pooled (phase 13's mean over
    L) and by frame within 2^-18 on the batch's scale (phase 13's rule
    before the repair, at least 0.52 of the frames) and on each frame's
    own (phase 5b's rule, K6_WIDTHS_WITHIN, and phase 13's since,
    CHAIN_WITHIN). The actor's and the seeded critic's trunks at
    B=256 on a generator spawned off the phase's. A measurement: nothing
    is held but finiteness."""
    from dgvit_tpu_torch.ops import got_megakernel as gm
    from dgvit_tpu_torch.ops.trunk_train import (trunk_bwd_fused,
                                                 trunk_bwd_plain)

    share = lambda errs: sum(f <= TRAIN_BF16_MEAN for f in errs) / len(errs)
    reading = {}
    for label, args in k6_cases(nets, "bfloat16", FAULT_J_BATCH,
                                rng.spawn(1)[0]):
        x, dy, blocks, fn, heads, dh, norm = args[:7]
        streams = {name: gm._launch_blocks(x, blocks, fn, heads, dh, norm,
                                           body=body, streams=True)[1]
                   for name, body in (("FMA body", 0), ("K4 form", 1))}
        (fxs, fcls, _), (kxs, kcls, _) = (streams["FMA body"],
                                          streams["K4 form"])
        moved = [(a != b).flatten(1).any(1) for a, b in zip(fxs, kxs)]
        moved.append((fcls != kcls).any(1))
        differ = [m.float().mean().item() for m in moved]
        anywhere = sum(m.int() for m in moved).gt(0).float().mean().item()
        ex = trunk_tensors(exact(trunk_bwd_plain, *args[:7],
                                 streams["K4 form"]))
        k6 = {}
        for name, st in streams.items():
            got = trunk_tensors(trunk_bwd_fused(*args[:7], st))
            check(all(bool(g.float().isfinite().all()) for g in got),
                  f"fault j, {label}: K6 on the {name}'s streams non-finite")
            k6[name] = dict(
                pooled=pooled_rel(got, ex), dx_max=rel_max(got[:1], ex[:1]),
                batch_scale=share(frame_errs(got[0], ex[0])),
                own_scale=share(frame_errs(got[0], ex[0], own_scale=True)))
        reading[label] = dict(differ=differ, anywhere=anywhere, k6=k6)
        print(f"fault j, {label}, B={FAULT_J_BATCH}: frames whose streams "
              f"differ between K4's FMA body and its K4 form: by block "
              + ", ".join(f"{v:.4f}" for v in differ[:-1])
              + f", CLS row {differ[-1]:.4f}, any {anywhere:.4f}", flush=True)
        for name, r in k6.items():
            print(f"fault j, {label}: K6 on the {name}'s streams vs the "
                  f"float64-sum backward on the K4 form's: pooled "
                  f"mean|err|/L {r['pooled']:.3e}, dx max|err|/L "
                  f"{r['dx_max']:.3e}, dx frames within 2^-18 on the "
                  f"batch's scale {r['batch_scale']:.4f} (phase 13's old "
                  f"line 0.52), on their own {r['own_scale']:.4f} (phase 5b's"
                  f" line {K6_WIDTHS_WITHIN:g}, phase 13's "
                  f"{CHAIN_WITHIN:g})", flush=True)
    record("fault j", batch=FAULT_J_BATCH, **reading)
    return reading


def workspace_slots(ws, b, n, d, heads, dim_head, mlp, cls,
                    dtype=None):
    """The per-frame pass's operand slots of a block backward's workspace
    `ws` in `dtype` (bf16 unless given; block_grad.cu's `workspace`):
    {name: slot} for h1 (B,
    n, d), o, h2 and hid ((B, n, .) for a full block, the CLS row's (B, .)
    for the CLS-only block), and for the CLS-only block also q (B, inner)
    and k|v of every row (B, n, 2 inner; written only by the body that
    recomputes the CLS row)."""
    import torch

    inner = heads * dim_head
    rq, qkv = (1, 2 * inner) if cls else (n, 3 * inner)
    elems = (n * d, n * qkv, rq * inner, rq * d, rq * mlp, rq * mlp, rq * d,
             rq * inner, n * qkv, inner if cls else 0, inner if cls else 0)
    dt = dtype or torch.bfloat16
    es = 2 if dt == torch.bfloat16 else 4
    at, slots = 0, []
    for e in elems:
        slots.append(ws[at:at + es * b * e].view(dt))
        at = (at + es * b * e + 15) // 16 * 16
    shape = (lambda c: (b, c)) if cls else (lambda c: (b, n, c))
    out = {"h1": slots[0].view(b, n, d), "o": slots[2].view(shape(inner)),
           "h2": slots[3].view(shape(d)), "hid": slots[4].view(shape(mlp))}
    if cls:
        out.update(q=slots[9].view(b, inner),
                   kv=slots[1].view(b, n, 2 * inner))
    return out


def backward_slots(x, dy, w, heads, dim_head, cls, record=None):
    """K2b (cls False) or K3b (cls True) as `launch_block_bwd` launches
    them, with the per-frame pass's workspace kept: (dx, its slots as
    `workspace_slots` names them). K3b reads the CLS records `record`;
    None recomputes the CLS row (the body before fault k's repair)."""
    import torch

    from dgvit_tpu_torch.ops import fused_transformer as ft

    b, n, d = x.shape
    mlp = w[7].shape[-1]
    lib = ft._block_lib()
    ws = torch.empty(lib.block_backward_workspace(
        ft._DTYPES[x.dtype], int(cls), b, n, d, heads, dim_head, mlp),
        dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    grads = [torch.empty_like(t) for t in w]
    ft._call(lib.block_backward_launch, x.dtype, cls,
             [x, dy, *w, dx, *grads, ws, record], x, heads, dim_head, mlp,
             ft.block_form(x, w, dim_head, cls, dy))
    return dx, workspace_slots(ws, b, n, d, heads, dim_head, mlp, cls,
                               x.dtype)


def trunk_slots(x, dy, blocks, fn, heads, dim_head, final_norm, streams,
                record):
    """K6 as `trunk_bwd_fused` launches it on K4's streams (xs, cls), its
    CLS block reading the records `record` (None: recomputing the CLS row,
    the body before fault k's repair), with its workspace kept: (dx, the
    CLS block's slots as `workspace_slots` names them), read at the
    offsets of block_grad.cu's `trunk_workspace`."""
    import ctypes

    import torch

    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops.trunk_train import _NORMS, tensor_core_trunk

    lib = ft._block_lib()
    b, n, d = x.shape
    depth, mlp = len(blocks), blocks[0][7].shape[-1]
    dt = ft._DTYPES[x.dtype]
    ws = torch.empty(lib.trunk_backward_workspace(
        dt, b, n, d, heads, dim_head, mlp, depth), dtype=torch.uint8,
        device=x.device)
    dx = torch.empty_like(x)
    grads = [torch.empty_like(t) for w in blocks for t in w]
    dfn = [torch.empty_like(t) for t in fn]
    tensors = [x, dy, *[t for w in blocks for t in w], *fn, dx, *grads, *dfn,
               ws, *streams[:2], record]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    with torch.cuda.device(x.device):
        err = lib.trunk_backward_launch(
            dt, ctypes.cast(ptrs, ctypes.c_void_p), len(tensors), b, n, d,
            heads, dim_head, mlp, depth, _NORMS[final_norm],
            dim_head ** -0.5, torch.cuda.current_stream().cuda_stream,
            int(tensor_core_trunk(x, blocks, dim_head)))
    check(err == 0, f"K6 launch failed: {lib.block_error_string(err)}")
    al = lambda v: (v + 15) // 16 * 16
    at = 0
    for _ in range(depth - 1):        # the dx between blocks
        at = al(at + 2 * b * n * d)
    at = al(al(at + 2 * b * d) + 4 * b * 2 * d)   # dcls, fnvec
    at += (depth - 1) * lib.block_backward_workspace(dt, 0, b, n, d, heads,
                                                     dim_head, mlp)
    return dx, workspace_slots(ws[at:], b, n, d, heads, dim_head, mlp, True)


def forward_probe(x, w, heads, dim_head, cls, k1=False):
    """K2f's or K3f's bf16 tensor-core body, or (fp32, K2f) K2f's fp32
    cluster form (k1: the same body summed as K1's fp32 cluster form sums
    it, cl32::Fast), with its intermediates written out (block_grad.cu:
    block_forward_probe): (out, {name: intermediate}) in workspace_slots'
    shapes, and k and v of every row (B, n, inner)."""
    import ctypes

    import torch

    from dgvit_tpu_torch.ops import fused_transformer as ft

    b, n, d = x.shape
    mlp, inner = w[7].shape[-1], heads * dim_head
    lib = ft._block_lib()
    lib.block_forward_probe.restype = ctypes.c_int
    lib.block_forward_probe.argtypes = (
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
    new = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
    rows = (b,) if cls else (b, n)
    out = new(b, d) if cls else new(b, n, d)
    inter = {"h1": new(b, n, d), "o": new(*rows, inner), "h2": new(*rows, d),
             "hid": new(*rows, mlp), "k": new(b, n, inner),
             "v": new(b, n, inner)}
    ft._call(lib.block_forward_probe, x.dtype, cls, [x, *w, out,
             *inter.values()], x, heads, dim_head, mlp, int(k1))
    return out, inter


def record_parts(rec, n, heads, dim_head, d, mlp):
    """The bf16 parts of CLS records (cls_block.cls_saved_width's layout)
    as the backward's slots hold them: q, o, h2."""
    import torch

    inner = heads * dim_head
    q, _, o, _, h2, _ = torch.split(
        rec, [inner, heads * n, inner, d, d, mlp], dim=1)
    return {"q": q.bfloat16(), "o": o.bfloat16(), "h2": h2.bfloat16()}


# Fault k's anchor (record_anchor): each part of a CLS record recomputed
# from the block's input and the record's earlier parts, in float64 sums
# rounded where the forward rounds; per part the mean |err| over every
# frame, over the part's largest |value|, within 2^-13 (phase 13's pooled
# limit). A right record parts from it only where one rounding lands on
# the other side of a bf16 step. Frame by frame that is no limit: on the
# trained actor a k rounded the other way (K3f's tensor-core sums, or
# the plain version's fp32 ones, against float64) moves a frame's
# probabilities by up to 0.12 of its largest, its scores being that
# sharp (H100 80GB HBM3, 700 W, chip_draws.py seeds 7-11), so each
# frame's max is printed, not held. A record of another head or frame
# moves every frame, and one wrong frame of 256 already reads about 1/256
# of the part's scale (PLANTED_RECORDS, which must fail).
ANCHOR_MEAN = 2.0 ** -13
PLANTED_RECORDS = ("o of the next head", "probabilities of the next frame",
                   "z of the next frame", "o of the next head, one frame")


def record_anchor(x, w, rec, out, heads, dim_head, hid=None):
    """Fault k's anchor of a bf16 CLS block's records `rec` (B,
    `cls_saved_width`) to the forward that wrote them: each part
    recomputed in float64 sums from the block's input x (B, n, d) and the
    record's own earlier parts, rounded to x's dtype where the forward
    rounds: q = LN1(x)_0 wq; p = softmax(q k^T scale), k and v from
    LN1(x); o = p v; x1 = x_0 + o wout + bout; h2 = LN2(x1); z = h2 w1 +
    b1; and the block's CLS output `out` (B, d) = x1 + gelu(z) w2 + b2
    (with `hid`, a backward's slot, also hid = gelu(z)). Returns {part:
    (the mean |given - recomputed| over every value of the part / its
    largest |recomputed|, the largest over the frames of max|given -
    recomputed| / the frame's largest |recomputed|)}."""
    import torch

    from dgvit_tpu_torch.ops import fused_transformer as ft

    an_s, an_b, wqkv, wout, bout, fn_s, fn_b, w1, b1, w2, b2 = w
    b, n, d = x.shape
    inner, mlp, cdt = heads * dim_head, w1.shape[-1], x.dtype
    f64 = lambda t: t.double()
    rnd = lambda t: t.to(cdt).double()
    vec = lambda t: f64(t).reshape(-1)
    split = lambda t: t.reshape(b, -1, heads, dim_head).transpose(1, 2)
    q, p, o, x1, h2, z = torch.split(
        f64(rec), [inner, heads * n, inner, d, d, mlp], dim=1)
    h1 = rnd(ft._ln(ft._f32(x), an_s, an_b))
    kv = rnd(h1 @ f64(wqkv[:, inner:]))
    k, v = split(kv[..., :inner]), split(kv[..., inner:])
    s = split(q) @ k.transpose(-1, -2) * dim_head ** -0.5   # (B, H, 1, n)
    hidden = rnd(ft._gelu32(z.float(), cdt))
    ref = {"q": rnd(h1[:, 0] @ f64(wqkv[:, :inner])),
           "p": torch.softmax(s, dim=-1).reshape(b, -1),
           "o": rnd(rnd(p.reshape(b, heads, 1, n)) @ v).transpose(
               1, 2).reshape(b, inner),
           "x1": f64(x[:, 0]) + (o @ f64(wout) + vec(bout)),
           "h2": rnd(ft._ln(x1.float(), fn_s, fn_b)),
           "z": h2 @ f64(w1) + vec(b1),
           "out": rnd(x1 + (vec(b2) + hidden @ f64(w2)))}
    got = {"q": q, "p": p, "o": o, "x1": x1, "h2": h2, "z": z,
           "out": f64(out)}
    if hid is not None:
        ref["hid"], got["hid"] = hidden, f64(hid)
    return {part: (
        (got[part] - r).abs().mean().item()
        / max(r.abs().max().item(), 1e-30),
        ((got[part] - r).abs().amax(1)
         / r.abs().amax(1).clamp(min=1e-30)).max().item())
        for part, r in ref.items()}


def planted_records(rec, n, heads, dim_head, d, mlp):
    """Wrong CLS records for record_anchor to fail (PLANTED_RECORDS): o
    with each head's part moved to the next head's place, the
    probabilities of the next frame, z of the next frame, and the first
    of these on frame 0 alone."""
    inner = heads * dim_head
    at = {"p": (inner, heads * n), "o": (inner + heads * n, inner),
          "z": (2 * inner + heads * n + 2 * d, mlp)}

    def moved(part, shift, dim, frames=None):
        r = rec.clone()
        a, width = at[part]
        r[:frames, a:a + width] = rec[:frames, a:a + width].roll(shift,
                                                                  dims=dim)
        return r
    return dict(zip(PLANTED_RECORDS, (
        moved("o", dim_head, 1), moved("p", 1, 0), moved("z", 1, 0),
        moved("o", dim_head, 1, frames=1))))


def anchor_verdict(case, x, w, rec, out, heads, dim_head, hid=None,
                   plant=True):
    """Hold `rec` to record_anchor's pooled readings within ANCHOR_MEAN
    and, with `plant`, every planted wrong record over it; print and
    return the readings."""
    b, n, d = x.shape
    got = record_anchor(x, w, rec, out, heads, dim_head, hid)
    planted = {name: max(v[0] for v in record_anchor(
        x, w, r, out, heads, dim_head).values())
               for name, r in (planted_records(
                   rec, n, heads, dim_head, d, w[7].shape[-1]).items()
                   if plant else ())}
    worst = max(v[0] for v in got.values())
    ok = worst <= ANCHOR_MEAN
    print(f"recompute, {case}: the CLS records against the forward's input "
          f"and output, pooled mean|err|/L by part (limit 2^-13): "
          + ", ".join(f"{k} {v[0]:.3e}" for k, v in got.items())
          + f" {'ok' if ok else 'FAIL'}; a frame's largest max|err| over "
          "its largest value (a record): " + ", ".join(
              f"{k} {v[1]:.3e}" for k, v in got.items()) + "".join(
              f"; planted {k} {v:.3e} "
              + ("fails" if v > ANCHOR_MEAN else "PASSES")
              for k, v in planted.items()), flush=True)
    check(ok, f"fault k, {case}: the CLS records part from the forward "
          "that wrote them")
    for name, v in planted.items():
        check(v > ANCHOR_MEAN, f"fault k, {case}: the records' anchor "
              f"passes a wrong record ({name})")
    return {"read": {k: v[0] for k, v in got.items()},
            "frame_max": {k: v[1] for k, v in got.items()},
            "planted": planted, "limit": ANCHOR_MEAN}


RECOMPUTE_BATCH = 256


def phase_recompute(nets, rng):
    """Phase 13b, faults j and k: do the backwards differentiate the
    forward that ran? For the actor's and the seeded critic's trunks, bf16,
    B=256, on a generator spawned off the phase's:
      * K2b on the first block: the share of frames whose recomputed h1,
        o, h2 or hid differ from K2f's (the forward probe, which must give
        K2f's output bit for bit);
      * K3b on the last block and K6 on the whole trunk, each body of K4
        (0 FMA, 1 the K4 form, 2 every product on the tensor cores): the
        CLS row's q, o, h2 and hid the backward works with, against those
        the forward computed (its records; hid as the repaired backward
        forms it from the records, and for K3b the probe's), with the
        records (the repaired backward: equal on every frame, held) and
        without (the body before the repair recomputing them: fault k's
        magnitude, read); for K3b also whether its recomputed k and v
        differ from K3f's (the probe's);
      * the records anchored to the forward that wrote them
        (anchor_verdict: K3f's, each body's of K4 with the hid K6 forms,
        and K4's plain version's), and four planted wrong records of
        each kernel failing the anchor, so that the equality above holds
        the backward to that forward;
    and each backward's dx against the float64-sum version of its plain
    version on the same records, by frame on each frame's own scale
    (phase 13's statistic and line, CHAIN_WITHIN, held for the repaired
    backwards), over the frames where an intermediate differs and where
    none does."""
    import torch

    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft
    from dgvit_tpu_torch.ops import got_megakernel as gm
    from dgvit_tpu_torch.ops.trunk_train import trunk_bwd_plain

    share = lambda errs: (sum(f <= TRAIN_BF16_MEAN for f in errs) / len(errs)
                          if errs else float("nan"))
    reading = {}

    def read(case, ahead, before, after, dx_before, dx_after, ex):
        """The shares of frames whose `before` / `after` slots differ from
        the forward's `ahead`, and dx against float64 sums; `after` must
        equal `ahead` on every frame, its dx meet phase 13's line."""
        differ = {k: (ahead[k] != before[k]).flatten(1).any(1)
                  for k in ahead}
        moved = sum(v.int() for v in differ.values()).gt(0)
        after_differ = sum((ahead[k] != after[k]).flatten(1).any(1).int()
                           for k in ahead).gt(0).float().mean().item()
        check(after_differ == 0, f"fault k, {case}: the repaired backward's "
              f"CLS row differs from the forward's on {after_differ:.4f} "
              "of the frames")
        errs = frame_errs(dx_before, ex, own_scale=True)
        within = share(frame_errs(dx_after, ex, own_scale=True))
        check(within >= CHAIN_WITHIN, f"fault k, {case}: the repaired "
              f"backward's dx frames within 2^-18 of float64 sums {within:.4f}"
              f" < {CHAIN_WITHIN}")
        for t in (dx_before, dx_after):
            check(bool(t.float().isfinite().all()), f"{case}: non-finite dx")
        r = dict(differ={k: v.float().mean().item()
                         for k, v in differ.items()},
                 anywhere=moved.float().mean().item(),
                 after_differ=after_differ,
                 within_moved=share([e for e, m in zip(errs, moved.tolist())
                                     if m]),
                 within_unmoved=share([e for e, m in
                                       zip(errs, moved.tolist()) if not m]),
                 within_after=within,
                 pooled=pooled_rel([dx_before], [ex]),
                 pooled_after=pooled_rel([dx_after], [ex]))
        reading[case] = r
        print(f"recompute, {case}, B={RECOMPUTE_BATCH}: frames whose CLS-row "
              "intermediate differs from the forward's before the repair: "
              + ", ".join(f"{k} {v:.4f}" for k, v in r["differ"].items())
              + f", any {r['anywhere']:.4f}; after {after_differ:.4f}; dx "
              f"frames within 2^-18 of float64 sums (own scale): before, "
              f"where one differs {r['within_moved']:.4f}, where none does "
              f"{r['within_unmoved']:.4f}; after {within:.4f} (at least "
              f"{CHAIN_WITHIN}); pooled mean|err|/L {r['pooled']:.3e} -> "
              f"{r['pooled_after']:.3e}", flush=True)
        return r

    inp = train_inputs(nets["bfloat16"], RECOMPUTE_BATCH, rng.spawn(1)[0])
    for net, a in inp.items():
        heads, dh = a["heads"], a["dh"]
        # K2b on the first block: its recompute against K2f's body
        x, w, dy = a["x"], a["blocks"][0], a["dy2"]
        out, ahead = forward_probe(x, w, heads, dh, False)
        check(torch.equal(out, ft.block_fwd_fused(x, w, heads, dh)),
              f"K2b's forward probe ({net}) is not the forward")
        dx, slots = backward_slots(x, dy, w, heads, dh, False)
        check(bool(dx.float().isfinite().all()), f"K2b ({net}): non-finite")
        differ = {k: (ahead[k] != slots[k]).flatten(1).any(1)
                  for k in ("h1", "o", "h2", "hid")}
        anywhere = sum(v.int() for v in differ.values()).gt(0)
        reading[f"K2b {net}"] = dict(
            differ={k: v.float().mean().item() for k, v in differ.items()},
            anywhere=anywhere.float().mean().item())
        print(f"recompute, K2b ({net}, B={RECOMPUTE_BATCH}): frames whose "
              "recomputed intermediate differs from K2f's: " + ", ".join(
                  f"{k} {v:.4f}"
                  for k, v in reading[f"K2b {net}"]["differ"].items())
              + f", any {anywhere.float().mean().item():.4f}", flush=True)

        # K3b on the last block, on K3f's records
        x, w, dy = a["last"], a["blocks"][-1], a["dy3"]
        n, d, mlp = x.shape[1], x.shape[2], w[7].shape[-1]
        k3f, rec = cb.cls_fwd_fused(x, w, heads, dh, save=True)
        out, probe = forward_probe(x, w, heads, dh, True)
        check(torch.equal(out, k3f) and torch.equal(
            out, cb.cls_fwd_fused(x, w, heads, dh)), f"K3f ({net}): the "
            "probe, the forward with records and without differ")
        parts = record_parts(rec, n, heads, dh, d, mlp)
        check(all(torch.equal(parts[k], probe[k]) for k in ("o", "h2")),
              f"K3f ({net}): its records' o or h2 are not its body's")
        anchors = {"K3f": anchor_verdict(f"K3f {net}", x, w, rec, k3f,
                                         heads, dh)}
        dx0, before = backward_slots(x, dy, w, heads, dh, True)
        dx1, after = backward_slots(x, dy, w, heads, dh, True, rec)
        ahead = {**parts, "hid": probe["hid"]}
        ex = exact(cb.cls_bwd_plain, x, dy, w, heads, dh, rec)[0]
        r = read(f"K3b {net}", ahead, before, after, dx0, dx1, ex)
        kv = torch.cat([probe["k"], probe["v"]], dim=-1)
        r["kv_differ"] = (kv != before["kv"]).flatten(1).any(1).float(
            ).mean().item()
        print(f"recompute, K3b ({net}): frames whose recomputed k or v "
              f"differ from K3f's: {r['kv_differ']:.4f}", flush=True)

        # K6 on each body's streams and records: the records anchored to
        # the body's own CLS-block input (its last stream) and output (its
        # cls stream), as are the plain version's
        args = (a["x"], a["dy3"], a["blocks"], a["fn"], heads, dh, "rms")
        _, pst = gm.blocks_forward_plain(*args[:1], *args[2:], streams=True)
        anchors["K4 plain version"] = anchor_verdict(
            f"K4's plain version {net}", pst[0][-1], w, pst[2], pst[1],
            heads, dh, plant=False)
        for body in (0, 1, 2):
            st = gm._launch_blocks(*args[:1], *args[2:], body=body,
                                   streams=True)[1]
            dx0, before = trunk_slots(*args, st, None)
            dx1, after = trunk_slots(*args, st, st[2])
            anchors[f"K4 body {body}"] = anchor_verdict(
                f"K4 body {body} {net}, hid as K6 forms it", st[0][-1], w,
                st[2], st[1], heads, dh, hid=after["hid"])
            ahead = {**record_parts(st[2], n, heads, dh, d, mlp),
                     "hid": after["hid"]}
            ex = exact(trunk_bwd_plain, *args, st)[0]
            read(f"K6 {net} K4 body {body}", ahead, before, after, dx0, dx1,
                 ex)
        reading[f"anchors {net}"] = anchors
    reading["fp32"] = fp32_recompute(rng.spawn(1)[0])
    record("recompute", batch=RECOMPUTE_BATCH, **reading)
    return reading


def fp32_recompute(rng):
    """Phase 13b in fp32, on the 2d BC policy's blocks at the BC batches
    (64, 32):
      * K2b's fp32 cluster form on the first block: the fp32 forward probe
        (K2f's cluster form with its intermediates written out) must give
        K2f's output bit for bit, and the h1, o, h2 and hid K2b's
        recompute keeps must equal the probe's on every frame (the pass
        and K2f share tf32_block.cuh's body); K2b's dx is its own on a
        second launch;
      * K3b's fp32 cluster form on the last block: the probe of K3f's
        cluster form (its own two launches with the intermediates written
        out) must give K3f's output bit for bit; the k and v of every row
        and the h1 K3b's pass recomputes must equal the probe's on every
        frame (both run cl32::project), and the hid it forms from the
        records must equal the probe's; q, o and h2 in its slots must be
        the records' parts; the records are anchored to the forward that
        wrote them (`anchor_verdict`, with its planted wrong records)."""
    import torch

    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft

    _, _, model, shape, _ = bc_models()[0]
    heads, dh = model.trans.heads, model.trans.dim_head
    blocks = model.trans.fused_params(torch.float32)[2]
    w = blocks[0]
    out, k3 = {}, {}
    for b in BC_BATCHES:
        obs, goal, _ = bc_batch(b, shape, rng)
        with torch.no_grad():
            x = model.trans.embed(obs, model.fc_embed(goal)).contiguous()
            last = x
            for wb in blocks[:-1]:
                last = ft.block_fwd_plain(last, wb, heads, dh)
        dy = torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(
            "float32")).to(DEVICE)
        check(ft.block_form(x, w, dh, False) == 2
              and ft.block_form(x, w, dh, False, dy) == 2,
              f"phase 13b fp32, B={b}: K2f or K2b off the cluster form")
        k2f = ft.block_fwd_fused(x, w, heads, dh)
        probe_out, ahead = forward_probe(x, w, heads, dh, False)
        check(torch.equal(probe_out, k2f), f"phase 13b fp32, B={b}: the "
              "forward probe's output is not K2f's")
        dx, slots = backward_slots(x, dy, w, heads, dh, False)
        check(torch.equal(dx, ft.block_bwd_fused(x, dy, w, heads, dh)[0]),
              f"phase 13b fp32, B={b}: K2b's dx differs between launches")
        differ = {k: (ahead[k] != slots[k]).flatten(1).any(1).float()
                  .mean().item() for k in ("h1", "o", "h2", "hid")}
        out[str(b)] = differ
        print(f"recompute, K2b fp32 (the 2d BC policy's first block, "
              f"B={b}): the probe's output equals K2f's; frames whose "
              "recomputed intermediate differs from K2f's: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in differ.items()), flush=True)
        check(not any(differ.values()), f"phase 13b fp32, B={b}: K2b's "
              f"recompute differs from K2f's forward: {differ}")

        # K3b on the last block, on the records of K3f's cluster form
        wl, dy3 = blocks[-1], dy[:, 0].contiguous()
        n, d, mlp = last.shape[1], last.shape[2], wl[7].shape[-1]
        check(ft.block_form(last, wl, dh, True) == 2
              and ft.block_form(last, wl, dh, True, dy3) == 2,
              f"phase 13b fp32, B={b}: K3f or K3b off the cluster form")
        k3f, rec = cb.cls_fwd_fused(last, wl, heads, dh, save=True)
        probe_out, probe = forward_probe(last, wl, heads, dh, True)
        check(torch.equal(probe_out, k3f) and torch.equal(
            k3f, cb.cls_fwd_fused(last, wl, heads, dh)), f"phase 13b fp32, "
            f"B={b}: K3f's probe, with records and without differ")
        dx3, s3 = backward_slots(last, dy3, wl, heads, dh, True, rec)
        check(torch.equal(dx3, cb.cls_bwd_fused(last, dy3, wl, heads, dh,
                                                rec)[0]),
              f"phase 13b fp32, B={b}: K3b's dx differs between launches")
        inner = heads * dh
        q, _, o, _, h2, _ = torch.split(
            rec, [inner, heads * n, inner, d, d, mlp], dim=1)
        kv = torch.cat([probe["k"], probe["v"]], dim=-1)
        pairs = {"k|v": (kv, s3["kv"]), "h1": (probe["h1"], s3["h1"]),
                 "hid": (probe["hid"], s3["hid"]), "q": (q, s3["q"]),
                 "o": (o, s3["o"]), "h2": (h2, s3["h2"]),
                 "probe o": (probe["o"], o), "probe h2": (probe["h2"], h2)}
        diff3 = {k: (a != c).flatten(1).any(1).float().mean().item()
                 for k, (a, c) in pairs.items()}
        anchor = anchor_verdict(f"K3f fp32 B={b}", last, wl, rec, k3f, heads,
                                dh)
        k3[str(b)] = {"differ": diff3, "anchor": anchor}
        print(f"recompute, K3b fp32 (the 2d BC policy's last block, B={b}):"
              " the probe's output equals K3f's; frames whose value in K3b's"
              " pass differs from K3f's: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in diff3.items()), flush=True)
        check(not any(diff3.values()), f"phase 13b fp32, B={b}: K3b's "
              f"recompute or slots differ from K3f's forward: {diff3}")
    worst = {k: max(v[k] for v in out.values()) for k in differ}
    return {"differ": worst, "anywhere": max(worst.values()),
            "by_batch": out, "K3b": k3}


def phase_trunk_grad_fp32(default_run):
    """Phase 14b: one fp32 update on the trunk-gradient route through the
    kernels against the same update through the plain versions on the
    card, and against the default-route update from the same state."""
    import numpy as np

    g = np.load(GOLDEN_SAC)
    counters = kernel_counters()
    with trunk_grad_switch():
        before = {k: fn.launches for k, fn in counters.items()}
        counters["K4"].cluster_launches = 0
        kern = golden_update(DEVICE, g)
        check(all(counters[k].launches - before[k] == n
                  for k, n in PER_UPDATE_TRUNK.items()),
              "the fp32 trunk-gradient update did not go through K4 and K6")
        # K4's recording forwards (one a K6) write K6's streams on the FMA
        # body; its no-grad forwards take the fp32 cluster form
        cluster = counters["K4"].cluster_launches
        recording = PER_UPDATE_TRUNK["K4"] - cluster
        print(f"fp32 trunk-gradient update: K4 {PER_UPDATE_TRUNK['K4']} "
              f"launches, {cluster} on the fp32 cluster form, {recording} "
              f"recording on the FMA body (K6 {PER_UPDATE_TRUNK['K6']})",
              flush=True)
        check(recording == PER_UPDATE_TRUNK["K6"], "the fp32 trunk-gradient "
              f"update's recording K4 did not take the FMA body ({cluster} "
              "cluster launches)")
        before = {k: fn.launches for k, fn in counters.items()}
        with plain_kernels():
            plain = golden_update(DEVICE, g)
        check(all(fn.launches == before[k] for k, fn in counters.items()),
              "the plain fp32 trunk-gradient update launched a kernel")
    worst = {}
    for name, ref in (("plain versions on the card", plain),
                      ("default-route update", default_run)):
        bad, rel = update_mismatches(kern, ref)
        gerr = max(((a - ref["grads"][n]).abs().max()
                    / ref["grads"][n].abs().max().clamp(min=1e-30)).item()
                   for n, a in kern["grads"].items())
        pmax = max((a - ref["params"][n]).abs().max().item()
                   for n, a in kern["params"].items())
        print(f"fp32 trunk-gradient update vs the {name}: largest relative "
              f"differences {rel}; grads max|err|/L {gerr:.3e}; parameters "
              f"max|diff| {pmax:.3e}", flush=True)
        check(not bad, f"the fp32 trunk-gradient update disagrees with the "
              f"{name}: {bad}")
        check(gerr <= SAC_RTOL, f"the fp32 trunk-gradient update's grads "
              f"disagree with the {name}")
        check(pmax <= 2.2e-3, f"the fp32 trunk-gradient update's parameters"
              f" disagree with the {name}")
        worst[name] = rel
    return worst


def pad_keys(t, multiple=8):
    """Zero rows appended to the token axis (-2) up to a multiple."""
    import torch.nn.functional as F

    return F.pad(t, (0, 0, 0, -t.shape[-2] % multiple))


def section_inputs(nets, dtype, batch, n, rng):
    """K7's arguments as the composed block hands them over: the actor's
    embedded stream of seeded frames through its first block's attention
    norm (for more than 65 tokens the stream repeated), and that block's
    projection weights, in a compute dtype."""
    import torch

    from dgvit_tpu_torch.ops.fused_transformer import _ln

    blk = nets[dtype]["actor"].trans.transformer.blocks[0]
    x = train_inputs(nets[dtype], batch, rng)["actor"]["x"]
    x = x.repeat(1, -(-n // x.shape[1]), 1)[:, :n]
    with torch.no_grad():
        h = _ln(x.float(), blk.attn_norm_scale, blk.attn_norm_bias).to(
            x.dtype).contiguous()
    return [h, *[getattr(blk, k).detach().to(x.dtype).contiguous()
                 for k in ("wqkv", "wout", "bout")]]


# K7's wrong rounding points (k7_unrounded), each held to the bf16 limits
# over K7's bf16 cases pooled, as phase 5 holds its wrong versions
K7_ROUNDING = {"fp32 probabilities": "p", "o not rounded": "o"}
# K8's wrong rounding points (k8_rounded): the TPU kernel keeps the scores
# and the probabilities in fp32 up to P.V's fp32 sum
K8_ROUNDING = {"bf16 probabilities": "p", "bf16 scores": "s"}


def k8_rounded(what):
    """A wrong bf16 K8: its plain version (`attention_plain`) with the
    probabilities ("p") or the scores ("s") rounded to the inputs' dtype,
    as `_launch` takes its arguments."""
    import torch

    def attend(q, k, v, scale):
        q32, k32, v32 = q.float(), k.float(), v.float()
        dots = (q32 @ k32.transpose(-1, -2)) * scale
        if what == "s":
            dots = dots.to(q.dtype).float()
        e = torch.exp(dots - dots.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        if what == "p":
            p = p.to(q.dtype).float()
        return (p @ v32).to(q.dtype)
    return attend


def k8_fma(q, k, v, scale):
    """The fp32 K8's first design (attention_kernel: FMA loops, K and V of
    the whole head in shared memory) through the library's measurement
    entry, attention_fma_launch: no route launches it, this script times it
    beside attention_tf32_kernel, which replaced it."""
    import torch

    from dgvit_tpu_torch.ops.attention import _attention_lib

    out = torch.empty_like(q)
    b, h, n, d = q.shape
    err = _attention_lib().attention_fma_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, n,
        d, scale, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"the fp32 K8's FMA kernel failed to launch ({err})")
    return out


def k8_f32_reading(where, label, out, ref, grads, ref_grads, args, scale,
                   wrongs):
    """The fp32 K8 check (max|err| <= TRAIN_F32_MAX L, forward and
    backward) on one case, with rule (a) of EXACT_K's note: the
    float64-sum version of attention_plain must pass it and each wrong
    version fail it. Returns (ok, the printed reading) and records the
    reading (each statistic over its limit: passing at 1)."""
    from dgvit_tpu_torch.ops import attention as att

    L = max(ref.float().abs().max().item(), 1e-30)
    lim = TRAIN_F32_MAX * L
    over = lambda t: (t.float() - ref.float()).abs().max().item() / lim
    ex = exact(lambda *a: att.attention_plain(*a, scale), *args)
    reads = {"K8": over(out), "K8 backward": rel_max(grads, ref_grads)
             / TRAIN_F32_MAX, "float64 sums": over(ex),
             **{name: over(w) for name, w in wrongs.items()}}
    record("K8 fp32", where=where, shape=label, readings=reads)
    ok = max(reads["K8"], reads["K8 backward"]) <= 1
    check(reads["float64 sums"] <= 1, f"the float64-sum version of K8's "
          f"plain version fails its fp32 check ({where} {label})")
    for name in wrongs:
        check(reads[name] > 1, f"K8's fp32 check passes a wrong version "
              f"({name}, {where} {label})")
    return ok, "; over the limit (passing at 1): " + ", ".join(
        f"{n} {r:.3e}" for n, r in reads.items())


def phase_attention(nets, rng):
    """Phase 15: K7 and K8 against their plain versions, forward and
    backward, and wrong versions that must fail; K7's bf16 tensor-core
    form at 65 tokens (its FMA kernel at 256, in fp32 and for an unaligned
    x), and the float64-sum version of K7's plain version held to the bf16
    check (EXACT_K's rule (a))."""
    import torch

    from dgvit_tpu_torch.ops.attention import (attention_fused,
                                               attention_plain)
    from dgvit_tpu_torch.ops.fused_block import (attention_section_plain,
                                                 fused_attention_section,
                                                 tensor_core_section)

    dev = torch.device(DEVICE)
    draw = lambda shape, dt: torch.from_numpy(rng.standard_normal(
        shape).astype("float32")).to(dev).to(dt)
    cases = []      # (kernel, label, dtype, fn, plain, args, wrongs)
    args_scale = {}  # K8's scale by label
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for b, n in SECTION_SHAPES:
            x, *w = section_inputs(nets, dtype, b, n, rng)
            wrongs = {}
            if n % 8:
                wrongs["padded keys not masked"] = lambda x, *w: \
                    attention_section_plain(pad_keys(x), *w, 4, 64)[
                        :, :x.shape[1]]
            wrongs["scale 1 / dim_head"] = lambda x, wqkv, wout, bout: \
                attention_section_plain(
                    x, torch.cat([wqkv[:, :256] / 8, wqkv[:, 256:]], 1).to(
                        x.dtype), wout, bout, 4, 64)
            cases.append(("K7", f"({b}, {n}, 64)", dtype,
                          lambda *a: fused_attention_section(*a, 4, 64),
                          lambda *a: attention_section_plain(*a, 4, 64),
                          [x, *w], wrongs))
        for shape in ATTN_SHAPES:
            scale = shape[-1] ** -0.5
            args_scale[str(shape)] = scale
            args = [draw(shape, dt) for _ in range(3)]
            wrongs = {"scale 1 / D": lambda q, k, v, s=scale:
                      attention_plain(q, k, v, s * s)}
            if shape[2] % 8:
                wrongs["padded keys not masked"] = lambda q, k, v, s=scale: \
                    attention_plain(q, pad_keys(k), pad_keys(v), s)
            cases.append(("K8", str(shape), dtype,
                          lambda *a, s=scale: attention_fused(*a, s),
                          lambda *a, s=scale: attention_plain(*a, s),
                          args, wrongs))
    pooled = {k: TrainErrors() for k in ("K7", "K8")}
    pooled_bwd = {k: TrainErrors() for k in ("K7", "K8")}
    k7_exact, k7_wrong = TrainErrors(), {w: TrainErrors() for w in K7_ROUNDING}
    worst = {}
    for kernel, label, dtype, fn, plain, args, wrongs in cases:
        if kernel == "K7":
            mma = dtype == "bfloat16" and args[0].shape[1] <= 80
            form = "tensor-core" if mma else "FMA"
            check(tensor_core_section(*args[:3], 64) == mma, f"K7 {label} "
                  f"{dtype} would not take the {form} form")
        out = fn(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        check(out.shape == ref.shape and out.dtype == ref.dtype and
              bool(torch.isfinite(out.float()).all()),
              f"{kernel} {label} {dtype}: shape, dtype or non-finite")
        # the backward: the kernel route's recompute against autograd of
        # the plain version, on the same seeded output gradient
        dy = draw(tuple(out.shape), out.dtype)
        leaves = [t.detach().requires_grad_() for t in args]
        grads = torch.autograd.grad(fn(*leaves), leaves, dy)
        leaves = [t.detach().requires_grad_() for t in args]
        ref_grads = torch.autograd.grad(plain(*leaves), leaves, dy)
        scale = ref.float().abs().max().item()
        err = (out.float() - ref.float()).abs().max().item()
        key = (kernel, dtype)
        worst[key] = max(worst.get(key, 0.0), err)
        gerr = max(((a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp(min=1e-30)).item()
                   for a, b in zip(grads, ref_grads))
        line = (f"{kernel} vs plain {dtype} {label}: max|err| {err:.3e} "
                f"(max|ref| {scale:.3e}), backward max|err|/L {gerr:.3e}")
        if dtype == "float32":
            ok = err <= TRAIN_F32_MAX * scale and gerr <= TRAIN_F32_MAX
            fails = lambda t: ((t.float() - ref.float()).abs().max().item()
                               > TRAIN_F32_MAX * scale)
            if kernel == "K8":
                ok, reading = k8_f32_reading(
                    "phase 15", label, out, ref, grads, ref_grads, args,
                    args_scale[label], {n: w(*args)
                                        for n, w in wrongs.items()})
                line += reading
        else:
            e, eb = TrainErrors(), TrainErrors()
            e.add([(out, ref)])
            eb.add(zip(grads, ref_grads))
            pooled[kernel].add([(out, ref)])
            pooled_bwd[kernel].add(zip(grads, ref_grads))
            ok = e.ok and eb.ok
            line += f", mean|err|/L {e.mean:.3e}"

            def fails(t):
                w = TrainErrors()
                w.add([(t, ref)])
                return not w.ok
            if kernel == "K7":
                k7_exact.add([(exact(plain, *args), ref)])
                for name, what in K7_ROUNDING.items():
                    k7_wrong[name].add([(k7_unrounded(what)(*args, 4, 64),
                                         ref)])
        for name, wrong in wrongs.items():
            bad = wrong(*args)
            caught = fails(bad)
            line += (f"; wrong ({name}) max|err| "
                     f"{(bad.float() - ref.float()).abs().max().item():.3e}"
                     f" {'fails' if caught else 'PASSES'}")
            check(caught, f"{kernel}'s limits pass a wrong version "
                  f"({name}, {dtype} {label})")
        print(line + f" {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{kernel} disagrees with its plain version "
              f"({dtype} {label})")
    for kernel in pooled:
        for what, e in (("forward", pooled[kernel]),
                        ("backward", pooled_bwd[kernel])):
            print(f"{kernel} {what} bf16 cases pooled: mean|err|/L "
                  f"{e.mean:.3e} (limit {TRAIN_BF16_MEAN:.3e}) "
                  f"{'ok' if e.ok else 'FAIL'}", flush=True)
            check(e.ok, f"{kernel} {what} disagrees (bf16 pooled)")
    for name, e in [("float64 sums", k7_exact), *k7_wrong.items()]:
        print(f"K7's plain version with {name} vs its plain version, bf16 "
              f"cases pooled: mean|err|/L {e.mean:.3e} (limit "
              f"{TRAIN_BF16_MEAN:.3e}), every max within 2^-6 L: "
              f"{e.max_ok}; {'passes' if e.ok else 'fails'}", flush=True)
    record("K7 bf16", limit=TRAIN_BF16_MEAN, readings=verdicts(
        {"K7": pooled["K7"], "float64 sums": k7_exact, **k7_wrong}))
    check(k7_exact.ok, "the float64-sum version of K7's plain version fails "
          "its bf16 check (EXACT_K's rule (a))")
    for name, e in k7_wrong.items():
        check(not e.ok, f"K7's bf16 limits pass a wrong version ({name})")
    # the FMA kernel at the tensor-core widths: an unaligned x
    x, *w = next(a for k, _, dt, _, _, a, _ in cases
                 if k == "K7" and dt == "bfloat16" and a[0].shape[1] <= 80)
    xu = off_by_one(x)
    check(not tensor_core_section(xu, *w[:2], 64), "K7 with an unaligned x "
          "would take the tensor-core form")
    e = TrainErrors()
    e.add([(fused_attention_section(xu, *w, 4, 64),
            attention_section_plain(x, *w, 4, 64))])
    print(f"K7 bf16, x unaligned, FMA kernel: vs plain mean|err|/L "
          f"{e.mean:.3e}, every max within 2^-6 L: {e.max_ok} "
          f"{'ok' if e.ok else 'FAIL'}", flush=True)
    check(e.ok, "K7's FMA kernel (x unaligned) disagrees with its plain "
          "version")
    return worst


def composed_routes(pol, forward, composition=None, wrong=None):
    """Lead l's readings of one bf16 composed-route pass (`forward`, no
    grad, its masks from a generator it seeds itself) through `pol`:
    {variant: (output, [each block's output], [each dropout's kept
    mask])} for the kernels, their plain versions (`plain_kernels`), the
    float64-sum version of that (`exact_sums`), each wrong version
    (`wrong`: {name: a factory of the context that swaps a wrong rounding
    point into the plain route}), and the composition (the same pass with
    the section composed in PyTorch, as on the CPU; or `composition`,
    (another model, its pass)) and its float64-sum version.
    Also the largest |K7 output - attention_section_plain on the same
    inputs| / L over the pass's K7 calls, which K7's backward
    differentiates (as the JAX kernel's backward differentiates its XLA
    twin)."""
    import torch

    from dgvit_tpu_torch.models import layers
    from dgvit_tpu_torch.ops import fused_block as fb

    out, rec = {}, {}
    real_dropout, real_launch = layers.dropout, fb._launch

    def dropout(x, rate, generator):
        y = real_dropout(x, rate, generator)
        rec["masks"].append((y != 0, x != 0))   # kept, where x is not 0
        return y

    def launch(x, wqkv, wout, bout, heads, dim_head):
        y = real_launch(x, wqkv, wout, bout, heads, dim_head)
        ref = fb.attention_section_plain(x, wqkv, wout, bout, heads,
                                         dim_head)
        rec["k7"] = max(rec["k7"], rel_max([y], [ref]))
        return y

    def run(name, fn, *modes, model=pol):
        rec.update(blocks=[], masks=[], k7=0.0)
        hooks = [b.register_forward_hook(
            lambda m, i, o: rec["blocks"].append(o.detach().clone()))
            for b in model.trans.transformer.blocks]
        try:
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.no_grad())
                stack.enter_context(swapped(layers, "dropout", dropout))
                for mode in modes:
                    stack.enter_context(mode)
                y = fn().detach().clone()
        finally:
            for h in hooks:
                h.remove()
        out[name] = (y, rec["blocks"], rec["masks"])
        return rec["k7"]

    k7_backward = run("kernels", forward, swapped(fb, "_launch", launch))
    run("plain", forward, plain_kernels())
    run("float64 sums", forward, plain_kernels(), exact_sums())
    for name, mode in (wrong or {}).items():
        run(name, forward, plain_kernels(), mode())
    if composition is None:
        off = lambda: swapped(layers, "_on_card", lambda t: False)
        run("composition", forward, off())
        run("composition, float64 sums", forward, off(), exact_sums())
    else:
        model, comp = composition
        run("composition", comp, model=model)
        run("composition, float64 sums", comp, exact_sums(), model=model)
    out["k7_backward"] = k7_backward
    return out


def composed_verdict(what, routes, view, old, relative) -> bool:
    """Lead l's restated bf16 check of a composed route (EXACT_K): the
    kernels' route against the float64-sum version of its plain route, the
    pooled mean |err| / L (`pooled_rel`, each tensor's own L) over the
    route's output (`view`) and every block's output, under max(2^-18,
    EXACT_K["composed"] x the plain route's own reading); every wrong
    version in `routes` must read over that limit. The route's max|err|
    (over the largest |value| when `relative`) is held to max(2^-4,
    EXACT_K["composed"] x the plain route's), where the old check held it
    to the composition (`old`, printed beside). Also prints the
    composition's own distance to its float64-sum version and to the
    route's, whether the dropout masks of the kernels' pass and the
    composition's agree, and block by block the largest distances over
    the frame that moved most."""
    exact_route = routes["float64 sums"]
    ref = view(exact_route[0])
    scale = ref.abs().max().item() if relative else 1.0
    dist = lambda a, b: (view(a) - view(b)).abs().max().item() / scale
    d = {name: dist(routes[name][0], exact_route[0])
         for name in ("kernels", "plain", "composition")}
    d["composition vs its float64 sums"] = dist(
        routes["composition"][0], routes["composition, float64 sums"][0])
    d["the float64 sums of both"] = dist(
        exact_route[0], routes["composition, float64 sums"][0])
    limit = max(COMPOSED_BF16, EXACT_K["composed"] * d["plain"])
    tensors = lambda r: [view(r[0]), *r[1]]
    names = [n for n in routes if n not in (
        "float64 sums", "composition", "composition, float64 sums",
        "k7_backward")]
    pooled = {n: pooled_rel(tensors(routes[n]), tensors(exact_route))
              for n in names}
    pooled_limit = max(TRAIN_BF16_MEAN, EXACT_K["composed"] * pooled["plain"])
    wrong = {n: v / pooled_limit for n, v in pooled.items()
             if n not in ("kernels", "plain")}
    masks = [routes[name][2] for name in ("kernels", "composition")]
    # the kept elements agree wherever neither pass's input is exactly 0
    same_masks = len(masks[0]) == len(masks[1]) and all(
        bool(((ka == kb) | ~(na & nb)).all())
        for (ka, na), (kb, nb) in zip(*masks))
    frame = (view(routes["kernels"][0]) - view(routes["composition"][0])
             ).abs().flatten(1).amax(1).argmax().item()
    by_block = []
    for i, blk in enumerate(exact_route[1]):
        s = blk[frame].float().abs().max().item() or 1.0
        by_block.append({name: (routes[name][1][i][frame].float()
                                - blk[frame].float()).abs().max().item() / s
                         for name in ("kernels", "plain", "composition")})
    pooled_ok = pooled["kernels"] <= pooled_limit
    ok = pooled_ok and d["kernels"] <= limit
    k = EXACT_K["composed"]
    print(f"{what}: the kernels' route vs its float64-sum version, pooled "
          f"mean|err|/L over the output and the {len(exact_route[1])} "
          f"blocks' outputs {pooled['kernels']:.3e} (limit max(2^-18, {k:g}"
          f" x the plain route's {pooled['plain']:.3e}) = "
          f"{pooled_limit:.3e}) {'ok' if pooled_ok else 'FAIL'}; the wrong "
          "versions over that limit: " + ", ".join(
              f"{n} {v:.3f} {'fails' if v > 1 else 'PASSES'}"
              for n, v in wrong.items())
          + f"; max|err| {d['kernels']:.3e} (limit max(2^-4, {k:g} x "
          f"the plain route's {d['plain']:.3e}) = {limit:.3e}) "
          f"{'ok' if d['kernels'] <= limit else 'FAIL'}; old reading vs the "
          f"composition {old:.3e} (limit 2^-4); the composition vs the "
          f"float64 sums {d['composition']:.3e}, vs its own "
          f"{d['composition vs its float64 sums']:.3e}; the two "
          f"float64-sum versions apart "
          f"{d['the float64 sums of both']:.3e}; dropout masks of the two "
          f"passes equal: {same_masks} ({len(masks[0])} each); K7 output "
          f"vs its plain version on its inputs (what its backward "
          f"differentiates) {routes['k7_backward']:.3e} L", flush=True)
    print(f"{what}, frame {frame} (the one the composition moved most), "
          "block outputs vs the float64-sum version, max|err| over the "
          "frame's largest |value|: " + "; ".join(
              f"block {i}: " + ", ".join(f"{k} {v:.2e}" for k, v in b.items())
              for i, b in enumerate(by_block)), flush=True)
    record("composed", what=what, kernels=d["kernels"], plain=d["plain"],
           limit=limit, pooled=pooled, pooled_limit=pooled_limit,
           wrong=wrong, old=old, composition=d["composition"],
           composition_own=d["composition vs its float64 sums"],
           exact_apart=d["the float64 sums of both"], masks=same_masks,
           k7_backward=routes["k7_backward"], by_block=by_block)
    for n, v in wrong.items():
        check(v > 1, f"{what}: the restated limit passes a wrong version "
              f"({n})")
    return ok and same_masks


def phase_composed(cfg, flat, policies, rng):
    """Phase 16, main paths: the composed routes through the model."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.models import (build_actor, layers,
                                        params_from_jax)
    from dgvit_tpu_torch.models.got import GoT
    from dgvit_tpu_torch.ops import attention as att
    from dgvit_tpu_torch.ops import fused_block as fb

    dev = torch.device(DEVICE)
    counters = kernel_counters()

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()}

    def only(**want):
        return {k: want.get(k, 0) for k in counters}

    obs = torch.from_numpy(rng.uniform(0, 1, (SAC_BATCH, 128, 160)).astype(
        np.float32)).to(dev)
    goal = torch.from_numpy(np.stack(
        [rng.uniform(0, 1, SAC_BATCH), rng.uniform(-1, 1, SAC_BATCH)],
        axis=1).astype(np.float32)).to(dev)
    sd = params_from_jax(flat)
    launches = {}

    # (a) K7: the flagship actor with block dropout 0.1 in its GoT (no
    # config hands `dropout` on, in either package): a training forward
    # and backward at B=256, against the same pass with the section
    # composed in PyTorch (as on the CPU) and the same masks
    m = cfg.model
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        pol = build_actor(cfg, dtype=dt)
        pol.trans = GoT(image_size=tuple(m.image_size),
                        patch_size=tuple(m.patch_size), dim=m.latent_size,
                        depth=m.block, heads=m.head, dim_head=m.dim_head,
                        mlp_dim=m.mlp_dim, emb_dropout=m.emb_dropout,
                        dropout=0.1, dtype=dt)
        pol.load_state_dict(sd)
        pol = pol.to(dev).train()

        def train_pass():
            for p in pol.parameters():
                p.grad = None
            mean, log_std = pol(obs, goal, deterministic=False,
                                generator=torch.Generator(dev).manual_seed(
                                    SEED))
            (mean.float().square().mean()
             + log_std.float().mean()).backward()
            return mean.detach().float()

        if dtype == "bfloat16":
            routes = composed_routes(pol, lambda: pol(
                obs, goal, deterministic=False,
                generator=torch.Generator(dev).manual_seed(SEED))[0],
                wrong={f"K7 with {name}": (
                    lambda what=what: swapped(fb, "_launch",
                                              k7_unrounded(what)))
                    for name, what in K7_ROUNDING.items()})
        mean, got = counted(train_pass)
        grads = {n: p.grad.detach().clone()
                 for n, p in pol.named_parameters()}
        check(got == only(K7=4),
              f"GoT(dropout=0.1) launched {got}, expected K7 x4")
        check(all(bool(torch.isfinite(g).all()) for g in grads.values())
              and all(g.abs().max().item() > 0 for n, g in grads.items()
                      if "trans" in n),
              "GoT(dropout=0.1): a parameter's gradient is missing or "
              "non-finite")
        on_card = layers._on_card
        layers._on_card = lambda t: False
        try:
            mean_ref, l_ref = counted(train_pass)
        finally:
            layers._on_card = on_card
        check(l_ref == only(), f"the composed reference launched {l_ref}")
        gerr, worst_name = max(
            (((p.grad - grads[n]).abs().max()
              / grads[n].abs().max().clamp(min=1e-30)).item(), n)
            for n, p in pol.named_parameters())
        scale = mean_ref.abs().max().item()
        err = (mean - mean_ref).abs().max().item()
        print(f"GoT(dropout=0.1) in the flagship policy, {dtype} "
              f"B={SAC_BATCH}, training forward and backward: launches "
              f"{got}; means vs the PyTorch composition {err:.3e} "
              f"(max|mean| {scale:.3e}), grads max|err|/L {gerr:.3e} "
              f"({worst_name})", flush=True)
        if dtype == "bfloat16":
            launches["dropout"] = got
            check(torch.equal(routes["kernels"][0], mean),
                  "GoT(dropout=0.1), bf16: the traced pass is not the "
                  "training pass")
            check(composed_verdict("GoT(dropout=0.1) bf16 means", routes,
                                   lambda t: t.float(), err / scale, True),
                  "GoT(dropout=0.1), bf16: the K7 route's means leave its "
                  "float64-sum version's")
            # K7 takes its tensor-core form here (65 tokens, 4 x 64 heads)
            check_profile(train_pass, {"attn_section_mma_kernel": 4,
                                       "attn_section_kernel": 0},
                          "GoT(dropout=0.1) bf16 training pass",
                          "GoT(dropout=0.1) bf16 training pass")
        else:
            check(err <= COMPOSED_FP32 * scale and gerr <= COMPOSED_FP32_GRAD,
                  "GoT(dropout=0.1), fp32: the K7 route leaves the "
                  "composition")

    # (b) K8 by name: build_actor(cfg, attn_impl="pallas"), deterministic
    # acting forward at B=256, against the same model composed in PyTorch
    # (attn_impl="xla") and against the K1 route with the same weights
    for dtype, limit, limit_k1 in (
            ("bfloat16", COMPOSED_BF16, COMPOSED_BF16_VS_FUSED),
            ("float32", COMPOSED_FP32, COMPOSED_FP32)):
        pols = {}
        for impl in ("pallas", "xla"):
            pols[impl] = build_actor(cfg, dtype=getattr(torch, dtype),
                                     attn_impl=impl)
            pols[impl].load_state_dict(sd)
            pols[impl] = pols[impl].to(dev).eval()
        with torch.no_grad():
            (mean, _), got = counted(lambda: pols["pallas"](
                obs, goal, inference=True))
            (comp, _), l_comp = counted(lambda: pols["xla"](
                obs, goal, inference=True))
            (ref, _), l_ref = counted(lambda: policies[dtype](
                obs, goal, inference=True))
            if dtype == "bfloat16":
                routes = composed_routes(
                    pols["pallas"], lambda: pols["pallas"](
                        obs, goal, inference=True)[0],
                    (pols["xla"], lambda: pols["xla"](
                        obs, goal, inference=True)[0]),
                    wrong={f"K8 with {name}": (
                        lambda what=what: swapped(att, "_launch",
                                                  k8_rounded(what)))
                        for name, what in K8_ROUNDING.items()})
        act = lambda t: torch.tanh(t.float())
        err = (act(mean) - act(comp)).abs().max().item()
        err_k1 = (act(mean) - act(ref)).abs().max().item()
        print(f"build_actor(attn_impl='pallas') {dtype} B={SAC_BATCH}, "
              f"acting forward: launches {got}; actions vs "
              f"attn_impl='xla' max|diff| {err:.3e} (limit {limit:.3e}), "
              f"vs the K1 route {err_k1:.3e} (limit {limit_k1:.3e})",
              flush=True)
        check(got == only(K8=4) and l_comp == only()
              and l_ref == only(K1=1),
              f"attn_impl='pallas' launched {got}, 'xla' {l_comp}, the "
              f"default actor {l_ref}; expected K8 x4, nothing, K1 x1")
        if dtype == "bfloat16":
            check(composed_verdict("attn_impl='pallas' bf16 actions",
                                   routes, act, err, False)
                  and err_k1 <= limit_k1,
                  f"attn_impl='pallas' ({dtype}): actions leave their "
                  "float64-sum version's or the K1 route's")
        else:
            check(err <= limit and err_k1 <= limit_k1,
                  f"attn_impl='pallas' ({dtype}): actions leave the "
                  "composition's or the K1 route's")
        if dtype == "bfloat16":
            launches["pallas"] = got

    # (c) K8 by shape: model.patch_size (8, 10) gives 257 tokens, over
    # every fused limit; auto picks the kernel on the card
    cfg257 = Config.from_dict({"model": {"patch_size": [8, 10]}})
    b = 64
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        pols = {}
        for impl in ("auto", "xla"):
            pols[impl] = build_actor(
                cfg257, dtype=dt, attn_impl=impl,
                generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
        with torch.no_grad():
            (mean, _), got = counted(lambda: pols["auto"](
                obs[:b], goal[:b], inference=True))
            (ref, _), l_ref = counted(lambda: pols["xla"](
                obs[:b], goal[:b], inference=True))
        err = (mean.float() - ref.float()).abs().max().item()
        limit = COMPOSED_BF16 if dtype == "bfloat16" else COMPOSED_FP32
        print(f"patch_size (8, 10), 257 tokens, {dtype} B={b}, acting "
              f"forward: launches {got}; mean vs attn_impl='xla' "
              f"{err:.3e} (limit {limit:.3e}, max|mean| "
              f"{ref.float().abs().max().item():.3e})", flush=True)
        check(got == only(K8=4) and l_ref == only(),
              f"257 tokens launched {got} (xla: {l_ref}); expected K8 x4")
        check(bool(torch.isfinite(mean.float()).all()) and err <= limit,
              f"257 tokens ({dtype}): means leave the composition's")
        if dtype == "bfloat16":
            launches["auto_257"] = got
    return launches


# --------------------------------------------------------------------------
# long frames: the route rule of ops/smem.py
# --------------------------------------------------------------------------

LONG_TOKENS, LONG_BATCH = (90, 129, 256), 32
# GoT.forward's fused routes by the kernels each runs, and their launches
# in one call (a 4-block trunk)
LONG_ROUTES = {"acting": ("K1",), "learn forward": ("K4",),
               "gradient": ("K2f", "K2b", "K3f", "K3b"),
               "trunk gradient": ("K4", "K6")}
LONG_FUSED = {"acting": {"K1": 1}, "learn forward": {"K4": 1},
              "gradient": {"K2f": 3, "K2b": 3, "K3f": 1, "K3b": 1},
              "trunk gradient": {"K4": 1, "K6": 1}}


@contextlib.contextmanager
def no_smem_limit():
    """The route rule with no shared-memory limit: every fused route."""
    from dgvit_tpu_torch.ops import smem

    limit_for = smem.limit_for
    smem.limit_for = lambda device: None
    try:
        yield
    finally:
        smem.limit_for = limit_for


def long_got(trunk, n, dtype, trunk_grad):
    """The trained actor's trunk on a strip of n - 1 patches of 16x20 (a
    (16, 20 (n - 1)) frame), its positional embedding tiled to n tokens,
    as phase 5b stretches its frames."""
    import torch

    from dgvit_tpu_torch.models.got import GoT

    got = GoT(image_size=(16, 20 * (n - 1)), patch_size=(16, 20),
              dim=trunk.pos_embedding.shape[-1],
              depth=len(trunk.transformer.blocks), heads=trunk.heads,
              dim_head=trunk.dim_head,
              mlp_dim=trunk.transformer.blocks[0].w1.shape[1],
              final_norm=trunk.final_norm, emb_dropout=trunk.emb_dropout,
              trunk_grad=trunk_grad, dtype=getattr(torch, dtype))
    state = {k: v.detach().cpu() for k, v in trunk.state_dict().items()}
    pos = state["pos_embedding"]
    state["pos_embedding"] = pos.repeat(1, -(-n // pos.shape[1]), 1)[:, :n]
    got.load_state_dict(state)
    return got.to(DEVICE)


def long_call(got, route, img, tok, proj):
    """One call of a route: (the latent, {parameter: gradient}), the
    gradient of sum(latent * proj) for the gradient-bearing routes. The
    emb-dropout masks come from one seed."""
    import torch

    gen = torch.Generator(DEVICE).manual_seed(SEED)
    if route in ("acting", "learn forward"):
        with torch.no_grad():
            return got(img, tok, inference=True, generator=gen,
                       deterministic=route == "acting"), {}
    for p in got.parameters():
        p.grad = None
    out = got(img, tok, deterministic=False, generator=gen)
    (out.float() * proj).sum().backward()
    return out.detach(), {k: p.grad.clone()
                          for k, p in got.named_parameters()}


def long_design(route, n, dtype, dims, depth):
    """The route a call takes under the rule, and its launches: the fused
    route where its kernels hold the frame, else the per-block kernels
    where they hold it, else the composed blocks (K7 a block)."""
    import torch

    from dgvit_tpu_torch.ops import smem

    fits = lambda ks: smem.route_fits(ks, n, *dims, getattr(torch, dtype),
                                      torch.device(DEVICE))
    if fits(LONG_ROUTES[route]):
        return route, LONG_FUSED[route]
    per_block = ("gradient" if route in ("gradient", "trunk gradient")
                 else None)
    if per_block and fits(LONG_ROUTES[per_block]):
        return per_block, LONG_FUSED[per_block]
    if not per_block and fits(("K2f", "K3f")):
        return "per-block forward", {"K2f": depth - 1, "K3f": 1}
    return "composed", {"K7": depth}


def smem_mirror_mismatches():
    """Phase 17b (a): every byte count of ops/smem.py against the
    libraries' own queries, at 65, 90, 129 and 256 tokens, fp32 and bf16,
    the flagship widths and 2 x 32 heads with a 256-wide MLP."""
    import torch

    from dgvit_tpu_torch.ops import smem
    from dgvit_tpu_torch.ops.attention import _attention_lib
    from dgvit_tpu_torch.ops.fused_transformer import _block_lib
    from dgvit_tpu_torch.ops.got_megakernel import _kernel_lib

    g, b, a = _kernel_lib(), _block_lib(), _attention_lib()
    bad, count = [], 0
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        for n in (65, *LONG_TOKENS):
            for d, heads, dh, mlp in ((64, 4, 64, 2048), (64, 2, 32, 256)):
                w = (n, d, heads, dh, mlp)
                fma = smem.fwd_fma(n, d, heads, dh, mlp, dtype)
                pairs = [
                    ("K1/K4", fma, g.got_forward_smem(code, *w, 0)),
                    ("K4 mma", smem.fwd_mma(n),
                     g.got_forward_smem(code, *w, 1)),
                    ("K4 cluster fp32", smem.k1_cluster_fp32(n, 0),
                     g.got_forward_smem(code, *w, 3)),
                    ("K2f", fma, b.block_forward_smem(code, 0, *w, 0)),
                    ("K2f mma", smem.fwd_mma(n),
                     b.block_forward_smem(code, 0, *w, 1)),
                    ("K3f", fma, b.block_forward_smem(code, 1, *w, 0)),
                    ("K3f mma", smem.fwd_mma(n),
                     b.block_forward_smem(code, 1, *w, 1)),
                    ("K2f cluster fp32", smem.k1_cluster_fp32(n, 0),
                     b.block_forward_smem(code, 0, *w, 2)),
                    ("K2b cluster fp32", smem.bwd_cluster_fp32(n),
                     b.block_backward_smem(code, 0, *w, 2)),
                    ("K3f cluster fp32", smem.cls_attend_fp32(n),
                     b.block_forward_smem(code, 1, *w, 2)),
                    ("K3b cluster fp32", smem.cls_bwd_cluster_fp32(n),
                     b.block_backward_smem(code, 1, *w, 2)),
                    ("K3 fp32 CLS-row MLP", smem.CLS_MLP_FP32,
                     b.cls_mlp_smem()),
                    ("K2b", smem.bwd_fma(n, d, mlp),
                     b.block_backward_smem(code, 0, *w, 0)),
                    ("K2b mma", smem.bwd_mma(n),
                     b.block_backward_smem(code, 0, *w, 1)),
                    ("K3b", smem.bwd_fma(n, d, mlp),
                     b.block_backward_smem(code, 1, *w, 0)),
                    ("K3b mma", smem.bwd_cls_mma(n, heads, dh, mlp),
                     b.block_backward_smem(code, 1, *w, 1)),
                    ("K6", smem.trunk_bwd(*w, False),
                     b.trunk_backward_smem(code, *w, 0)),
                    ("K6 mma", smem.trunk_bwd(*w, True),
                     b.trunk_backward_smem(code, *w, 1)),
                    ("K7 one row", smem.section(n, d, dh, 1, dtype),
                     a.attention_section_smem(code, n, d, dh, 1, 0)),
                    ("K7 every row", smem.section(n, d, dh, n, dtype),
                     a.attention_section_smem(code, n, d, dh, n, 0)),
                    ("K7 mma", smem.section_mma(n),
                     a.attention_section_smem(code, n, d, dh, n, 1))]
                for pd in (320, 160):   # 16x20 and 8x20 patches
                    pairs += [
                        (f"K1 pd={pd}", fma, g.k1_smem(code, n, pd, d, heads,
                                                       dh, mlp, 0)),
                        (f"K1 mma pd={pd}", max(smem.fwd_mma(n),
                                                smem.k1_embed(pd)),
                         g.k1_smem(code, n, pd, d, heads, dh, mlp, 1)),
                        (f"K1 cluster pd={pd}", smem.k1_cluster(n, pd),
                         g.k1_smem(code, n, pd, d, heads, dh, mlp, 2)),
                        (f"K1 cluster fp32 pd={pd}",
                         smem.k1_cluster_fp32(n, pd),
                         g.k1_smem(code, n, pd, d, heads, dh, mlp, 3))]
                count += len(pairs)
                bad += [(what, str(dtype), w, py, lib)
                        for what, py, lib in pairs if py != lib]
    return count, bad


def phase_long_frames(flat, rng):
    """Phase 17b: frames of 90, 129 and 256 tokens through every route of
    the model, fp32 and bf16. Each call takes the route ops/smem.py picks
    (a fused route where its kernels hold the frame, else the composed
    blocks), launches what that route launches and nothing raises; its
    latent and gradients are held against the plain version of the same
    route on the same card (the kernels swapped for their plain versions:
    K7's too on the composed route) within phase 5's limits (latents) and
    phase 13's (gradients, chained through four blocks). Returns the
    routes taken and, at 129 tokens in bf16, how far the composed
    gradient route's latents sit from the fused plain chain."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.models import build_actor, params_from_jax
    from dgvit_tpu_torch.ops import fused_block as fb

    count, bad = smem_mirror_mismatches()
    print(f"shared-memory bytes, ops/smem.py against the libraries' "
          f"queries: {count} counts, {len(bad)} mismatches {bad}",
          flush=True)
    check(not bad, f"ops/smem.py disagrees with the libraries: {bad}")

    actor = build_actor(Config(), dtype=torch.float32)
    actor.load_state_dict(params_from_jax(flat))
    trunk = actor.trans
    b, dev = LONG_BATCH, torch.device(DEVICE)
    with torch.no_grad():
        tok = actor.fc_embed(torch.from_numpy(rng.uniform(
            -1, 1, (b, 2)).astype(np.float32))).to(dev)
    proj = torch.from_numpy(rng.standard_normal((b, 64)).astype(
        np.float32)).to(dev)
    dims = (trunk.pos_embedding.shape[-1], trunk.heads, trunk.dim_head,
            trunk.transformer.blocks[0].w1.shape[1])
    depth = len(trunk.transformer.blocks)
    counters = kernel_counters()

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()
                     if c.launches}

    out_errs = {r: TrainErrors() for r in LONG_ROUTES}
    grad_errs = {r: TrainErrors() for r in LONG_ROUTES}
    # bf16 against the float64-sum version of the route's plain version:
    # {route: {version: [latent errors, gradient errors]}}, and each call's
    # largest max|err|/L of the latent and of a gradient by version
    vs_exact, call_max = {}, []
    taken, composed_vs_fused = {}, None
    for dtype in ("bfloat16", "float32"):
        for n in LONG_TOKENS:
            img = torch.from_numpy(rng.uniform(
                0, 1, (b, 16, 20 * (n - 1))).astype(np.float32)).to(dev)
            models = {tg: long_got(trunk, n, dtype, tg)
                      for tg in (False, True)}
            for route in LONG_ROUTES:
                got = models[route == "trunk gradient"]
                label, want = long_design(route, n, dtype, dims, depth)
                (out, grads), seen = counted(
                    lambda: long_call(got, route, img, tok, proj))
                check(seen == want, f"{n} tokens {dtype} {route}: launched "
                      f"{seen}, the route rule designed {want}")
                with plain_kernels():
                    (ref, ref_grads), none = counted(
                        lambda: long_call(got, route, img, tok, proj))
                check(not none, f"the plain {route} route launched {none}")
                check(bool(torch.isfinite(out.float()).all())
                      and all(bool(torch.isfinite(g).all())
                              for g in grads.values()),
                      f"{n} tokens {dtype} {route}: non-finite values")
                pairs = [(grads[k], ref_grads[k]) for k in grads]
                if dtype == "float32":
                    e_out = (out - ref).abs().max().item() / max(
                        ref.abs().max().item(), 1e-30)
                    e_grad = max([(g - r).abs().max().item() / max(
                        r.abs().max().item(), 1e-30) for g, r in pairs],
                        default=0.0)
                    ok = e_out <= TRAIN_F32_MAX and e_grad <= K6_F32_MAX
                    stats = (f"latent max|err|/L {e_out:.3e} (limit "
                             f"{TRAIN_F32_MAX:.0e}), grads max|err|/L "
                             f"{e_grad:.3e} (limit {K6_F32_MAX:.0e})")
                else:
                    e_o, e_g = TrainErrors(), TrainErrors()
                    e_o.add([(out, ref)])
                    e_g.add(pairs)
                    out_errs[route].add([(out, ref)])
                    grad_errs[route].add(pairs)
                    versions = {"kernels": (out, grads),
                                "plain": (ref, ref_grads)}
                    if label == "composed":
                        for name, what in K7_ROUNDING.items():
                            with plain_kernels(), swapped(
                                    fb, "_launch", k7_unrounded(what)):
                                versions[f"K7 with {name}"] = long_call(
                                    got, route, img, tok, proj)
                    with plain_kernels(), exact_sums():
                        ex, ex_grads = long_call(got, route, img, tok, proj)
                    read = {}
                    for name, (o, g) in versions.items():
                        errs = vs_exact.setdefault(route, {}).setdefault(
                            name, [TrainErrors(), TrainErrors()])
                        errs[0].add([(o, ex)])
                        errs[1].add([(g[k], ex_grads[k]) for k in g])
                        read[name] = max([rel_max([o], [ex])] + [
                            rel_max([g[k]], [ex_grads[k]]) for k in g])
                    call_max.append({"call": f"{n} {route} ({label})",
                                     **read})
                    ok = True   # held below, against float64 sums
                    stats = (f"latent mean|err|/L {e_o.mean:.3e}, grads "
                             f"mean|err|/L "
                             f"{e_g.mean if pairs else 0.0:.3e}, old "
                             f"reading: every max within 2^-6 L: "
                             f"{e_o.max_ok and e_g.max_ok}; the largest "
                             "max|err|/L of the latent or a gradient "
                             "against float64 sums: " + ", ".join(
                                 f"{k} {v:.3e}" for k, v in read.items()))
                taken[f"{n} {dtype} {route}"] = label
                print(f"long frames, {n} tokens, {dtype}, {route}: route "
                      f"{label}, launches {seen}; vs the plain route: "
                      f"{stats} {'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"{n} tokens {dtype} {route}: the {label} route "
                      "disagrees with its plain version")
                if (n, dtype, route) == (129, "bfloat16", "gradient"):
                    with plain_kernels(), no_smem_limit():
                        fused, _ = long_call(got, route, img, tok, proj)
                    e = TrainErrors()
                    e.add([(out, fused)])
                    composed_vs_fused = {"max_abs": e.worst,
                                         "pooled_mean_rel": e.mean,
                                         "route": label}
                    print(f"  129 tokens bf16, the {label} gradient route "
                          f"against the fused plain chain (K2/K3's plain "
                          f"versions): latent max|err| {e.worst:.3e}, "
                          f"mean|err|/L {e.mean:.3e} (a record, not a "
                          "check)", flush=True)
    k = EXACT_K["long"]
    readings = {}
    for route in LONG_ROUTES:
        eo, eg = out_errs[route], grad_errs[route]
        old_ok = (eo.mean <= TRAIN_BF16_MEAN
                  and (eg.count == 0 or eg.mean <= K6_BF16_MEAN))
        errs = vs_exact[route]
        limits = [max(TRAIN_BF16_MEAN, k * errs["plain"][0].mean),
                  max(K6_BF16_MEAN, k * errs["plain"][1].mean
                      if eg.count else 0.0)]
        read = {name: {"latent": e[0].mean,
                       "grads": e[1].mean if eg.count else 0.0}
                for name, e in errs.items()}
        for name, r in read.items():
            r["ratio"] = max(r["latent"] / limits[0], r["grads"] / limits[1])
            r["pass"] = r["ratio"] <= 1.0
        readings[route] = {"limits": limits, "read": read}
        print(f"long frames, bf16 pooled, {route}: old reading vs the plain "
              f"route: latent mean|err|/L {eo.mean:.3e} (limit "
              f"{TRAIN_BF16_MEAN:.3e}), grads "
              f"{eg.mean if eg.count else 0.0:.3e} (limit "
              f"{K6_BF16_MEAN:.3e}) {'ok' if old_ok else 'FAIL'}; restated "
              f"vs float64 sums, limits max(2^-18, {k:g} x plain) = "
              f"{limits[0]:.3e} and max(2^-13, {k:g} x plain) = "
              f"{limits[1]:.3e}: " + ", ".join(
                  f"{name} {r['latent']:.3e} / {r['grads']:.3e} "
                  f"{'passes' if r['pass'] else 'fails'}"
                  for name, r in read.items()), flush=True)
        check(read["kernels"]["pass"], f"long frames, bf16 pooled, {route}: "
              "disagrees with the float64-sum version of the plain route")
    # a wrong K7 runs on every composed call; it fails the check where it
    # fails some route's pooled limits (on the draws of seeds 7-11 the
    # acting route alone, its only composed call the 256-token one, once
    # passed one)
    for name in K7_ROUNDING:
        name = f"K7 with {name}"
        worst = max(v["read"][name]["ratio"] for v in readings.values()
                    if name in v["read"])
        print(f"long frames, bf16, the wrong route ({name}): its largest "
              f"pooled reading over a route's restated limit {worst:.3f} "
              f"{'fails' if worst > 1 else 'PASSES'}", flush=True)
        check(worst > 1, "long frames, bf16: the restated limits pass a "
              f"wrong route ({name}) on every route")
    max_ok = True
    for c in call_max:
        limit = max(TRAIN_BF16_MAX, k * c["plain"])
        c["limit"] = limit
        max_ok &= c["kernels"] <= limit
        print(f"long frames, bf16, {c['call']}: the largest max|err|/L "
              f"against float64 sums, kernels {c['kernels']:.3e}, plain "
              f"{c['plain']:.3e} (limit max(2^-6, {k:g} x plain) = "
              f"{limit:.3e})" + "".join(
                  f", {n} {v:.3e}" for n, v in c.items()
                  if n.startswith("K7 with")), flush=True)
    record("long frames", k=k, routes=readings, calls=call_max)
    check(max_ok, "long frames, bf16: a call's max disagrees with the "
          "float64-sum version of the plain route")
    return {"routes": taken, "composed_vs_fused_129_bf16": composed_vs_fused}


def k6_work(batch, n=65, d=64, heads=4, dh=64, mlp=2048, depth=4, esize=2,
            records=False):
    """The least FLOPs and bytes of K4's backward from x, dy and K4's
    streams: the forward once (the blocks' inner activations are not
    given), two products for each of its products; x, dy, the streams
    and the weights read, dx and the weight gradients written, once
    each. With `records`, also the CLS block's fp32 records read (the
    port's design since fault k's repair)."""
    from dgvit_tpu_torch.ops.cls_block import cls_saved_width

    fwd, _ = train_work("K4", batch, n, d, heads, dh, mlp, depth, esize)
    inner = heads * dh
    w = d * 3 * inner + inner * d + 2 * d * mlp + mlp + 6 * d
    streams = (depth - 1) * batch * n * d + batch * d
    record = batch * cls_saved_width(n, d, heads, dh, mlp) * 4
    return 3 * fwd, ((2 * batch * n * d + batch * d + streams + 2 * depth * w)
                     * esize + 4 * d * 4 + (record if records else 0))


def section_library(x, wqkv, wout, bout, heads=4, dim_head=64):
    """K7's function as library calls (a yardstick, not a port): x @ wqkv,
    scaled_dot_product_attention, then @ wout + bout, each rounding to the
    compute dtype as PyTorch does."""
    import torch.nn.functional as F

    b, n, _ = x.shape
    q, k, v = (x @ wqkv).reshape(b, n, 3, heads, dim_head).permute(
        2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, scale=dim_head ** -0.5)
    return o.transpose(1, 2).reshape(b, n, heads * dim_head) @ wout + bout


def k7_work(batch, n, d=64, heads=4, dh=64, esize=2):
    inner = heads * dh
    flops = batch * (2 * n * d * 3 * inner + 4 * heads * n * n * dh
                     + 2 * n * inner * d)
    return flops, (2 * batch * n * d + d * 3 * inner + inner * d + d) * esize


def k8_bound(shape, dtype):
    """K8's bound: q, k, v read and o written once; in bf16, q k^T as one
    tensor-core pass and P.V as two (the fp32 probabilities split into two
    bf16 halves, each multiplied by V), all at the bf16 rate; in fp32, both
    products at the fp32 rate. (Pricing bf16 P.V at the fp32 rate, as this
    bound once did, put a kernel that keeps fp32-accurate probabilities on
    the tensor cores above 100% of its bound.)"""
    b, h, n, d = shape
    half = 2 * b * h * n * n * d
    passes = 3 if dtype == "bfloat16" else 2
    t_ops = passes * half / PEAK_FLOPS[dtype]
    t_bytes = 4 * b * h * n * d * (2 if dtype == "bfloat16" else 4) \
        / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_attention_times(nets, rng):
    """Phase 17: K6, K7, K8 and their plain versions, bf16, beside their
    bounds and, for K8, scaled_dot_product_attention (both also by device
    time)."""
    import torch
    import torch.nn.functional as F

    from dgvit_tpu_torch.ops.attention import (attention_fused,
                                               attention_plain)
    from dgvit_tpu_torch.ops.fused_block import (attention_section_plain,
                                                 fused_attention_section)
    from dgvit_tpu_torch.ops.trunk_train import (trunk_bwd_fused,
                                                 trunk_bwd_plain)

    dev = torch.device(DEVICE)
    rows = {}
    a = train_inputs(nets["bfloat16"], SAC_BATCH, rng)["actor"]
    args = with_streams((a["x"], a["dy3"], a["blocks"], a["fn"], a["heads"],
                         a["dh"], "rms"))
    bnd, by = bound_ms(*k6_work(SAC_BATCH), "bfloat16")
    rb, rby = bound_ms(*k6_work(SAC_BATCH, records=True), "bfloat16")
    rows["K6"] = dict(ms=cuda_ms(lambda: trunk_bwd_fused(*args), 3, runs=5),
                      plain_ms=cuda_ms(lambda: trunk_bwd_plain(*args), 1,
                                       runs=5),
                      bound_ms=bnd, bound_by=by, bound_with_records_ms=rb,
                      bound_with_records_by=rby, library_ms=None)
    rows["K7"] = {}
    for b, n in SECTION_SHAPES:
        x, *w = section_inputs(nets, "bfloat16", b, n, rng)
        bnd, by = bound_ms(*k7_work(b, n), "bfloat16")
        rows["K7"][f"({b}, {n}, 64)"] = t = dict(
            ms=cuda_ms(lambda: fused_attention_section(x, *w, 4, 64), 10,
                       runs=5),
            plain_ms=cuda_ms(lambda: attention_section_plain(x, *w, 4, 64),
                             5, runs=5),
            bound_ms=bnd, bound_by=by, library_ms=None,
            yardstick_ms=cuda_ms(lambda: section_library(x, *w), 10,
                                 runs=5))
        if n <= 80:   # the FMA kernel in this run: x unaligned
            xu = off_by_one(x)
            t["fma_ms"] = cuda_ms(lambda: fused_attention_section(
                xu, *w, 4, 64), 10, runs=5)
    rows["K8"] = {}
    for shape in ATTN_SHAPES:
        q, k, v = (torch.randn(shape, device=dev).bfloat16()
                   for _ in range(3))
        s = shape[-1] ** -0.5
        bnd, by = k8_bound(shape, "bfloat16")
        kern = lambda: attention_fused(q, k, v, s)
        lib = lambda: F.scaled_dot_product_attention(q, k, v, scale=s)
        rows["K8"][str(shape)] = dict(
            ms=cuda_ms(kern, 10, runs=5),
            plain_ms=cuda_ms(lambda: attention_plain(q, k, v, s), 5,
                             runs=5),
            bound_ms=bnd, bound_by=by, library_ms=cuda_ms(lib, 10, runs=5),
            device_ms=device_ms(kern), library_device_ms=device_ms(lib))
    # the fp32 K8 (attention_tf32_kernel) beside its first design, the FMA
    # attention_kernel, in this run
    rows["K8 fp32"] = {}
    for shape in ATTN_SHAPES:
        q, k, v = (torch.randn(shape, device=dev) for _ in range(3))
        s = shape[-1] ** -0.5
        bnd, by = k8_bound(shape, "float32")
        rows["K8 fp32"][str(shape)] = t = dict(
            ms=cuda_ms(lambda: attention_fused(q, k, v, s), 10, runs=5),
            fma_ms=cuda_ms(lambda: k8_fma(q, k, v, s), 10, runs=5),
            plain_ms=cuda_ms(lambda: attention_plain(q, k, v, s), 5,
                             runs=5),
            bound_ms=bnd, bound_by=by,
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=s), 10, runs=5))
        print(f"K8 fp32 {shape} ({card()}): kernel {t['ms']:.4f} ms, its "
              f"first design (the FMA attention_kernel) {t['fma_ms']:.4f} "
              f"ms, plain {t['plain_ms']:.4f} ms, bound {bnd:.5f} ms ({by}),"
              f" scaled_dot_product_attention {t['library_ms']:.4f} ms",
              flush=True)
    before = {"K6": {f"B={SAC_BATCH}": FMA_DESIGN_MS["K6"]},
              "K7": FMA_DESIGN_MS["K7"], "K8": FMA_DESIGN_MS["K8"]}
    print(f"K6 bf16 B={SAC_BATCH} on {card()}: {rows['K6']['ms']:.4f} ms on "
          f"K4's streams against {REPLACED_MS['K6']:.4f} ms with its FMA "
          f"forward chain "
          f"(recorded, not this run; now "
          f"{REPLACED_MS['K6'] / rows['K6']['ms']:.2f}x faster)", flush=True)
    for name, r in (("K6", {f"B={SAC_BATCH}": rows["K6"]}),
                    ("K7", rows["K7"]), ("K8", rows["K8"])):
        for label, t in r.items():
            lib = ("" if t["library_ms"] is None else
                   f", scaled_dot_product_attention {t['library_ms']:.4f} ms")
            was = before.get(name, {}).get(label)
            dev = ("" if "device_ms" not in t else
                   f"; device time (torch.profiler): kernel "
                   f"{t['device_ms']:.4f} ms, scaled_dot_product_attention "
                   f"{t['library_device_ms']:.4f} ms")
            more = "".join(
                f", {what} {t[key]:.5f} ms" for key, what in (
                    ("bound_with_records_ms", "bound with the CLS records"),
                    ) if key in t) + "".join(
                f", {what} {t[key]:.4f} ms" for key, what in (
                    ("fma_ms", "its FMA kernel (x unaligned)"),
                    ("yardstick_ms", "x @ wqkv, scaled_dot_product_attention"
                     ", @ wout + bout (three library calls)")) if key in t)
            print(f"{name} bf16 {label}: kernel {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
                  f"({t['bound_by']}){lib}{more}"
                  + ("" if was is None else earlier(t["ms"], was)) + dev,
                  flush=True)
    return rows



# --------------------------------------------------------------------------
# phase 19: the on-device training tier (the batched env, run_eval_vec,
# train_fused, train_vec)
# --------------------------------------------------------------------------

FUSED_LANES, FUSED_CHUNK, FUSED_RING = 16, 64, 8192
FUSED_ROUNDS, FUSED_UPDATES, FUSED_WORLD = 3, 16, "randm32"
VEC_TRAIN_CHUNKS = 2       # phase 19d: train_vec's chunks of FUSED_LANES
VEC_EVAL_EPISODES, VEC_EVAL_STEPS = 32, 300
# (actor, world) pairs of phase 19b: the flagship actor, which reaches no
# goal and hits nothing on rrc in 300 steps (its recorded evaluation,
# artifacts/r5/dr_randm32_s11_amin_rrc_eval.log, reads the same), and an
# actor of the same widths that reaches goals and collides there
# (artifacts/r5/drqc_rand8_amin_rrc_eval.log: 44 goals, 56 collisions in
# 100 episodes), so that the comparison has outcomes to compare
SECOND_ACTOR = ROOT / "artifacts" / "r5" / "drqc_rand8_amin_actor.npz"
VEC_EVAL_CASES = (("flagship", ACTOR, "rrc"),
                  ("drqc_rand8_amin", SECOND_ACTOR, "rrc"))
# the batched env on the card against the same env on the CPU: lanes,
# steps, and a max_steps cap that makes every lane reset several times
VEC_LANES, VEC_STEPS, VEC_MAX_STEPS = 16, 200, 60
# fp32 on both sides, the same operations; the card's sin/cos/atan2/acos
# may differ from the CPU's by an ulp or two, which a ray grazing a box
# carries furthest: an H100 read 1.4e-6 to 5.3e-5 of the image's [0, 1]
# on seeds 7-11 (chip_draws.py), poses 1.9e-6 to 3.8e-6
VEC_IMAGE_TOL = 1e-4


def scripted_commands(steps, lanes):
    """Command-unit [v, w] arcs (tests/test_torch_vec_env.py's), one phase
    a lane."""
    import numpy as np

    t = np.arange(steps)[:, None] + 3 * np.arange(lanes)[None, :]
    v = 0.12 + 0.05 * np.sin(t / 3.0)
    w = 0.4 * np.sin(t / 5.0)
    return (np.stack([v, w], axis=-1) * [6.0, 1.0]).astype(np.float32)


def phase_vec_env(seed=SEED):
    """Phase 19a: the batched env on the card against the port's host env
    (B=1, rrc, 128x160, 25 scripted steps, tests/test_torch_vec_env.py's
    tolerances) and against itself on the CPU (B=16, randm32 drawn from
    `seed`, 200 steps, lanes resetting every <= 60 steps): flags, record
    indices and steps exact, images and positions within VEC_IMAGE_TOL;
    then the ring on the card against the ring on the CPU (three writes,
    the last wrapping) and a snapshot's round trip, bit for bit. Returns
    the largest differences."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.envs import vec_kinematic as vk
    from dgvit_tpu_torch.envs.kinematic import default_records
    from dgvit_tpu_torch.train import fused_train as ft

    out = {}
    recs = default_records(seed=seed)
    host = KinematicNavEnv(recs, max_steps=100)
    r = host.reset()
    c = vk.make_consts("rrc", records=recs, max_steps=100, device=DEVICE)
    state, obs, goal = vk.vec_reset(c, 1)
    worst = float(np.abs(obs[0].cpu().numpy() - r.state[..., 0]).max())
    acts = scripted_commands(25, 1)[:, 0]
    for i in range(25):
        s = host.step(list(acts[i]), i)
        o = vk.vec_step(c, state, torch.from_numpy(acts[i][None]).to(DEVICE))
        state = o.state
        check(bool(o.done[0]) == s.done and bool(o.target[0]) == s.target,
              f"phase 19a: the card's env and the host env part at step {i}")
        check(abs(float(o.reward[0]) - s.reward) <= 2e-3 + 1e-4 * abs(
            s.reward), f"phase 19a: reward at step {i}")
        worst = max(worst, float(np.abs(o.next_to_goal[0].cpu().numpy()
                                        - s.to_goal).max()),
                    float(np.abs(o.next_obs[0].cpu().numpy()
                                 - s.state[..., 0]).max()))
        if s.done:
            break
    check(worst <= 1e-3, f"phase 19a: the card's env is {worst:.3e} from "
          f"the host env's goals and images (limit 1e-3)")
    out["host_env_max_abs"] = worst

    envs = [vk.make_consts(FUSED_WORLD, max_steps=VEC_MAX_STEPS, seed=seed,
                           device=d) for d in (DEVICE, "cpu")]
    carry = [vk.vec_reset(e, VEC_LANES) for e in envs]
    acts = torch.from_numpy(scripted_commands(VEC_STEPS, VEC_LANES))
    img = pos = 0.0
    resets = 0
    for t in range(VEC_STEPS + 1):
        if t:
            steps = [vk.vec_step(e, st, acts[t - 1].to(e.device))
                     for e, (st, _, _) in zip(envs, carry)]
            for f in ("done", "target", "collided", "truncated"):
                check(torch.equal(getattr(steps[0], f).cpu(),
                                  getattr(steps[1], f)),
                      f"phase 19a: {f} differs between the card and the "
                      f"CPU at step {t}")
            resets += int((steps[1].done | steps[1].truncated).sum())
            img = max(img, float((steps[0].next_obs.cpu()
                                  - steps[1].next_obs).abs().max()))
            carry = [(o.state, o.obs, o.to_goal) for o in steps]
        (s0, o0, g0), (s1, o1, g1) = carry
        for f in ("rec_idx", "steps"):
            check(torch.equal(getattr(s0, f).cpu(), getattr(s1, f)),
                  f"phase 19a: {f} differs between the card and the CPU "
                  f"at step {t}")
        img = max(img, float((o0.cpu() - o1).abs().max()))
        pos = max(pos, max(float((getattr(s0, f).cpu()
                                  - getattr(s1, f)).abs().max())
                           for f in ("x", "y", "theta", "dist_old")),
                  float((g0.cpu() - g1).abs().max()))
    check(img <= VEC_IMAGE_TOL and pos <= VEC_IMAGE_TOL,
          f"phase 19a: the card's batched env is {img:.3e} (images) and "
          f"{pos:.3e} (poses, goals) from the CPU's (limit "
          f"{VEC_IMAGE_TOL})")
    check(resets >= VEC_LANES * 2, f"phase 19a: only {resets} resets")
    out.update(vec_env_images_max_abs=img, vec_env_poses_max_abs=pos,
               vec_env_resets=resets)

    rng = np.random.default_rng(seed)
    rings = [ft.ring_init(64, (128, 160), device=d) for d in (DEVICE, "cpu")]
    for n in (40, 20, 30):
        rows = {"obs": rng.uniform(0, 1, (n, 128, 160)),
                "act": rng.uniform(-1, 1, (n, 2)),
                "pobs": rng.uniform(-1, 1, (n, 2)),
                "next_pobs": rng.uniform(-1, 1, (n, 2)),
                "rew": rng.normal(0, 50, n),
                "next_obs": rng.uniform(0, 1, (n, 128, 160)),
                "done": (rng.uniform(0, 1, n) < 0.1)}
        for ring in rings:
            ft.ring_write(ring, {k: torch.as_tensor(
                v, dtype=torch.float32, device=ring.obs.device)
                for k, v in rows.items()})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        path = str(Path(d) / "ring.npz")
        ft.ring_save(rings[0], path, chunk_rows=24)
        back = ft.ring_load(path, ft.ring_init(64, (128, 160),
                                               device=DEVICE))
    check(back is not None and back.cursor == rings[1].cursor == 90,
          "phase 19a: the ring's cursor")
    for f in ft.RING_FIELDS:
        check(torch.equal(getattr(rings[0], f).cpu(), getattr(rings[1], f))
              and torch.equal(getattr(back, f), getattr(rings[0], f)),
              f"phase 19a: the ring's {f} on the card differs from the "
              f"CPU's or from its snapshot")
    record("vec env", seed=seed, **out)
    print(f"phase 19a (seed {seed}): the batched env on the card: "
          f"{json.dumps(out)}; the ring bit-equal to the CPU's and to its "
          f"snapshot", flush=True)
    return out


def phase_vec_eval(out_dir):
    """Phase 19b: run_eval_vec, 32 episodes as lanes, 300 steps, one K1
    launch a step and no other kernel; held to the host run_eval on the
    same 32 records (successes and collisions within 1), for each of
    VEC_EVAL_CASES."""
    from dgvit_tpu_torch.core.checkpoint import load_params_npz
    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.train.evaluate import run_eval, run_eval_vec

    cfg = fused_cfg()
    cfg.env.max_steps = VEC_EVAL_STEPS
    counters = kernel_counters()
    out = {}
    for name, path, world in VEC_EVAL_CASES:
        flat = load_params_npz(str(path))
        for fn in counters.values():
            fn.launches = 0
        torch_sync()
        t0 = time.perf_counter()
        vec = run_eval_vec(cfg, flat, VEC_EVAL_EPISODES, world, out_dir,
                           name, device=DEVICE)
        vec_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        check(launches == {**{k: 0 for k in counters},
                           "K1": VEC_EVAL_STEPS},
              f"run_eval_vec ({name}, {world}) launched {launches}, "
              f"expected K1 x{VEC_EVAL_STEPS} (one a step) and nothing else")
        t0 = time.perf_counter()
        host = run_eval(cfg, KinematicNavEnv(seed=SEED, world=world), flat,
                        VEC_EVAL_EPISODES, out_dir, name, device=DEVICE)
        host_s = time.perf_counter() - t0
        host_steps = counters["K1"].launches - VEC_EVAL_STEPS
        print(f"phase 19b ({name}, {world}): run_eval_vec "
              f"{VEC_EVAL_EPISODES} episodes x {VEC_EVAL_STEPS} steps in "
              f"{vec_s:.3f} s = "
              f"{VEC_EVAL_EPISODES * VEC_EVAL_STEPS / vec_s:.1f} env steps/s"
              f" (host clock, the actor's set-up included): successes "
              f"{vec['successes']}, collisions {vec['collisions']}, "
              f"durations {vec['durations']}; host run_eval: {host_steps} "
              f"steps in {host_s:.3f} s = {host_steps / host_s:.1f} "
              f"steps/s, successes {host['successes']}, collisions "
              f"{host['collisions']}, durations {host['durations']} "
              f"({card()})", flush=True)
        check(abs(vec["successes"] - host["successes"]) <= 1
              and abs(vec["collisions"] - host["collisions"]) <= 1,
              f"phase 19b ({name}, {world}): run_eval_vec and run_eval "
              f"disagree by more than one episode")
        out[name] = {
            "world": world, "launches": launches,
            "vec_steps_per_s": VEC_EVAL_EPISODES * VEC_EVAL_STEPS / vec_s,
            "host_steps_per_s": host_steps / host_s,
            "vec": {k: vec[k] for k in ("successes", "collisions")},
            "host": {k: host[k] for k in ("successes", "collisions")}}
    return out


def torch_sync():
    import torch

    torch.cuda.synchronize()


def count_syncs(fn):
    """(fn's result, the number of synchronizing CUDA calls it made), as
    torch.cuda.set_sync_debug_mode('warn') reports them."""
    import warnings

    import torch

    torch_sync()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen
             if "called a synchronizing CUDA operation" in str(w.message)]
    return result, len(syncs), sorted({str(w.message)[:120] for w in syncs})


def fused_cfg():
    from dgvit_tpu_torch.config import Config

    cfg = Config.from_dict({
        "model": {"compute_dtype": "bfloat16"},
        "sac": {"batch_size": SAC_BATCH, "alpha_min": 0.1,
                "alpha_max": 2.0},
        "train": {"seed": SEED, "pre_buffer": False, "save": True}})
    m = cfg.model
    check((m.block, m.head, m.dim_head, m.mlp_dim, m.latent_size,
           tuple(m.image_size)) == (4, 4, 64, 2048, 64, (128, 160)),
          "phase 19c's model is not the flagship")
    return cfg


def phase_fused(out_dir):
    """Phase 19c, a main path: train_fused at the flagship width (bf16,
    batch 256, 16 lanes x 64 steps a round into a ring of 8192 on the
    card, randm32, alpha in [0.1, 2.0]) for 3 rounds of 16 updates (the
    default is one update per env step, 1024 a round: cut for the run's
    time limit), with exact launches (K1 64 a round, PER_UPDATE an update),
    the ring's cursor and finite losses; then the host syncs of a round,
    collection's env steps/s alone, a round's time and its updates/s, and
    the device's busy share over a profiled round; K1 against its plain
    version on the timed collection's frames (collected_k1); a warm
    resume (the ring back bit for bit, the counters from the JSONL, one
    more round); and a guided round on demos the port records, with phase
    18's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.envs import vec_kinematic as vk
    from dgvit_tpu_torch.train import fused_train as ft
    from dgvit_tpu_torch.train import vec_rollout as vr
    from dgvit_tpu_torch.train.demo_record import (record_episodes,
                                                   scripted_pilot)

    cfg = fused_cfg()
    counters = kernel_counters()
    run_dir = str(Path(out_dir) / "fused")
    kw = dict(n_envs=FUSED_LANES, chunk=FUSED_CHUNK,
              updates_per_round=FUSED_UPDATES, ring_capacity=FUSED_RING,
              world=FUSED_WORLD, device=DEVICE)

    def drive(cfg, run_dir, label, rounds, **more):
        """train_fused for `rounds` rounds in one segment: (its result, its
        launches, its host clock)."""
        for fn in counters.values():
            fn.launches = 0
        torch_sync()
        t0 = time.perf_counter()
        out = ft.train_fused(cfg, out_dir=run_dir, rounds=rounds,
                             rounds_per_dispatch=rounds, **kw, **more)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        print(f"train_fused ({label}): {out['rounds']} rounds, "
              f"{out['env_steps']} env steps, {out['updates']} updates, "
              f"{out['episodes']} episodes, {out['goals']} goals in "
              f"{wall:.2f} s (host clock, the ring's snapshot included); "
              f"launches {launches}", flush=True)
        return out, launches, wall

    def expected(rounds, per_update):
        return {**{k: n * rounds * FUSED_UPDATES
                   for k, n in per_update.items()},
                "K1": rounds * FUSED_CHUNK}

    out, launches, wall = drive(cfg, run_dir, "plain", FUSED_ROUNDS)
    updates = FUSED_ROUNDS * FUSED_UPDATES
    steps = FUSED_ROUNDS * FUSED_LANES * FUSED_CHUNK
    ring = out["ring"]
    check(out["rounds"] == FUSED_ROUNDS and out["env_steps"] == steps
          and out["updates"] == updates and ring.cursor == steps,
          f"train_fused ran {out['rounds']} rounds, {out['env_steps']} env "
          f"steps, {out['updates']} updates, ring cursor {ring.cursor}")
    ring_bytes = sum(getattr(ring, f).numel() * 4 for f in ft.RING_FIELDS)
    check(tuple(ring.obs.shape) == (FUSED_RING, 128, 160)
          and ring.obs.device.type == "cuda",
          f"the ring's frames: {tuple(ring.obs.shape)} on "
          f"{ring.obs.device}")
    want = expected(FUSED_ROUNDS, PER_UPDATE)
    check(launches == want, f"train_fused launched {launches}, expected "
          f"{want}: K1 x{FUSED_CHUNK} a round, every update {PER_UPDATE}")
    rows = [json.loads(line) for line in
            next(Path(run_dir).glob("train_fused_*.jsonl")).read_text()
            .splitlines()]
    check(len(rows) == FUSED_ROUNDS and all(
        math.isfinite(r[k]) for r in rows for k in
        ("qf1_loss", "policy_loss", "alpha", "reward_sum")),
        "train_fused's losses are not finite")
    check([r["buffer"] for r in rows] == [
        float(FUSED_LANES * FUSED_CHUNK * (i + 1))
        for i in range(FUSED_ROUNDS)], "the ring's fill by round")
    print(f"the ring on the card: {ring_bytes / 1e9:.3f} GB", flush=True)

    # the parts of a round, on the state and ring the run left
    state = out["state"]
    agent = SACAgent(cfg, device=DEVICE, seed=SEED)
    consts = vk.make_consts(FUSED_WORLD, max_steps=cfg.env.max_steps,
                            seed=SEED, device=DEVICE)
    e = cfg.env
    collect = vr.make_collect_fn(agent, consts, FUSED_CHUNK,
                                 e.linear_cmd_scale, e.angular_cmd_scale)
    run = ft.make_fused_round(agent, consts, FUSED_LANES, FUSED_CHUNK,
                              FUSED_UPDATES, SAC_BATCH, e.linear_cmd_scale,
                              e.angular_cmd_scale, seed=SEED)
    carry = vk.vec_reset(consts, FUSED_LANES)
    gen = torch.Generator(DEVICE).manual_seed(SEED)
    collect(state.actor, carry, gen)          # warm
    torch_sync()
    t0 = time.perf_counter()
    carry, traj = collect(state.actor, carry, gen)
    torch_sync()
    collect_s = time.perf_counter() - t0
    k1_collected = collected_k1(state.actor, traj)
    del traj
    state, carry, ring, _ = run(state, carry, ring, [FUSED_ROUNDS])
    torch_sync()
    t0 = time.perf_counter()
    state, carry, ring, _ = run(state, carry, ring, [FUSED_ROUNDS + 1])
    torch_sync()
    round_s = time.perf_counter() - t0
    (state, carry, ring, _), syncs, kinds = count_syncs(
        lambda: run(state, carry, ring, [FUSED_ROUNDS + 2]))
    batch = ft.ring_sample(ring, gen, SAC_BATCH)
    _, update_syncs, update_kinds = count_syncs(
        lambda: agent.learn(state, batch))
    _, collect_syncs, _ = count_syncs(
        lambda: collect(state.actor, carry, gen))
    torch_sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, carry, ring, _ = run(state, carry, ring, [FUSED_ROUNDS + 3])
        torch_sync()
        prof_wall = time.perf_counter() - t0
    busy = sum(ev.device_time_total for ev in prof.key_averages()
               if ev.device_type.name == "CUDA") / 1e6
    upd_s = round_s - collect_s
    timing = {
        "collect_env_steps_per_s": FUSED_LANES * FUSED_CHUNK / collect_s,
        "collect_ms_per_step": collect_s / FUSED_CHUNK * 1e3,
        "round_s": round_s,
        "updates_per_s_in_round": FUSED_UPDATES / upd_s,
        "ms_per_update_in_round": upd_s / FUSED_UPDATES * 1e3,
        "env_steps_per_s_in_round": FUSED_LANES * FUSED_CHUNK / round_s,
        "syncs_per_round": syncs, "syncs_per_update": update_syncs,
        "syncs_per_collection": collect_syncs,
        "profiled_round_s": prof_wall,
        "busy_share": (busy / prof_wall) if busy else None}
    print(f"phase 19c times ({card()}): collection alone "
          f"{timing['collect_env_steps_per_s']:.1f} env steps/s "
          f"({timing['collect_ms_per_step']:.3f} ms a step of "
          f"{FUSED_LANES} lanes); a round of {FUSED_CHUNK} steps and "
          f"{FUSED_UPDATES} updates {round_s:.3f} s = "
          f"{timing['env_steps_per_s_in_round']:.1f} env steps/s, "
          f"{timing['updates_per_s_in_round']:.2f} updates/s "
          f"({timing['ms_per_update_in_round']:.2f} ms an update, the "
          f"round less a collection); device busy share over a profiled "
          f"round: " + ("not measured (no device time)" if not busy else
                        f"{busy:.3f} s of {prof_wall:.3f} s = "
                        f"{busy / prof_wall:.3f}") + " (host clock, "
          f"synchronized)", flush=True)
    print(f"phase 19c host syncs: a round {syncs}, an update {update_syncs},"
          f" a collection {collect_syncs}; an update's: {update_kinds}; "
          f"the round's: {kinds}", flush=True)
    check(collect_syncs == 0, f"collection synchronized {collect_syncs} "
          f"times with the card")
    check(syncs == 1 + FUSED_UPDATES * update_syncs,
          f"a round synchronized {syncs} times: expected the stats' one "
          f"read and {update_syncs} an update x {FUSED_UPDATES}")

    # the warm resume: the snapshot the first run wrote at its end
    snap = ft.ring_init(FUSED_RING, (128, 160), device=DEVICE)
    check(ft.ring_load(str(Path(run_dir) / "checkpoints" / "ring_latest.npz"),
                       snap) is not None, "no ring snapshot")
    first = {f: getattr(snap, f)[:steps].clone() for f in ft.RING_FIELDS}
    del snap
    resumed, r_launches, _ = drive(cfg, run_dir, "warm resume",
                                   FUSED_ROUNDS + 1, resume=True)
    rows = [json.loads(line) for line in
            next(Path(run_dir).glob("train_fused_*.jsonl")).read_text()
            .splitlines()]
    check(resumed["rounds"] == FUSED_ROUNDS + 1
          and [r["step"] for r in rows] == list(range(1, FUSED_ROUNDS + 2))
          and rows[FUSED_ROUNDS - 1]["episodes"] == out["episodes"]
          and resumed["episodes"] == rows[-1]["episodes"]
          and rows[-1]["buffer"] == steps + FUSED_LANES * FUSED_CHUNK
          and resumed["updates"] == updates + FUSED_UPDATES,
          "the warm resume's counters do not follow the JSONL")
    check(all(torch.equal(getattr(resumed["ring"], f)[:steps], first[f])
              for f in ft.RING_FIELDS),
          "the resumed ring is not the snapshot bit for bit")
    check(r_launches == expected(1, PER_UPDATE),
          f"the resumed round launched {r_launches}")
    del first, resumed

    # the guided round on demos the port records
    demo_env = KinematicNavEnv(seed=SEED + 3, world="rrc")
    demos = record_episodes(
        demo_env, scripted_pilot, str(Path(out_dir) / "Data"),
        episodes=DEMO_EPISODES, max_steps=TRAIN_MAX_STEPS,
        action_to_env=lambda a: [(a[0] + 1) * e.linear_cmd_scale,
                                 a[1] * e.angular_cmd_scale])
    check(bool(demos), "the recorder wrote no demo")
    cfg.train.pre_buffer = True
    guided, g_launches, g_wall = drive(
        cfg, str(Path(out_dir) / "guided"), "guided", 1,
        expert_glob=str(Path(out_dir) / "Data" / "RRC" / "torch" / "*.npz"))
    g_rows = [json.loads(line) for line in
              next((Path(out_dir) / "guided").glob("train_fused_*.jsonl"))
              .read_text().splitlines()]
    gwant = expected(1, PER_GUIDED)
    check(g_launches == gwant, f"the guided round launched {g_launches}, "
          f"expected {gwant}")
    check(guided["updates"] == FUSED_UPDATES
          and math.isfinite(g_rows[-1]["qf1_loss"]),
          "the guided round's updates or losses")
    return {"launches": launches, "guided_launches": g_launches,
            "wall_s": wall, "guided_wall_s": g_wall, **timing,
            "k1_on_collected_frames": k1_collected,
            "episodes": out["episodes"], "goals": out["goals"],
            "last_round": {k: rows[FUSED_ROUNDS - 1][k] for k in
                           ("qf1_loss", "policy_loss", "alpha",
                            "reward_sum")}}


def collected_k1(actor, traj, whose="a collection's"):
    """K1 against its plain version at the collection's batch (the lanes
    of `traj`) on a collection's own frames and goals, one launch a step,
    under phase 2's restated bf16 check (k1_verdict, EXACT_K). These
    launches compare; they come after the main path's counts were read."""
    import torch

    from dgvit_tpu_torch.ops import got_megakernel as gm

    triples, forms = [], set()
    with torch.no_grad():
        for obs, pobs in zip(traj["obs"], traj["pobs"]):
            args = actor.trans.trunk_args(obs, actor.fc_embed(pobs))
            forms.add(gm.k1_form(*args))
            triples.append((gm.got_forward_fused(*args),
                            gm.got_forward_plain(*args),
                            exact(gm.got_forward_plain, *args)))
    lanes = traj["obs"].shape[1]
    v = k1_verdict(triples, EXACT_K["K1"])
    record(f"K1 on {whose} frames", k=EXACT_K["K1"], readings={"K1": v})
    print(f"K1 bf16 on {whose} own frames ({v['launches']} launches "
          f"of {lanes} lanes, form {sorted(forms)}): restated vs float64 "
          f"sums: mean {v['rel']:.3e} (limit {v['limit']:.3e}), the "
          f"launches' largest max|err|/L {v['max']:.3e} (limit "
          f"{v['max_limit']:.3e}); {'passes' if v['pass'] else 'FAILS'}",
          flush=True)
    check(v["pass"], f"K1 disagrees with its plain version on {whose} "
          f"frames (bf16, B={lanes})")
    return {**{k: v[k] for k in ("rel", "limit", "max", "max_limit",
                                 "launches", "frames")},
            "forms": sorted(forms)}


def phase_train_vec(out_dir):
    """Phase 19d, a main path: train_vec at the flagship width (phase
    19c's settings, a host replay buffer of FUSED_RING rows) for
    VEC_TRAIN_CHUNKS chunks of 16 lanes x 64 steps, FUSED_UPDATES updates
    a chunk through learn: exact launches (K1 64 a chunk, PER_UPDATE an
    update), the counters and finite losses, and its host clock."""
    from dgvit_tpu_torch.train import vec_rollout as vr

    cfg = fused_cfg()
    cfg.sac.buffer_size = FUSED_RING
    counters = kernel_counters()
    run_dir = Path(out_dir) / "train_vec"
    steps = VEC_TRAIN_CHUNKS * FUSED_LANES * FUSED_CHUNK
    for fn in counters.values():
        fn.launches = 0
    torch_sync()
    t0 = time.perf_counter()
    out = vr.train_vec(cfg, out_dir=str(run_dir), n_envs=FUSED_LANES,
                       chunk=FUSED_CHUNK, total_env_steps=steps,
                       updates_per_chunk=FUSED_UPDATES, world=FUSED_WORLD,
                       device=DEVICE)
    torch_sync()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    updates = VEC_TRAIN_CHUNKS * FUSED_UPDATES
    print(f"train_vec ({card()}): {out['env_steps']} env steps, "
          f"{out['updates']} updates, {out['episodes']} episodes in "
          f"{wall:.2f} s (host clock, synchronized, the first chunk's "
          f"warm-up and the checkpoint included) = "
          f"{out['env_steps'] / wall:.1f} env steps/s; launches {launches}",
          flush=True)
    want = {**{k: n * updates for k, n in PER_UPDATE.items()},
            "K1": VEC_TRAIN_CHUNKS * FUSED_CHUNK}
    check(launches == want, f"train_vec launched {launches}, expected "
          f"{want}: K1 x{FUSED_CHUNK} a chunk, every update {PER_UPDATE}")
    rows = [json.loads(line) for line in
            next(run_dir.glob("train_vec_*.jsonl")).read_text().splitlines()]
    check(out["env_steps"] == steps and out["updates"] == updates
          and [r["env_steps"] for r in rows] == [
              float(FUSED_LANES * FUSED_CHUNK * (i + 1))
              for i in range(VEC_TRAIN_CHUNKS)]
          and all(math.isfinite(r[k]) for r in rows for k in
                  ("qf1_loss", "policy_loss", "alpha", "chunk_reward")),
          f"train_vec: {out['env_steps']} env steps, {out['updates']} "
          f"updates, or its losses are not finite")
    return {"launches": launches, "wall_s": wall,
            "env_steps_per_s": out["env_steps"] / wall,
            "last_chunk": {k: rows[-1][k] for k in
                           ("qf1_loss", "policy_loss", "alpha",
                            "chunk_reward")}}


def phase_on_device():
    """Phase 19: the on-device tier (19a, 19b, 19c, 19d)."""
    env = phase_vec_env()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        vec_eval = phase_vec_eval(out_dir)
        fused = phase_fused(out_dir)
        train_vec = phase_train_vec(out_dir)
    return {"env": env, "vec_eval": vec_eval, "fused": fused,
            "train_vec": train_vec}


# --------------------------------------------------------------------------
# phase 20: the round-5 recipes (device PER, the flagship's and drqc's
# recipes through the launcher's config, a guided PER round, K1 at the
# final evaluation's batch, the launcher end to end)
# --------------------------------------------------------------------------

PER_CAP, PER_STORED, PER_DRAWS = 4096, 3000, 2 ** 20
# the chi-square limit of the draws' frequencies: the 1 - 1e-6 quantile
# (Wilson-Hilferty, z = 4.753) of the statistic's distribution
PER_CHI2_Z = 4.753
RECIPE_ROUNDS, RECIPE_UPDATES = 2, 16   # the recipe's 1024 a round, cut
RECIPE_BATCH, EVAL_LANES = 32, 100
FLAGSHIP_ARGS = ["--fused", "--resume", "--eval-world", "hospital",
                 "--alpha-max", "2.0", "--world", "randm32", "--seed", "11",
                 "--alpha-min", "0.1"]
DRQC_ARGS = ["--fused", "--resume", "--eval-world", "hospital",
             "--alpha-max", "2.0", "--world", "rand8", "--world-assign",
             "lane", "--alpha-min", "0.1", "--aug-shift", "4",
             "--aug-critic-only"]
# phase 20f: the launcher's main at a budget that ends in about two
# minutes on an H100 (--episodes 16 --chunk 8 took 175-246 s, --episodes
# 8 --chunk 4 169-261 s, --episodes 4 --chunk 4 129 s): the whole script
# must end within 1200 s, its build included
LAUNCHER_ARGS = ["--episodes", "4", "--chunk", "4"]


def planted_per(device, seed, first_wins=False):
    """A DevicePER of PER_CAP rows, PER_STORED written, priorities planted
    from `seed` (lognormal raw priorities, duplicates in every update):
    (per, the raw updates). `first_wins`: the update keeps the first
    occurrence of a duplicate (a wrong version)."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.replay import device_per as dp

    rng = np.random.default_rng(seed)
    per = dp.per_init(PER_CAP, device)
    dp.per_on_write(per, torch.arange(PER_STORED, device=device))
    updates = [(rng.integers(0, PER_STORED, 1024),
                rng.lognormal(0.0, 1.5, 1024).astype(np.float32))
               for _ in range(4)]
    for idx, raw in updates:
        i = torch.as_tensor(idx, device=device)
        r = torch.as_tensor(raw, device=device)
        if first_wins:
            pos = torch.arange(i.shape[0], device=device)
            first = torch.full((PER_CAP,), i.shape[0], dtype=torch.long,
                               device=device)
            first.scatter_reduce_(0, i, pos, reduce="amin")
            per.prios.index_put_((i,), (r ** dp.ALPHA)[first[i]])
            per.max_p.copy_(torch.maximum(per.max_p, r.max()))
        else:
            dp.per_update(per, i, r)
    return per, updates


def chi2_limit(df):
    return df * (1 - 2 / (9 * df) + PER_CHI2_Z * math.sqrt(2 / (9 * df))) ** 3


def draw_chi2(idx, prios):
    """(statistic, degrees of freedom) of the draws' row counts against
    the priorities' proportions, rows with fewer than 5 expected draws
    pooled into one bin."""
    import numpy as np

    p = prios / prios.sum()
    n = idx.size
    counts = np.bincount(idx, minlength=p.size)
    big = p * n >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(p[big] * n, p[~big].sum() * n)
    keep = exp > 0
    obs, exp = obs[keep], exp[keep]
    return float(((obs - exp) ** 2 / exp).sum()), int(obs.size - 1)


def phase_device_per(seed=SEED):
    """Phase 20a: the device PER on the card against its CPU version on
    priorities planted from `seed`: the priority state (rtol 1e-6, the
    pow's last place), the rows and weights for the same uniform draws
    (a neighbouring row only where u * total lies within the two scans'
    difference of a boundary, plus 4 ulps; weights rtol 1e-5 elsewhere),
    the frequencies of 2^20 draws of the card's generator under a
    chi-square limit, empty slots never drawn; a planted uniform sampler
    and a first-wins update must fail."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.replay import device_per as dp

    card_per, updates = planted_per(DEVICE, seed)
    cpu_per, _ = planted_per("cpu", seed)
    gp, cp = card_per.prios.cpu().numpy(), cpu_per.prios.numpy()
    state_err = float(np.max(np.abs(gp - cp) / np.maximum(cp, 1e-30)))
    check(state_err <= 1e-6 and card_per.max_p.item()
          == cpu_per.max_p.item(),
          f"phase 20a: the priorities on the card differ from the CPU's "
          f"by {state_err:.3e} (rtol 1e-6)")
    # the last occurrence wins on the card as on the CPU: rebuilt by a
    # loop over the last update, row by row
    idx, raw = updates[-1]
    want = {}
    for i, r in zip(idx, raw):
        want[int(i)] = np.float32(r) ** np.float32(dp.ALPHA)
    lw = max(abs(gp[i] - v) / v for i, v in want.items())
    check(lw <= 1e-6, f"phase 20a: a duplicate's priority is not its last "
          f"occurrence's ({lw:.3e})")
    wrong, _ = planted_per(DEVICE, seed, first_wins=True)
    fw = float(np.max(np.abs(wrong.prios.cpu().numpy() - cp)
                      / np.maximum(cp, 1e-30)))
    check(fw > 1e-3, f"phase 20a: a first-wins update passes ({fw:.3e})")

    u = np.random.default_rng(seed + 1).uniform(0, 1, 4096).astype(
        np.float32)
    gi, gw = dp.per_sample(card_per, None, u.size, PER_STORED,
                           u=torch.as_tensor(u, device=DEVICE))
    ci, cw = dp.per_sample(cpu_per, None, u.size, PER_STORED,
                           u=torch.from_numpy(u))
    gi, gw, ci, cw = gi.cpu().numpy(), gw.cpu().numpy(), ci.numpy(), \
        cw.numpy()
    gc = torch.cumsum(card_per.prios, 0).cpu().numpy()
    cc = torch.cumsum(cpu_per.prios, 0).numpy()
    moved = np.flatnonzero(gi != ci)
    for j in moved:
        lo = min(gi[j], ci[j])
        x = u[j] * cc[-1]
        tol = (abs(gc[lo] - cc[lo]) + u[j] * abs(gc[-1] - cc[-1])
               + 4 * np.spacing(np.float32(cc[lo])))
        check(abs(int(gi[j]) - int(ci[j])) == 1 and abs(x - cc[lo]) <= tol,
              f"phase 20a: draw {j} takes row {gi[j]} on the card, "
              f"{ci[j]} on the CPU, not at a boundary")
    same = gi == ci
    w_err = float(np.max(np.abs(gw[same] - cw[same]) / cw[same]))
    check(w_err <= 1e-5, f"phase 20a: importance weights {w_err:.3e} from "
          f"the CPU's (rtol 1e-5)")

    gen = torch.Generator(DEVICE).manual_seed(seed)
    draws, _ = dp.per_sample(card_per, gen, PER_DRAWS, PER_STORED)
    draws = draws.cpu().numpy()
    stat, df = draw_chi2(draws, cp)
    limit = chi2_limit(df)
    uniform = np.random.default_rng(seed + 2).integers(0, PER_STORED,
                                                       PER_DRAWS)
    u_stat, _ = draw_chi2(uniform, cp)
    empty = int((draws >= PER_STORED).sum())
    check(stat <= limit and empty == 0,
          f"phase 20a: {PER_DRAWS} draws' chi-square {stat:.1f} (limit "
          f"{limit:.1f}, {df} degrees of freedom), {empty} empty slots drawn")
    check(u_stat > limit, f"phase 20a: a uniform sampler passes the "
          f"chi-square limit ({u_stat:.1f} <= {limit:.1f})")

    # the PER bookkeeping of an update at the recipe's batch, timed
    td = torch.rand(RECIPE_BATCH, device=DEVICE)

    def bookkeeping():
        i, w = dp.per_sample(card_per, gen, RECIPE_BATCH, PER_STORED)
        dp.per_update(card_per, i, td + 1e-6)
        return i, w

    bookkeeping()
    ms = cuda_ms(bookkeeping, 50)
    _, syncs, kinds = count_syncs(bookkeeping)
    check(syncs == 0, f"phase 20a: per_sample + per_update synchronized "
          f"{syncs} times: {kinds}")
    out = {"state_rel": state_err, "first_wins_rel": fw,
           "moved_draws": int(moved.size), "weights_rel": w_err,
           "chi2": stat, "chi2_df": df, "chi2_limit": limit,
           "uniform_chi2": u_stat, "empty_drawn": empty,
           "bookkeeping_ms": ms}
    record("device PER", seed=seed, **out)
    print(f"phase 20a (seed {seed}, {card()}): priorities on the card vs "
          f"the CPU {state_err:.3e} (rtol 1e-6), a first-wins update "
          f"{fw:.3e} (must exceed 1e-3); {moved.size} of {u.size} fixed "
          f"draws on a neighbouring row at a boundary, weights "
          f"{w_err:.3e} (rtol 1e-5); {PER_DRAWS} draws: chi-square "
          f"{stat:.1f} on {df} degrees of freedom (limit {limit:.1f}), a "
          f"uniform sampler {u_stat:.1f} (must fail), empty slots drawn "
          f"{empty}; per_sample + per_update at B={RECIPE_BATCH}: "
          f"{ms:.4f} ms (CUDA events), 0 syncs", flush=True)
    return out


def recipe(args):
    """The launcher's configuration for `args` (reference_scale_run's
    flags), SAC batch and ring as the recipe has them."""
    from dgvit_tpu_torch.examples import reference_scale_run as rsr

    cfg = rsr.recipe_config(rsr.parser().parse_args(args))
    s, m = cfg.sac, cfg.model
    check((s.batch_size, min(s.buffer_size, 8192), s.prioritized_replay,
           s.nan_guard, m.compute_dtype, m.block, m.head, m.dim_head,
           m.mlp_dim, m.latent_size, tuple(m.image_size))
          == (RECIPE_BATCH, FUSED_RING, True, True, "bfloat16", 4, 4, 64,
              2048, 64, (128, 160)),
          f"phase 20: the recipe of {args} is not the flagship's")
    return cfg, rsr.parser().parse_args(args)


class PerRecorder:
    """Patches train_fused's per_on_write and per_sample to keep, for the
    latest round, the priorities after its write and every row its
    updates drew; and the rows of the first write of a run."""

    def __init__(self):
        from dgvit_tpu_torch.train import fused_train as ft

        self.ft = ft
        self.after_write, self.drawn, self.first = None, [], None

    def __enter__(self):
        ft = self.ft
        self.real = (ft.per_on_write, ft.per_sample)
        write, sample = self.real

        def on_write(per, idx):
            if self.first is None:
                self.first = (per.prios.clone(), idx.clone())
            out = write(per, idx)
            self.after_write, self.drawn = per.prios.clone(), []
            return out

        def on_sample(*a, **k):
            idx, w = sample(*a, **k)
            self.drawn.append(idx)
            return idx, w

        ft.per_on_write, ft.per_sample = on_write, on_sample
        return self

    def __exit__(self, *exc):
        self.ft.per_on_write, self.ft.per_sample = self.real


def recipe_launches(recipes, short):
    """A kernel's launches on phase 20's paths, for the kernels line."""
    return {"fused_train_per": recipes["flagship"]["launches"][short],
            "fused_train_drqc": recipes["drqc_launches"][short],
            "fused_train_guided_per": recipes["guided_launches"][short],
            "reference_scale_run": recipes["launcher"]["launches"][short]}


def phase_recipes(out_dir):
    """Phase 20b-f (the docstring of the module lists them)."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.agents import sac as sac_mod
    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.envs import vec_kinematic as vk
    from dgvit_tpu_torch.replay.device_per import per_sample, per_update
    from dgvit_tpu_torch.train import fused_train as ft
    from dgvit_tpu_torch.train import vec_rollout as vr
    from dgvit_tpu_torch.train.demo_record import (record_episodes,
                                                   scripted_pilot)

    counters = kernel_counters()
    per_update_b = {**{k: 0 for k in counters}, **PER_UPDATE}

    def drive(cfg, args, run_dir, label, rounds, **more):
        """train_fused as the launcher calls it, cut to `rounds` rounds of
        RECIPE_UPDATES updates: (result, launches, host clock)."""
        for fn in counters.values():
            fn.launches = 0
        torch_sync()
        t0 = time.perf_counter()
        out = ft.train_fused(
            cfg, out_dir=str(run_dir), n_envs=FUSED_LANES,
            chunk=FUSED_CHUNK, rounds=rounds, rounds_per_dispatch=rounds,
            updates_per_round=RECIPE_UPDATES, world=args.world,
            world_assign=args.world_assign, device=DEVICE, **more)
        torch_sync()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        print(f"phase 20 train_fused ({label}): {out['rounds']} rounds, "
              f"{out['env_steps']} env steps, {out['updates']} updates, "
              f"{out['episodes']} episodes in {wall:.2f} s (host clock); "
              f"launches {launches}", flush=True)
        return out, launches, wall

    def expected(rounds, per_update=None):
        return {**{k: n * rounds * RECIPE_UPDATES
                   for k, n in (per_update or per_update_b).items()},
                "K1": rounds * FUSED_CHUNK}

    def rows_of(run_dir):
        return [json.loads(line) for line in
                next(Path(run_dir).glob("train_fused_*.jsonl")).read_text()
                .splitlines()]

    # (b) the flagship recipe
    cfg, args = recipe(FLAGSHIP_ARGS)
    run_dir = Path(out_dir) / "flagship"
    with PerRecorder() as rec:
        out, launches, wall = drive(cfg, args, run_dir, "flagship recipe",
                                    RECIPE_ROUNDS)
    steps = RECIPE_ROUNDS * FUSED_LANES * FUSED_CHUNK
    check(out["updates"] == RECIPE_ROUNDS * RECIPE_UPDATES
          and out["ring"].cursor == steps and out["ring"].capacity
          == FUSED_RING, f"phase 20b: {out['updates']} updates, ring "
          f"cursor {out['ring'].cursor}")
    check(launches == expected(RECIPE_ROUNDS),
          f"phase 20b launched {launches}, expected "
          f"{expected(RECIPE_ROUNDS)}")
    rows = rows_of(run_dir)
    check(len(rows) == RECIPE_ROUNDS and all(
        math.isfinite(r[k]) for r in rows for k in
        ("qf1_loss", "policy_loss", "alpha", "reward_sum"))
        and all(0.1 - 1e-6 <= r["alpha"] <= 2.0 + 1e-6 for r in rows),
        "phase 20b: losses not finite or alpha outside [0.1, 2]")
    per = out["per"]
    end = per.prios
    changed = end != rec.after_write
    drawn = torch.zeros_like(changed)
    drawn[torch.cat(rec.drawn)] = True
    n_changed, n_drawn = int(changed.sum()), int(drawn.sum())
    outside = int((changed & ~drawn).sum())
    check(outside == 0 and n_changed > 0 and bool(
        (end[steps:] == 0).all()) and bool((end[:steps] > 0).all()),
        f"phase 20b: {n_changed} priorities changed in the last round, "
        f"{outside} of them at rows no update drew ({n_drawn} drawn)")
    print(f"phase 20b: the last round's updates drew {n_drawn} rows and "
          f"changed the priority of {n_changed}, none elsewhere; the "
          f"running max {per.max_p.item():.4f}", flush=True)

    # a warm resume: the restored rows at the max priority, one more round
    with PerRecorder() as rec2:
        resumed, r_launches, _ = drive(cfg, args, run_dir, "warm resume",
                                       RECIPE_ROUNDS + 1, resume=True)
    before, first_rows = rec2.first
    check(resumed["rounds"] == RECIPE_ROUNDS + 1
          and resumed["updates"] == out["updates"] + RECIPE_UPDATES
          and torch.equal(first_rows.cpu(), torch.arange(steps))
          and bool((before == 0).all())
          and r_launches == expected(1),
          f"phase 20b: the warm resume ({resumed['rounds']} rounds, "
          f"{resumed['updates']} updates, launches {r_launches})")
    del resumed

    # the syncs and times of a PER round and a uniform round at B=32 on
    # the run's state, ring and priorities
    state, ring = out["state"], out["ring"]
    agent = SACAgent(cfg, device=DEVICE, seed=cfg.train.seed)
    hw = tuple(cfg.model.image_size)
    consts = vk.make_consts(args.world, image_hw=hw,
                            max_steps=cfg.env.max_steps,
                            seed=cfg.train.seed, device=DEVICE)
    e = cfg.env
    carry = vk.vec_reset(consts, FUSED_LANES)
    kw = dict(l_scale=e.linear_cmd_scale, a_scale=e.angular_cmd_scale,
              seed=cfg.train.seed)
    runs = {"per": ft.make_fused_round(
        agent, consts, FUSED_LANES, FUSED_CHUNK, RECIPE_UPDATES,
        RECIPE_BATCH, prioritized=True, **kw),
        "uniform": ft.make_fused_round(
        agent, consts, FUSED_LANES, FUSED_CHUNK, RECIPE_UPDATES,
        RECIPE_BATCH, **kw)}
    collect = vr.make_collect_fn(agent, consts, FUSED_CHUNK,
                                 e.linear_cmd_scale, e.angular_cmd_scale)
    gen = torch.Generator(DEVICE).manual_seed(SEED)
    collect(state.actor, carry, gen)
    torch_sync()
    t0 = time.perf_counter()
    carry, traj = collect(state.actor, carry, gen)
    torch_sync()
    collect_s = time.perf_counter() - t0
    del traj
    r = 100
    timing = {}
    for name in ("per", "uniform", "per", "uniform"):
        r += 1
        torch_sync()
        t0 = time.perf_counter()
        state, carry, ring, *_ = runs[name](state, carry, ring, [r],
                                            per=per)
        torch_sync()
        timing.setdefault(name, []).append(time.perf_counter() - t0)
    syncs = {}
    for name in ("per", "uniform"):
        r += 1
        (state, carry, ring, *_), syncs[name], kinds = count_syncs(
            lambda: runs[name](state, carry, ring, [r], per=per))
    batch = ft.ring_sample(ring, gen, RECIPE_BATCH)
    _, learn_syncs, learn_kinds = count_syncs(
        lambda: agent.learn(state, batch))
    w = torch.ones(RECIPE_BATCH, device=DEVICE)
    _, per_learn_syncs, _ = count_syncs(
        lambda: agent.learn_per(state, batch, w))

    def bookkeeping():
        idx, _ = per_sample(per, gen, RECIPE_BATCH, ring.size)
        ft.ring_gather(ring, idx)
        per_update(per, idx, torch.rand(RECIPE_BATCH, device=DEVICE) + 1)

    _, book_syncs, _ = count_syncs(bookkeeping)
    check(book_syncs == 0 and per_learn_syncs == learn_syncs
          and syncs["per"] == 1 + RECIPE_UPDATES * per_learn_syncs
          and syncs["uniform"] == 1 + RECIPE_UPDATES * learn_syncs,
          f"phase 20b syncs: a PER round {syncs['per']}, a uniform round "
          f"{syncs['uniform']}, learn_per {per_learn_syncs}, learn "
          f"{learn_syncs}, PER's sampling and update {book_syncs}")
    times = {name: {
        "round_s": min(v),
        "env_steps_per_s": FUSED_LANES * FUSED_CHUNK / min(v),
        "ms_per_update": (min(v) - collect_s) / RECIPE_UPDATES * 1e3}
        for name, v in timing.items()}
    print(f"phase 20b ({card()}): a round of {FUSED_CHUNK} steps of "
          f"{FUSED_LANES} lanes and {RECIPE_UPDATES} updates at "
          f"B={RECIPE_BATCH}, bf16, nan_guard, the better of two (host "
          f"clock, synchronized): PER {times['per']['round_s']:.3f} s = "
          f"{times['per']['env_steps_per_s']:.1f} env steps/s, "
          f"{times['per']['ms_per_update']:.2f} ms an update; uniform "
          f"{times['uniform']['round_s']:.3f} s = "
          f"{times['uniform']['env_steps_per_s']:.1f} env steps/s, "
          f"{times['uniform']['ms_per_update']:.2f} ms an update "
          f"(collection alone {collect_s:.3f} s); host syncs: a PER round "
          f"{syncs['per']}, a uniform round {syncs['uniform']} (phase 19c's"
          f" round at B={SAC_BATCH} without nan_guard: 33), an update "
          f"{per_learn_syncs} with PER, {learn_syncs} without ({learn_kinds})"
          f"; PER's sampling, gather and update 0", flush=True)
    flagship = {"launches": launches, "wall_s": wall, "times": times,
                "syncs_per_round": syncs, "syncs_per_update": learn_syncs,
                "changed_priorities": n_changed, "drawn_rows": n_drawn,
                "episodes": out["episodes"],
                "last_round": {k: rows[-1][k] for k in
                               ("qf1_loss", "policy_loss", "alpha",
                                "reward_sum")}}
    del out, state, ring, per, runs, batch

    # (c) the drqc recipe: shifted frames into the critic, raw frames into
    # the actor step
    cfg, args = recipe(DRQC_ARGS)
    check(cfg.sac.aug_shift == 4 and not cfg.sac.aug_actor,
          "phase 20c: the drqc recipe's DrQ knobs")
    seen = {"aug": 0}
    real_aug, real_terms = SACAgent._augment, SACAgent._policy_terms

    def aug_spy(self, st, b, e=None, shifts=None):
        out = real_aug(self, st, b, e, shifts)
        seen["aug"] += 1
        seen["raw"], seen["shifted"] = b["obs"].clone(), out[0]["obs"].clone()
        return out

    def terms_spy(self, st, alpha, b, noise_pi, *reused):
        seen["actor"] = b["obs"].clone()
        return real_terms(self, st, alpha, b, noise_pi, *reused)

    SACAgent._augment, SACAgent._policy_terms = aug_spy, terms_spy
    try:
        drqc, d_launches, d_wall = drive(
            cfg, args, Path(out_dir) / "drqc", "drqc recipe", RECIPE_ROUNDS,
            ring_snapshot_every=0)
    finally:
        SACAgent._augment, SACAgent._policy_terms = real_aug, real_terms
    differ = (seen["shifted"] != seen["raw"]).flatten(1).any(1)
    check(seen["aug"] == RECIPE_ROUNDS * RECIPE_UPDATES
          and bool(differ.float().mean() > 0.5)
          and torch.equal(seen["actor"], seen["raw"])
          and d_launches == expected(RECIPE_ROUNDS),
          f"phase 20c: {seen['aug']} augmented updates, {int(differ.sum())}"
          f" of {RECIPE_BATCH} frames shifted, the actor's frames raw: "
          f"{torch.equal(seen['actor'], seen['raw'])}, launches "
          f"{d_launches}")
    print(f"phase 20c: the drqc recipe, {RECIPE_ROUNDS} rounds: every "
          f"update shifted its frames ({int(differ.sum())} of "
          f"{RECIPE_BATCH} frames of the last differ from the raw ones, "
          f"offsets in [0, 8]), the actor step saw the raw frames; "
          f"{drqc['episodes']} episodes in {d_wall:.2f} s", flush=True)
    del drqc, seen

    # (d) one guided PER round on demos the port records
    cfg, args = recipe(FLAGSHIP_ARGS)
    e = cfg.env
    demo_env = KinematicNavEnv(seed=SEED + 3, world="rrc",
                               image_hw=tuple(cfg.model.image_size))
    demos = record_episodes(
        demo_env, scripted_pilot, str(Path(out_dir) / "Data"),
        episodes=DEMO_EPISODES, max_steps=TRAIN_MAX_STEPS,
        action_to_env=lambda a: [(a[0] + 1) * e.linear_cmd_scale,
                                 a[1] * e.angular_cmd_scale])
    check(bool(demos), "phase 20d: the recorder wrote no demo")
    cfg.train.pre_buffer = True
    with PerRecorder() as rec3:
        guided, g_launches, g_wall = drive(
            cfg, args, Path(out_dir) / "guided_per", "guided PER", 1,
            ring_snapshot_every=0,
            expert_glob=str(Path(out_dir) / "Data" / "RRC" / "torch"
                            / "*.npz"))
    g_rows = rows_of(Path(out_dir) / "guided_per")
    g_changed = guided["per"].prios != rec3.after_write
    g_drawn = torch.zeros_like(g_changed)
    g_drawn[torch.cat(rec3.drawn)] = True
    check(g_launches == expected(1, PER_GUIDED)
          and guided["updates"] == RECIPE_UPDATES
          and math.isfinite(g_rows[-1]["qf1_loss"])
          and int(g_changed.sum()) > 0
          and not bool((g_changed & ~g_drawn).any()),
          f"phase 20d: the guided PER round launched {g_launches}, "
          f"expected {expected(1, PER_GUIDED)}; "
          f"{int(g_changed.sum())} priorities changed")
    print(f"phase 20d: a guided PER round, {RECIPE_UPDATES} updates on "
          f"{RECIPE_BATCH} ++ {RECIPE_BATCH} rows in {g_wall:.2f} s; "
          f"{int(g_changed.sum())} priorities changed, all at drawn rows",
          flush=True)
    del guided

    # (e) K1 at the final evaluation's batch, on the evaluation's frames
    from dgvit_tpu_torch.core.checkpoint import load_params_npz
    from dgvit_tpu_torch.serve.export import make_action_fn

    actor = make_action_fn(cfg, load_params_npz(str(ACTOR)),
                           dtype=torch.bfloat16, device=DEVICE).policy
    h_consts = vk.make_consts("hospital", image_hw=hw,
                              max_steps=e.max_steps, seed=7, device=DEVICE)
    eval_collect = vr.make_collect_fn(agent, h_consts, 8,
                                      e.linear_cmd_scale,
                                      e.angular_cmd_scale, evaluate=True)
    _, traj = eval_collect(actor, vk.vec_reset(h_consts, EVAL_LANES))
    k1_eval = collected_k1(actor, traj, "the final evaluation's")
    check(k1_eval["forms"] == ["mma"], f"phase 20e: K1 at B={EVAL_LANES} "
          f"took {k1_eval['forms']}, not two frames a block")
    del traj

    # (f) the launcher's main end to end
    from dgvit_tpu_torch.examples import reference_scale_run as rsr

    largs = rsr.parser().parse_args(FLAGSHIP_ARGS + LAUNCHER_ARGS)
    for fn in counters.values():
        fn.launches = 0
    torch_sync()
    t0 = time.perf_counter()
    summary = rsr.main(FLAGSHIP_ARGS + LAUNCHER_ARGS + [
        "--out", str(Path(out_dir) / "launcher"), "--device", DEVICE])
    torch_sync()
    main_s = time.perf_counter() - t0
    l_launches = {k: fn.launches for k, fn in counters.items()}
    l_rows = rows_of(Path(out_dir) / "launcher")
    l_rounds = len(l_rows)
    updates = l_rounds * largs.n_envs * largs.chunk
    want = {**{k: n * updates for k, n in per_update_b.items()},
            "K1": l_rounds * largs.chunk + cfg.env.max_steps}
    on_disk = json.loads((Path(out_dir) / "launcher" / "summary.json")
                         .read_text())
    check(l_launches == want
          and on_disk["train_episodes"] >= largs.episodes
          and on_disk["eval_episodes"] == largs.eval_episodes
          and on_disk["mode"] == "fused"
          and on_disk["eval_world"] == "hospital"
          and 0.0 <= on_disk["eval_success_rate"] <= 1.0
          and all(math.isfinite(r["qf1_loss"]) for r in l_rows),
          f"phase 20f: the launcher's main: launches {l_launches}, "
          f"expected {want}; summary {on_disk}")
    budget = " ".join(LAUNCHER_ARGS)
    print(f"phase 20f ({card()}): the launcher's main, {budget}: "
          f"{l_rounds} rounds ({updates} updates, "
          f"{on_disk['train_episodes']} episodes), then run_eval_vec of "
          f"{largs.eval_episodes} episodes on hospital ({cfg.env.max_steps}"
          f" K1 launches of {largs.eval_episodes}), in {main_s:.1f} s (host"
          f" clock); summary "
          f"{json.dumps(on_disk)}", flush=True)
    return {"flagship": flagship, "drqc_launches": d_launches,
            "guided_launches": g_launches, "k1_eval": k1_eval,
            "launcher": {"launches": l_launches, "seconds": main_s,
                         "rounds": l_rounds, "summary": on_disk}}


# --------------------------------------------------------------------------
# phase 21: sensor-fault augmentation in the fused loop (the round-4 arms'
# recipe) and the robustness sweep that graded them
# --------------------------------------------------------------------------

# the aug arms' flags (tools/r4g_queue.sh:35, tools/r4m_queue.sh:64)
AUG_ARGS = ["--aug", "patch_occlusion=0.25", "--aug", "obs_noise=0.196",
            "--aug-prob", "0.5"]
# the robustness grid's strongest setting of each fault family
FAULT_STRONGEST = ({"obs_noise": 0.5}, {"blur": 1.0}, {"occlusion": 0.75},
                   {"patch_occlusion": 0.5}, {"greying": 0.9})
# perturb_obs on the card against the CPU on the same frames and draws:
# fp32 on both sides, the same operations in the same order, each one
# correctly rounded on both, on values in [0, 1]
FAULT_TOL = 1e-6
# phase 21d: the sweep at 32 lanes, each point cut to 250 steps (of 800)
# so that the 16 points take about 30 s on an H100
SWEEP_LANES, SWEEP_STEPS, SWEEP_WORLD = 32, 250, "rrc"


def patch_edge_draws(b, ih, iw, patch):
    """y0 and x0 uniforms (b of each, fp32) that put a patch's edges where
    its fp32 arithmetic (JAX's, `fault_aug.patch_keep`) and the same
    arithmetic in float64 of the knob's double part by a row or a column:
    for each row (column) edge, the first fp32 uniform within 64 ulps of
    the edge that parts them, cycled over the lanes."""
    import numpy as np

    f32 = np.float32

    def found(n):
        p32 = np.sqrt(f32(patch)) * f32(n)
        p64 = math.sqrt(patch) * n
        k = np.arange(n)
        out = []
        for edge in range(n):
            for target in ((edge - float(p32)) / (n - float(p32)),
                           edge / (n - float(p32))):
                if not 0.0 < target < 1.0:
                    continue
                base = f32(target)
                for i in range(-64, 65):
                    u = base + f32(i) * np.spacing(base)
                    y32 = u * (f32(n) - p32)
                    y64 = float(u) * (n - p64)
                    if ((((k >= y32) & (k < y32 + p32))
                         != ((k >= y64) & (k < y64 + p64))).any()):
                        out.append(u)
                        break
        return np.resize(np.asarray(out, f32), b)

    return found(ih), found(iw)


def patch_keep_f64(shape, patch, y0u, x0u):
    """A planted wrong patch: the side, the rectangle and the comparisons
    in float64, from the knob's double (not its fp32 value)."""
    import torch

    ih, iw = shape[-2], shape[-1]
    side = math.sqrt(max(patch, 0.0))
    ph, pw = side * ih, side * iw
    ex = (1,) * (len(shape) - 3)
    y0 = (y0u.double() * (ih - ph)).reshape((-1,) + ex + (1, 1))
    x0 = (x0u.double() * (iw - pw)).reshape((-1,) + ex + (1, 1))
    yy = torch.arange(ih, dtype=torch.float64, device=y0u.device)[:, None]
    xx = torch.arange(iw, dtype=torch.float64, device=y0u.device)[None, :]
    return ~((yy >= y0) & (yy < y0 + ph) & (xx >= x0) & (xx < x0 + pw))


def phase_fault_transforms(rng):
    """Phase 21a: perturb_obs on the card against the CPU (fault_aug)."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.envs import fault_aug as fa
    from dgvit_tpu_torch.tools.robustness_sweep import GRID

    points = [pt for pt in GRID if pt] + [
        {"obs_noise": 0.2, "blur": 0.5, "occlusion": 0.1,
         "patch_occlusion": 0.25, "greying": 0.3}]
    worst, planted = 0.0, {}
    for shape in ((FUSED_LANES, 128, 160), (4, 2, 128, 160)):
        host = torch.from_numpy(
            rng.uniform(0.02, 1.0, shape).astype(np.float32))
        obs = host.to(DEVICE)
        draws = fa.draw_faults(shape, torch.Generator().manual_seed(SEED))
        on_card = tuple(d.to(DEVICE) for d in draws)
        for pt in points:
            knobs = fa.knobs_array(pt)
            ref = fa.perturb_obs(host, knobs, draws=draws)
            got = fa.perturb_obs(obs, knobs, draws=on_card).cpu()
            err = (got - ref).abs().max().item()
            worst = max(worst, err)
            check(err <= FAULT_TOL and torch.equal(got == 0, ref == 0),
                  f"phase 21a: perturb_obs{pt} on the card is {err:.3e} "
                  f"from the CPU's (limit {FAULT_TOL}), or its zeros "
                  f"differ ({tuple(shape)})")
        same = fa.perturb_obs(obs, fa.knobs_array({}), draws=on_card)
        grey = fa.perturb_obs(obs, fa.knobs_array({"greying": 0.5}),
                              draws=on_card)
        check(same is obs and torch.equal(grey, fa.perturb_obs(
            obs, fa.knobs_array({"greying": 0.5, "obs_noise": 0.0,
                                 "patch_occlusion": 0.0}), draws=on_card)),
              "phase 21a: a knob at 0.0 changed the frames on the card")
        # the planted unclipped noise
        knobs = fa.knobs_array({"obs_noise": 0.5})
        wrong = (obs + knobs[0] * on_card[0]).cpu()
        planted.setdefault("unclipped noise", 0.0)
        planted["unclipped noise"] = max(
            planted["unclipped noise"],
            (wrong - fa.perturb_obs(host, knobs, draws=draws)).abs().max()
            .item())
    check(planted["unclipped noise"] > FAULT_TOL,
          "phase 21a: the planted unclipped noise passed")
    # the patch's mask, exact, on draws that put its edges where fp32 and
    # float64 part
    shape = (FUSED_LANES, 128, 160)
    lanes_apart = {}
    for patch in (0.1, 0.25, 0.5):
        y0u, x0u = (torch.from_numpy(a) for a in
                    patch_edge_draws(shape[0], 128, 160, patch))
        ref = fa.patch_keep(shape, fa.knobs_array(
            {"patch_occlusion": patch})[3], y0u, x0u)
        got = fa.patch_keep(shape, fa.knobs_array(
            {"patch_occlusion": patch})[3], y0u.to(DEVICE),
            x0u.to(DEVICE)).cpu()
        wrong = patch_keep_f64(shape, patch, y0u.to(DEVICE),
                               x0u.to(DEVICE)).cpu()
        apart = int((wrong != ref).flatten(1).any(1).sum())
        lanes_apart[str(patch)] = apart
        check(torch.equal(got, ref), f"phase 21a: the patch's mask "
              f"(patch_occlusion={patch}) differs from the CPU's on the card")
        check(apart > 0, f"phase 21a: the planted float64 patch "
              f"(patch_occlusion={patch}) passed the exact mask check")
    planted["float64 patch: lanes off"] = lanes_apart
    print(f"phase 21a: perturb_obs on the card against the CPU, {len(points)}"
          f" settings (each grid point, all five knobs) on frames "
          f"(16, 128, 160) and stacks (4, 2, 128, 160): largest |err| "
          f"{worst:.3e} (limit {FAULT_TOL:.0e}), zeros equal; a knob at 0.0 "
          f"leaves the frames; the patch's mask exact on edge draws; the "
          f"planted wrong versions fail: {json.dumps(planted)}", flush=True)
    return {"max_abs_err": worst, "planted": planted}


def phase_k1_faulted(rng):
    """Phase 21b: K1 against its plain version on faulted frames."""
    import torch

    from dgvit_tpu_torch.core.checkpoint import load_params_npz
    from dgvit_tpu_torch.envs import fault_aug as fa
    from dgvit_tpu_torch.envs import vec_kinematic as vk
    from dgvit_tpu_torch.ops import got_megakernel as gm
    from dgvit_tpu_torch.serve.export import make_action_fn

    cfg = fused_cfg()
    actor = make_action_fn(cfg, load_params_npz(str(SECOND_ACTOR)),
                           dtype=torch.bfloat16, device=DEVICE).policy
    consts = vk.make_consts(SWEEP_WORLD,
                            image_hw=tuple(cfg.model.image_size),
                            max_steps=cfg.env.max_steps, seed=SEED,
                            device=DEVICE)
    _, frames, goals = vk.vec_reset(consts, EVAL_LANES)
    gen = torch.Generator(DEVICE).manual_seed(int(rng.integers(2 ** 31)))
    out = {}
    with torch.no_grad():
        for b in (FUSED_LANES, SWEEP_LANES, EVAL_LANES):
            triples, forms = [], set()
            for pt in FAULT_STRONGEST:
                obs = fa.perturb_obs(frames[:b], fa.knobs_array(pt), gen)
                args = actor.trans.trunk_args(obs,
                                              actor.fc_embed(goals[:b, :2]))
                forms.add(gm.k1_form(*args))
                triples.append((gm.got_forward_fused(*args),
                                gm.got_forward_plain(*args),
                                exact(gm.got_forward_plain, *args)))
            v = k1_verdict(triples, EXACT_K["K1"])
            record(f"K1 on faulted frames, B={b}", k=EXACT_K["K1"],
                   readings={"K1": v})
            print(f"phase 21b: K1 bf16 at B={b} (form {sorted(forms)}) on "
                  f"frames of each fault family at the grid's strongest "
                  f"setting ({len(triples)} launches): restated vs float64 "
                  f"sums: mean {v['rel']:.3e} (limit {v['limit']:.3e}), "
                  f"largest max|err|/L {v['max']:.3e} (limit "
                  f"{v['max_limit']:.3e}); "
                  f"{'passes' if v['pass'] else 'FAILS'}", flush=True)
            check(v["pass"], f"phase 21b: K1 disagrees with its plain "
                  f"version on faulted frames (bf16, B={b})")
            out[str(b)] = {**{k: v[k] for k in ("rel", "limit", "max",
                                                "max_limit")},
                           "forms": sorted(forms)}
    return out


def phase_aug_recipe(out_dir):
    """Phase 21c: the aug arm's recipe through train_fused."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.envs import vec_kinematic as vk
    from dgvit_tpu_torch.examples import reference_scale_run as rsr
    from dgvit_tpu_torch.replay.device_per import per_init
    from dgvit_tpu_torch.train import fused_train as ft
    from dgvit_tpu_torch.train import vec_rollout as vr

    cfg, args = recipe(FLAGSHIP_ARGS + AUG_ARGS)
    knobs = ft.parse_aug(rsr.parser(), args.aug)
    check(knobs == {"patch_occlusion": 0.25, "obs_noise": 0.196}
          and args.aug_prob == 0.5, f"phase 21c: the aug flags read {knobs}"
          f" at {args.aug_prob}")
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch_sync()
    t0 = time.perf_counter()
    out = ft.train_fused(
        cfg, out_dir=str(Path(out_dir) / "aug"), n_envs=FUSED_LANES,
        chunk=FUSED_CHUNK, rounds=RECIPE_ROUNDS,
        rounds_per_dispatch=RECIPE_ROUNDS, updates_per_round=RECIPE_UPDATES,
        world=args.world, world_assign=args.world_assign, fault_knobs=knobs,
        aug_prob=args.aug_prob, ring_snapshot_every=0, device=DEVICE)
    torch_sync()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    want = {**{k: n * RECIPE_ROUNDS * RECIPE_UPDATES
               for k, n in PER_UPDATE.items()},
            "K1": RECIPE_ROUNDS * FUSED_CHUNK}
    check(launches == want, f"phase 21c launched {launches}, expected "
          f"{want}")
    rows = [json.loads(line) for line in next(
        (Path(out_dir) / "aug").glob("train_fused_*.jsonl")).read_text()
        .splitlines()]
    check(len(rows) == RECIPE_ROUNDS and out["updates"]
          == RECIPE_ROUNDS * RECIPE_UPDATES and all(
              math.isfinite(r[k]) for r in rows for k in
              ("qf1_loss", "policy_loss", "alpha", "reward_sum")),
          "phase 21c: losses not finite or updates missing")
    # depth frames are strictly positive: a row with a zero pixel was
    # perturbed (the patch, or noise clipped at 0), a row without was not
    ring = out["ring"]
    shares = {f: float((getattr(ring, f)[:ring.size] == 0).flatten(1)
                       .any(1).float().mean()) for f in ("obs", "next_obs")}
    check(all(0.35 <= v <= 0.65 for v in shares.values()),
          f"phase 21c: shares of perturbed rows {shares}, expected about "
          f"aug_prob 0.5")
    del out, ring

    # the same round three times from one seed: unaugmented, with the
    # knobs at aug_prob 0.0, unaugmented again (whether the update itself
    # repeats bit for bit on the card)
    hw = tuple(cfg.model.image_size)
    e = cfg.env
    consts = vk.make_consts(args.world, image_hw=hw, max_steps=e.max_steps,
                            seed=cfg.train.seed,
                            world_assign=args.world_assign, device=DEVICE)
    kw = dict(l_scale=e.linear_cmd_scale, a_scale=e.angular_cmd_scale,
              prioritized=True, seed=cfg.train.seed)

    def round_from_seed(fault_knobs=None, aug_prob=1.0):
        agent = SACAgent(cfg, device=DEVICE, seed=cfg.train.seed)
        run = ft.make_fused_round(agent, consts, FUSED_LANES, FUSED_CHUNK,
                                  RECIPE_UPDATES, RECIPE_BATCH,
                                  fault_knobs=fault_knobs,
                                  aug_prob=aug_prob, **kw)
        state, _, ring, stats, per = run(
            agent.init_state(cfg.train.seed), vk.vec_reset(consts,
                                                            FUSED_LANES),
            ft.ring_init(FUSED_RING, hw, device=DEVICE), [0],
            per=per_init(FUSED_RING, DEVICE))
        keep = slice(0, ring.size)
        return ({f: getattr(ring, f)[keep].clone() for f in
                 ft.RING_FIELDS}, per.prios.clone(),
                [p.detach().clone() for p in state.actor.parameters()],
                stats)

    def same(a, b):
        return {"ring": all(torch.equal(a[0][f], b[0][f]) for f in a[0]),
                "priorities": torch.equal(a[1], b[1]),
                "actor": all(torch.equal(x, y) for x, y in zip(a[2], b[2])),
                "stats": all(np.array_equal(a[3][k], b[3][k])
                             for k in a[3])}

    clean = round_from_seed()
    gated = round_from_seed(knobs, 0.0)
    again = round_from_seed()
    vs_gated, repeat = same(clean, gated), same(clean, again)
    del clean, gated, again
    check(vs_gated["ring"], "phase 21c: aug_prob 0.0 wrote other rows than "
          "the unaugmented round")
    check(all(v for k, v in vs_gated.items() if repeat[k]),
          f"phase 21c: the aug_prob 0.0 round differs from the unaugmented "
          f"one ({vs_gated}) where two unaugmented rounds agree ({repeat})")

    # host syncs: a collection with the knobs, and a PER round with and
    # without them; the time of a collection step with and without
    agent = SACAgent(cfg, device=DEVICE, seed=cfg.train.seed)
    state = agent.init_state(cfg.train.seed)
    collects = {name: vr.make_collect_fn(
        agent, consts, FUSED_CHUNK, e.linear_cmd_scale, e.angular_cmd_scale,
        **k) for name, k in (("aug", dict(fault_knobs=knobs,
                                          aug_prob=args.aug_prob)),
                             ("clean", {}))}
    carry = vk.vec_reset(consts, FUSED_LANES)
    gen = torch.Generator(DEVICE).manual_seed(SEED)
    fgen = torch.Generator(DEVICE).manual_seed(SEED + 1)
    step_ms = {}
    for name in ("aug", "clean", "aug", "clean"):
        collects[name](state.actor, carry, gen, fault_gen=fgen)
        torch_sync()
        t0 = time.perf_counter()
        carry, _ = collects[name](state.actor, carry, gen, fault_gen=fgen)
        torch_sync()
        step_ms[name] = min(step_ms.get(name, 1e9), (time.perf_counter()
                                                     - t0) / FUSED_CHUNK
                            * 1e3)
    _, collect_syncs, kinds = count_syncs(
        lambda: collects["aug"](state.actor, carry, gen, fault_gen=fgen))
    ring = ft.ring_init(FUSED_RING, hw, device=DEVICE)
    per = per_init(FUSED_RING, DEVICE)
    round_syncs = {}
    for r, (name, k) in enumerate((("aug", dict(fault_knobs=knobs,
                                                aug_prob=args.aug_prob)),
                                   ("clean", {}))):
        run = ft.make_fused_round(agent, consts, FUSED_LANES, FUSED_CHUNK,
                                  RECIPE_UPDATES, RECIPE_BATCH, **kw, **k)
        (state, carry, ring, *_), round_syncs[name], _ = count_syncs(
            lambda: run(state, carry, ring, [r], per=per))
    check(collect_syncs == 0 and round_syncs["aug"] == round_syncs["clean"],
          f"phase 21c syncs: a collection with the knobs {collect_syncs} "
          f"({kinds}), a PER round with them {round_syncs['aug']}, without "
          f"{round_syncs['clean']}")
    print(f"phase 21c ({card()}): the aug arm's recipe (flagship + "
          f"{' '.join(AUG_ARGS)}), {RECIPE_ROUNDS} rounds of "
          f"{RECIPE_UPDATES} updates at B={RECIPE_BATCH} in {wall:.2f} s "
          f"(host clock); launches {launches}; rows perturbed: "
          f"{json.dumps(shares)}; aug_prob 0.0 against the unaugmented round:"
          f" {json.dumps(vs_gated)} (two unaugmented rounds: "
          f"{json.dumps(repeat)}); host syncs: a collection with the knobs "
          f"{collect_syncs}, a PER round {round_syncs['aug']} with them and "
          f"{round_syncs['clean']} without; a collection step of "
          f"{FUSED_LANES} lanes {step_ms['aug']:.3f} ms with the knobs, "
          f"{step_ms['clean']:.3f} ms without (host clock, the better of "
          f"two chunks of {FUSED_CHUNK})", flush=True)
    return {"launches": launches, "wall_s": wall, "perturbed_rows": shares,
            "gated_vs_clean": vs_gated, "clean_repeat": repeat,
            "collect_syncs": collect_syncs, "round_syncs": round_syncs,
            "collect_step_ms": step_ms,
            "last_round": {k: rows[-1][k] for k in
                           ("qf1_loss", "policy_loss", "alpha",
                            "reward_sum")}}


def phase_sweep(out_dir):
    """Phase 21d: the robustness sweep through its tool."""
    import torch

    from dgvit_tpu_torch.core.checkpoint import load_params_npz
    from dgvit_tpu_torch.tools import robustness_sweep as rs
    from dgvit_tpu_torch.train.evaluate import run_eval_vec

    cfg = fused_cfg()
    cfg.env.max_steps = SWEEP_STEPS
    seen = []
    real_config, real_eval = rs.Config, rs.run_eval_vec

    def spy(*a, **k):
        reports = real_eval(*a, **k)
        seen.extend(reports)
        return reports

    counters = kernel_counters()
    rs.Config, rs.run_eval_vec = (lambda: cfg), spy
    try:
        for fn in counters.values():
            fn.launches = 0
        torch_sync()
        t0 = time.perf_counter()
        rows = rs.main(["--actor", str(SECOND_ACTOR), "--worlds",
                        SWEEP_WORLD, "--episodes", str(SWEEP_LANES),
                        "--out", str(Path(out_dir) / "sweep"), "--device",
                        DEVICE])
        torch_sync()
        sweep_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        rs.Config, rs.run_eval_vec = real_config, real_eval
    want = {**{k: 0 for k in counters}, "K1": len(rs.GRID) * SWEEP_STEPS}
    check(launches == want and len(rows) == len(seen) == len(rs.GRID),
          f"phase 21d: the sweep launched {launches}, expected {want}")
    flat = load_params_npz(str(SECOND_ACTOR))
    outcome = lambda r: (r["successes"], r["collisions"], r["durations"])
    clean = run_eval_vec(cfg, flat, SWEEP_LANES, SWEEP_WORLD, out_dir,
                         "clean", device=DEVICE)
    grey = run_eval_vec(cfg, flat, SWEEP_LANES, SWEEP_WORLD, out_dir,
                        "grey", greying=0.9, device=DEVICE)
    check(rs.GRID[0] == {} and rs.GRID[-1] == {"greying": 0.9}
          and outcome(seen[0]) == outcome(clean)
          and outcome(seen[-1]) == outcome(grey),
          f"phase 21d: the clean point {outcome(seen[0])} against the run "
          f"without the sweep {outcome(clean)}, or greying=0.9 "
          f"{outcome(seen[-1])} against its static run {outcome(grey)}")
    table = {", ".join(f"{k}={v:.3g}" for k, v in pt.items()) or "clean":
             (r["successes"], r["collisions"]) for pt, r in zip(rs.GRID,
                                                                 seen)}
    print(f"phase 21d ({card()}): the sweep of {SECOND_ACTOR.name}, "
          f"{len(rs.GRID)} points x {SWEEP_STEPS} steps of {SWEEP_LANES} "
          f"lanes on {SWEEP_WORLD} in {sweep_s:.2f} s (host clock) = "
          f"{sweep_s / len(rs.GRID) * 1e3:.1f} ms a point; launches "
          f"{launches}; the clean point equals the run without the sweep "
          f"and greying=0.9 its static run; (successes, collisions) by "
          f"point: {json.dumps(table)}", flush=True)
    return {"launches": launches, "seconds": sweep_s,
            "ms_per_point": sweep_s / len(rs.GRID) * 1e3, "points": table}


def phase_faults(rng):
    """Phase 21 (21a-21d; 21e is the kernels line's sweep and aug_recipe
    paths)."""
    transforms = phase_fault_transforms(rng.spawn(1)[0])
    k1 = phase_k1_faulted(rng.spawn(1)[0])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        aug = phase_aug_recipe(out_dir)
        sweep = phase_sweep(out_dir)
    return {"transforms": transforms, "k1": k1, "aug_recipe": aug,
            "sweep": sweep}


# --------------------------------------------------------------------------
# phase 22: the imitation tier (the BC fit in fp32 at its own batches, the
# frozen teacher, and the generalization launcher that trained the gw10
# generalist)
# --------------------------------------------------------------------------

GEN_DIR = ROOT / "artifacts" / "r3" / "gen_fused"
BC_WARM = GEN_DIR / "bc_warm"          # the arms' --bc-params base path
TEACHER = GEN_DIR / "gw10_winner_actor.npz"
IMITATION_SEED = SEED + 22   # phase 22's own draws: the shared stream and
#                              its spawns stay as they were
# 64: generalization_eval's fit; 32: bc_kinematic_demo's and train_bc's
BC_BATCHES = (64, 32)
BC_STEP = {**{k: 0 for k in PER_UPDATE}, "K2f": 3, "K3f": 1, "K2b": 3,
           "K3b": 1}                 # a training batch of the 4-block fit
BC_VAL = {**{k: 0 for k in PER_UPDATE}, "K2f": 3, "K3f": 1}
# phase 22b's corpus and fit: the scripted pilot's episodes end after
# about 38 steps (an H100 run: 303 transitions from 8 episodes)
BC_EPISODES, BC_EPOCHS = 16, 3
# 22b: the same fit through the plain versions on the card: each epoch's
# train and validation loss within this share of the kernels' (fp32 both,
# the sums in another order; the CPU fit against JAX's read 4e-6, and a
# wrong kernel moves a loss by far more than a share of a thousandth)
BC_PLAIN_REL = 1e-3
TEACHER_LANES, TEACHER_STEPS = 16, 100
# 22d: the gw10 arm's flags (tools/gen_sweep_fused.sh, the round-3 sweep)
# with budgets cut to 5 rounds of 32 updates (22 s on an H100)
GEN_ARGS = ["--fused", "--vec-eval", "--expert-buffer", "--alpha-init",
            "0.05", "--guidence-weight", "10"]
GEN_BUDGET = ["--rl-episodes", "2", "--n-envs", "4", "--chunk", "8",
              "--eval-episodes", "16"]
GEN_KEYS = ["rrc", "hospital", "bc_val_rmse", "sac_goals", "recipe"]


def imitation_cfg():
    """The teacher's and the launcher's configuration: the reference's."""
    from dgvit_tpu_torch.config import Config

    return Config()


def gen_base():
    """The launcher's `base` (None: its own Config())."""
    return None


def bc_policy():
    """generalization_eval's BC policy at its default --dim and
    --dim-head on `imitation_cfg()`'s trunk."""
    from dgvit_tpu_torch.examples import generalization_eval as ge

    args = ge.parser().parse_args([])
    return ge.bc_policy(imitation_cfg(), args.dim, args.dim_head)


def il_constructor():
    """The Imitation_learning.py actor, il_policy()."""
    from dgvit_tpu_torch.agents.bc import il_policy

    return il_policy()


def bc_batch(batch, shape, rng):
    """Seeded frames in [0, 1], goals and actions in [-1, 1] on the card."""
    import torch

    t = lambda a: torch.from_numpy(a.astype("float32")).to(DEVICE)
    return (t(rng.uniform(0, 1, (batch, *shape))),
            t(rng.uniform(-1, 1, (batch, 2))),
            t(rng.uniform(-1, 1, (batch, 2))))


@contextlib.contextmanager
def other_gelu():
    """The plain versions with the other GELU form, forward and derivative,
    in every block (fused_transformer's and cls_block's bindings): the
    tanh form where the TPU kernel takes the erf form (fp32), erf where it
    takes tanh (bf16). Phase 5's wrong GELU (`erf_gelu`) at fp32, where
    the right form is erf."""
    import torch

    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft

    kept = ft._gelu32, ft._gelu_grad32
    other = lambda fn: lambda x, cdt: fn(
        x, torch.bfloat16 if cdt == torch.float32 else torch.float32)
    swaps = [(mod, name, other(fn)) for mod in (ft, cb)
             for name, fn in zip(("_gelu32", "_gelu_grad32"), kept)]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod in (ft, cb):
            mod._gelu32, mod._gelu_grad32 = kept


def bc_grads(trainer, model, obs, goal, act):
    """The BC loss and the gradient of every parameter it reaches."""
    import torch

    loss = trainer._rmse(model, obs, goal, act)
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    return [loss.detach()] + [g for g in grads if g is not None]


def bc_mis_scaled_grads(trainer, model, obs, goal, act):
    """A wrong BC gradient pass, as `bc_grads` returns it, of the model
    whose every block scales its scores by 1 / dim_head where it asks
    1 / sqrt(dim_head): a copy with each wqkv's q columns scaled by
    dim_head^-1/2, the gradient of those columns scaled back."""
    import copy

    import torch

    m = copy.deepcopy(model)
    inner = m.trans.heads * m.trans.dim_head
    s = m.trans.dim_head ** -0.5
    params = list(m.parameters())
    scaled = [name.endswith("wqkv") for name, _ in m.named_parameters()]
    with torch.no_grad():
        for p, q in zip(params, scaled):
            if q:
                p[:, :inner] *= s
    loss = trainer._rmse(m, obs, goal, act)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    out = [loss.detach()]
    for g, q in zip(grads, scaled):
        if g is not None:
            if q:
                g = g.clone()
                g[:, :inner] *= s
            out.append(g)
    return out


def bc_models():
    """(name, trainer, model, frame shape) of phase 22a's passes: the
    launcher's 2d policy holding the round-3 warm start, at B=64 and 32,
    and il_policy() on 4-frame stacks, seeded, at B=32."""
    from dgvit_tpu_torch.agents.bc import BCTrainer
    from dgvit_tpu_torch.core.checkpoint import load_params_npz

    warm = load_params_npz(str(BC_WARM) + "_actor.npz")
    two_d = BCTrainer(model=bc_policy(), batch_size=64, seed=1,
                      device=DEVICE)
    hw = tuple(imitation_cfg().model.image_size)
    il = BCTrainer(model=il_constructor(), batch_size=32, seed=1,
                   device=DEVICE)
    m2 = two_d.init_state(hw, 2, init_params=warm).model
    mil = il.init_state((4, *hw), 2).model
    return [*(("2d warm start", two_d, m2, hw, b) for b in BC_BATCHES),
            ("il_policy, 4 channels", il, mil, (4, *hw), BC_BATCHES[-1])]


def bc_kernel_times(model, batch, rng):
    """fp32 K2f, K2b, K3f and K3b at a BC batch on the 2d policy's own
    blocks, each beside its plain version and its bound at the fp32
    peak (CUDA events)."""
    import torch

    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft

    obs, goal, _ = bc_batch(batch, model.trans.image_size, rng)
    heads, dh = model.trans.heads, model.trans.dim_head
    with torch.no_grad():
        x = model.trans.embed(obs, model.fc_embed(goal)).contiguous()
        _, _, blocks, _ = model.trans.fused_params(torch.float32)
        last = x
        for w in blocks[:-1]:
            last = ft.block_fwd_plain(last, w, heads, dh)
        dy2 = torch.randn(x.shape, device=DEVICE,
                          generator=torch.Generator(DEVICE).manual_seed(1))
        dy3 = dy2[:, 0].contiguous()
        rec = cb.cls_fwd_fused(last, blocks[-1], heads, dh, save=True)[1]
        # the FMA body's K3f writes the records its K3b reads
        rec0 = cb.saved_buffer(last, blocks[-1], heads, dh)
        ft.launch_block_fwd(last, blocks[-1], heads, dh, True, saved=rec0,
                            form=0)
    calls = {
        "K2f": (lambda: ft.block_fwd_fused(x, blocks[0], heads, dh),
                lambda: ft.block_fwd_plain(x, blocks[0], heads, dh),
                lambda: ft.launch_block_fwd(x, blocks[0], heads, dh, False,
                                            form=0)),
        "K2b": (lambda: ft.block_bwd_fused(x, dy2, blocks[0], heads, dh),
                lambda: ft.block_bwd_plain(x, dy2, blocks[0], heads, dh),
                lambda: ft.launch_block_bwd(x, dy2, blocks[0], heads, dh,
                                            False, form=0)),
        "K3f": (lambda: cb.cls_fwd_fused(last, blocks[-1], heads, dh,
                                         save=True),
                lambda: cb.cls_fwd_plain(last, blocks[-1], heads, dh),
                lambda: ft.launch_block_fwd(last, blocks[-1], heads, dh,
                                            True, saved=rec0, form=0)),
        "K3b": (lambda: cb.cls_bwd_fused(last, dy3, blocks[-1], heads, dh,
                                         rec),
                lambda: cb.cls_bwd_plain(last, dy3, blocks[-1], heads, dh),
                lambda: ft.launch_block_bwd(last, dy3, blocks[-1], heads, dh,
                                            True, saved=rec0, form=0))}
    rows = {}
    for name, (kern, plain, *fma) in calls.items():
        bnd, by = bound_ms(*train_work(name, batch, esize=4), "float32")
        err = max((o.float() - r.float()).abs().max().item() for o, r in
                  zip(tensors(kern()), tensors(plain())))
        rows[name] = dict(ms=cuda_ms(kern, 10, runs=5),
                          plain_ms=cuda_ms(plain, 5, runs=5),
                          bound_ms=bnd, bound_by=by, library_ms=None,
                          max_abs_err=err)
        if fma:  # the FMA body it replaced, forced, in the same run
            rows[name]["fma_ms"] = cuda_ms(fma[0], 5, runs=5)
    # K2b by device time: the cluster pass, the weight products
    # (wgrad_kernel), their finish and the vector sums
    split = device_kernels_ms(calls["K2b"][0], 20)
    part = lambda key: sum(v for k, v in split.items() if key in k)
    rows["K2b"]["split"] = {
        "pass": part("block_bwd_cluster_fp32_kernel"),
        "wgrad_kernel": part("wgrad_kernel"),
        "wgrad_finish": part("wgrad_finish"), "vec_finish": part("vec_finish"),
        "all": sum(split.values())}
    # K3f and K3b the same way: the per-frame cluster launch, the batched
    # CLS-row MLP launch, K3b's weight products and sums
    for name, cluster, mlp in (
            ("K3f", "cls_attend_cluster_fp32_kernel", "cls_mlp_fp32_kernel"),
            ("K3b", "cls_bwd_cluster_fp32_kernel",
             "cls_mlp_bwd_fp32_kernel")):
        split = device_kernels_ms(calls[name][0], 20)
        part = lambda key: sum(v for k, v in split.items() if key in k)
        rows[name]["split"] = {
            "cluster": part(cluster), "mlp": part(mlp),
            "weight products": part("wgrad_kernel") + part("wgrad_finish")
            + part("vec_finish"), "all": sum(split.values())}
    return rows


def bc_step_ms(trainer, model, batch, rng):
    """One BC step (loss, backward, clip, Adam) at `batch` on a copy of
    the model, CUDA events."""
    import copy

    import torch

    from dgvit_tpu_torch.agents.bc import clip_by_global_norm_

    m = copy.deepcopy(model)
    opt = torch.optim.Adam(m.parameters(), lr=1e-3, eps=1e-8)
    obs, goal, act = bc_batch(batch, m.trans.image_size, rng)

    def step():
        loss = trainer._rmse(m, obs, goal, act)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm_([p.grad for p in m.parameters()
                              if p.grad is not None], trainer.grad_clip)
        opt.step()
    return cuda_ms(step, 5, runs=5)


def phase_bc_kernels(rng, timed=True):
    """Phase 22a: a gradient pass of the BC loss on the card (loss and
    every parameter gradient), through the kernels, held to the
    float64-sum version of the plain versions under phase 5's fp32 rule
    (EXACT_K["fp32"]), with the pass launching K2f x3, K3f, K3b and K2b x3;
    the plain versions with the other GELU form (`other_gelu`) must fail
    it, and so must the model whose blocks scale their scores by 1 /
    dim_head (`bc_mis_scaled_grads`). The 2d policy's pass takes the fp32
    cluster forms of K2f, K2b, K3f and K3b. Then (with `timed`) ms a BC
    step and fp32 K2f, K2b, K3f and K3b at B = 64 and 32 beside their
    plain versions, bounds and the FMA bodies they replaced, and K2b's,
    K3f's and K3b's splits by device time."""
    import torch

    counters = kernel_counters()
    k, readings, times = EXACT_K["fp32"], {}, {}
    for name, trainer, model, shape, batch in bc_models():
        obs, goal, act = bc_batch(batch, shape, rng)
        for fn in counters.values():
            fn.launches = 0
        for kk in ("K2f", "K2b", "K3f", "K3b"):
            counters[kk].cluster_launches = 0
        out = bc_grads(trainer, model, obs, goal, act)
        launches = {kk: fn.launches for kk, fn in counters.items()}
        check(launches == BC_STEP, f"phase 22a: a BC gradient pass "
              f"launched {launches}, expected {BC_STEP}")
        check(all(bool(torch.isfinite(t).all()) for t in out),
              f"phase 22a: non-finite BC gradients ({name}, B={batch})")
        with plain_kernels():
            ref = bc_grads(trainer, model, obs, goal, act)
            ex = exact(bc_grads, trainer, model, obs, goal, act)
            with other_gelu():
                bad = bc_grads(trainer, model, obs, goal, act)
            mis = bc_mis_scaled_grads(trainer, model, obs, goal, act)
        ok, got, limit = restated(rel_max, TRAIN_F32_MAX, k, out, ref, ex)
        bad_ok, bad_got, _ = restated(rel_max, TRAIN_F32_MAX, k, bad, ref,
                                      ex)
        mis_ok, mis_got, _ = restated(rel_max, TRAIN_F32_MAX, k, mis, ref,
                                      ex)
        own = rel_max(ref, ex)
        key = f"{name}, B={batch}"
        readings[key] = {"got": got, "limit": limit, "plain": own,
                         "old": rel_max(out, ref), "tanh_gelu": bad_got,
                         "mis_scaled": mis_got, "tensors": len(out),
                         "pass": ok, "tanh_gelu_pass": bad_ok,
                         "mis_scaled_pass": mis_ok}
        print(f"phase 22a BC gradient pass fp32, {key}: loss and "
              f"{len(out) - 1} gradients, largest max|err|/L against "
              f"float64 sums {got:.3e} (limit max({TRAIN_F32_MAX:g}, {k:g} "
              f"x plain {own:.3e}) = {limit:.3e}), old reading vs plain "
              f"{readings[key]['old']:.3e}; {'passes' if ok else 'FAILS'};"
              f" wrong (tanh GELU) {bad_got:.3e}, "
              f"{'passes' if bad_ok else 'FAILS'}; wrong (scores scaled 1 / "
              f"dim_head) {mis_got:.3e}, {'passes' if mis_ok else 'FAILS'} "
              f"(the wrong ones must fail)", flush=True)
        record("BC gradient pass fp32", case=key, k=k, **readings[key])
        check(ok, f"phase 22a: the BC gradient pass through the kernels "
              f"disagrees with the float64-sum version ({key})")
        check(not bad_ok, f"phase 22a: the fp32 rule passes a wrong BC "
              f"pass (tanh GELU, {key})")
        check(not mis_ok, f"phase 22a: the fp32 rule passes a wrong BC "
              f"pass (scores scaled 1 / dim_head, {key})")
        if name.startswith("2d"):
            took = {kk: counters[kk].cluster_launches
                    for kk in ("K2f", "K2b", "K3f", "K3b")}
            check(took == {"K2f": 3, "K2b": 3, "K3f": 1, "K3b": 1},
                  f"phase 22a: the 2d policy's pass ({key}) took the fp32 "
                  f"cluster forms {took} times, expected K2f and K2b 3, "
                  "K3f and K3b 1")
        if timed and name.startswith("2d"):
            times[batch] = {"kernels": bc_kernel_times(model, batch, rng),
                            "step_ms": bc_step_ms(trainer, model, batch,
                                                  rng)}
            line = ", ".join(
                f"{kk} {v['ms']:.4f} ms ("
                + (f"the FMA body {v['fma_ms']:.4f}, " if "fma_ms" in v
                   else "")
                + f"plain {v['plain_ms']:.4f}, bound "
                f"{v['bound_ms']:.5f} {v['bound_by']})"
                for kk, v in times[batch]["kernels"].items())
            sp = times[batch]["kernels"]["K2b"]["split"]
            share = (sp["wgrad_kernel"] + sp["wgrad_finish"]) / sp["all"]
            print(f"phase 22a fp32 B={batch} ({card()}): a BC step "
                  f"{times[batch]['step_ms']:.3f} ms; {line} (CUDA "
                  f"events); K2b by device time: the cluster pass "
                  f"{sp['pass']:.4f} ms, wgrad_kernel {sp['wgrad_kernel']:.4f}"
                  f", wgrad_finish {sp['wgrad_finish']:.4f}, vec_finish "
                  f"{sp['vec_finish']:.4f} (all {sp['all']:.4f}; the "
                  f"weight products {share:.3f} of it); " + "; ".join(
                      f"{kk} by device time: " + ", ".join(
                          f"{part} {v:.4f}" for part, v in
                          times[batch]["kernels"][kk]["split"].items())
                      for kk in ("K3f", "K3b")), flush=True)
    return {"checks": readings, "times": times}


def phase_bc_fit(out_dir):
    """Phase 22b, a main path: BCTrainer.fit of the launcher's 2d policy
    (batch 64, seed 1) on a scripted-pilot corpus recorded as
    generalization_eval records it (BC_EPISODES episodes of at most 200
    steps on rrc), BC_EPOCHS epochs: exact launches, one host sync an
    epoch, finite losses and a falling train loss, the best parameters
    those after the lowest-validation epoch bit for bit, and the fit
    through the plain versions within BC_PLAIN_REL; ms an epoch."""
    import numpy as np

    from dgvit_tpu_torch.agents.bc import BCTrainer, split_80_20
    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.examples.generalization_eval import demo_glob
    from dgvit_tpu_torch.models import params_to_jax
    from dgvit_tpu_torch.train.demo_record import (policy_unit_pilot,
                                                   record_episodes)
    from dgvit_tpu_torch.train.train_bc import load_bc_dataset

    cfg = imitation_cfg()
    pilot, to_env = policy_unit_pilot(cfg)
    demo_dir = Path(out_dir) / "bc_demos"
    t0 = time.perf_counter()
    paths = record_episodes(
        KinematicNavEnv(seed=0, image_hw=tuple(cfg.model.image_size)),
        pilot, str(demo_dir), episodes=BC_EPISODES, max_steps=200,
        action_to_env=to_env)
    record_s = time.perf_counter() - t0
    obs, act, goal = load_bc_dataset(demo_glob(demo_dir))
    n = len(obs)
    tr, va = split_80_20(n, 1)
    check(len(paths) == BC_EPISODES and len(tr) >= 64 and len(va) >= 1,
          f"phase 22b: {len(paths)} episodes, {n} transitions")
    vb = min(64, len(va))
    per_epoch = {kk: (len(tr) // 64) * BC_STEP[kk]
                 + (len(va) // vb) * BC_VAL[kk] for kk in BC_STEP}

    def trainer():
        return BCTrainer(model=bc_policy(), batch_size=64, seed=1,
                         device=DEVICE)

    def fit(t, epochs):
        return t.fit(obs, goal, act, epochs=epochs, to_chw=False)

    main = trainer()
    snaps, epoch_s = [], []
    real = main._epoch

    def epoch(state, *a):
        torch_sync()
        t0 = time.perf_counter()
        losses = real(state, *a)
        torch_sync()
        epoch_s.append(time.perf_counter() - t0)
        snaps.append({name: p.detach().clone()
                      for name, p in state.model.named_parameters()})
        return losses
    main._epoch = epoch
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    for kk in ("K2f", "K2b", "K3f", "K3b"):
        counters[kk].cluster_launches = 0
    best, hist = fit(main, BC_EPOCHS)
    launches = {kk: fn.launches for kk, fn in counters.items()}
    cluster = {kk: counters[kk].cluster_launches
               for kk in ("K2f", "K2b", "K3f", "K3b")}
    want = {kk: BC_EPOCHS * v for kk, v in per_epoch.items()}
    check(launches == want, f"phase 22b: the fit launched {launches}, "
          f"expected {want}: each epoch {len(tr) // 64} training batches "
          f"({BC_STEP}) and {len(va) // vb} validation batches ({BC_VAL})")
    check(all(cluster[kk] == launches[kk] for kk in cluster),
          f"phase 22b: of the fit's K2f, K2b, K3f and K3b launches "
          f"{cluster} took the fp32 cluster forms, expected all")
    losses = hist["train"] + hist["val"]
    check(all(math.isfinite(v) for v in losses)
          and hist["train"][-1] < hist["train"][0],
          f"phase 22b: the fit's losses {hist}")
    top = int(np.argmin(hist["val"]))
    snap = params_to_jax(snaps[top])
    check(set(best) == set(snap) and all(np.array_equal(best[kk], snap[kk])
                                         for kk in snap),
          f"phase 22b: the best parameters are not those after epoch {top}"
          f" (the lowest validation loss)")
    (_, h1), s1, _ = count_syncs(lambda: fit(trainer(), 1))
    (_, h3), s3, kinds = count_syncs(lambda: fit(trainer(), BC_EPOCHS))
    print(f"phase 22b host syncs: a fit of 1 epoch {s1}, of {BC_EPOCHS} "
          f"{s3}; {kinds}", flush=True)
    check(s3 - s1 == BC_EPOCHS - 1, f"phase 22b: {s3 - s1} host syncs in "
          f"{BC_EPOCHS - 1} epochs, expected one an epoch")
    with plain_kernels():
        _, hp = fit(trainer(), BC_EPOCHS)
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        hist["train"] + hist["val"], hp["train"] + hp["val"]))
    print(f"phase 22b BCTrainer.fit ({card()}): {n} transitions "
          f"({len(tr)} train, {len(va)} val; recorded in {record_s:.1f} s), "
          f"{BC_EPOCHS} epochs of {len(tr) // 64} steps at B=64: "
          f"{statistics.median(epoch_s) * 1e3:.1f} ms an epoch (median, "
          f"host clock, synchronized); losses {hist}; the plain versions' "
          f"fit {hp}, largest relative distance {rel:.3e} (limit "
          f"{BC_PLAIN_REL:g}); the kernels' fit again equal bit for bit: "
          f"{h3 == hist}; launches {launches}", flush=True)
    check(rel <= BC_PLAIN_REL, f"phase 22b: the fit through the plain "
          f"versions parts from the kernels' by {rel:.3e}")
    return {"launches": launches, "cluster_launches": cluster,
            "per_epoch": per_epoch, "transitions": n,
            "epoch_ms": statistics.median(epoch_s) * 1e3,
            "epoch_ms_all": [s * 1e3 for s in epoch_s], "hist": hist,
            "plain_hist": hp, "plain_rel": rel, "syncs": [s1, s3],
            "reproducible": h3 == hist, "demo_dir": str(demo_dir)}


def phase_teacher(out_dir):
    """Phase 22c, a main path: SACTeacher on the gw10 generalist with
    Config() acts in fp32, one K1 launch a choose_action (B=1 and
    batched), K1 against its plain version under phase 2's fp32 check,
    as_pilot's map; then record_teacher_demos.main on rand2, 2 episodes of
    at most TEACHER_STEPS steps: one K1 a step, the reference layout,
    policy-unit actions."""
    import os

    import numpy as np
    import torch

    from dgvit_tpu_torch.agents import SACTeacher
    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.envs.worlds import random_ensemble
    from dgvit_tpu_torch.ops import got_megakernel as gm
    from dgvit_tpu_torch.tools import record_teacher_demos as rtd

    cfg = imitation_cfg()
    e = cfg.env
    d, f = os.path.split(TEACHER)
    teacher = SACTeacher(cfg, f[: -len("_actor.npz")], d, device=DEVICE)
    policy = teacher._act.policy
    check(policy.trans.compute_dtype == torch.float32,
          f"phase 22c: the teacher acts in {policy.trans.compute_dtype}")
    env = KinematicNavEnv(seed=1000, world=random_ensemble("rand2")[0],
                          image_hw=tuple(cfg.model.image_size))
    frames, goals = [], []
    for _ in range(TEACHER_LANES):
        r = env.reset()
        frames.append(r.state[..., 0])
        goals.append(r.to_goal)
    frames, goals = np.stack(frames), np.stack(goals)
    counters = kernel_counters()
    got = {}
    for label, o, g in (("B=1", frames[0], goals[0]),
                        (f"B={TEACHER_LANES}", frames, goals)):
        for fn in counters.values():
            fn.launches = 0
        got[label] = teacher.choose_action(o, g)
        launches = {kk: fn.launches for kk, fn in counters.items()}
        check(launches == {**{kk: 0 for kk in counters}, "K1": 1},
              f"phase 22c: a choose_action ({label}) launched {launches}")
    check(got["B=1"].shape == (2,) and got[f"B={TEACHER_LANES}"].shape
          == (TEACHER_LANES, 2)
          and np.allclose(got["B=1"], got[f"B={TEACHER_LANES}"][0],
                          rtol=F32_TOL, atol=F32_TOL),
          "phase 22c: the teacher's single and batched actions")
    k1 = {}
    with torch.no_grad():
        for b in (1, TEACHER_LANES):
            o = torch.from_numpy(frames[:b]).to(DEVICE)
            g = torch.from_numpy(goals[:b, :2]).to(DEVICE)
            args = policy.trans.trunk_args(o, policy.fc_embed(g))
            out, ref = gm.got_forward_fused(*args), gm.got_forward_plain(*args)
            err = (out - ref).abs()
            ok = bool((err <= F32_TOL + F32_TOL * ref.abs()).all())
            bnd, by = bound_ms(*k1_work(cfg, b, "float32"), "float32")
            fused = lambda: gm.got_forward_fused(*args)
            k1[b] = {"form": gm.k1_form(*args),
                     "max_abs_err": err.max().item(), "pass": ok,
                     "ms": cuda_ms(fused, 10, runs=5),
                     "plain_ms": cuda_ms(lambda: gm.got_forward_plain(
                         *args), 5, runs=5), "bound_ms": bnd,
                     "bound_by": by}
            with k1_forced("fma"):  # the FMA trunk_kernel it replaced
                k1[b]["fma_ms"] = cuda_ms(fused, 10, runs=5)
            print(f"phase 22c K1 fp32 ({k1[b]['form']}) on the teacher's "
                  f"rand2 frames, B={b}: max|err| {err.max().item():.3e} "
                  f"(limit {F32_TOL:g} + {F32_TOL:g} |ref|) "
                  f"{'ok' if ok else 'FAIL'}; {k1[b]['ms']:.4f} ms (the "
                  f"FMA trunk_kernel {k1[b]['fma_ms']:.4f}, plain "
                  f"{k1[b]['plain_ms']:.4f}, bound {bnd:.5f} {by}; CUDA "
                  f"events, {card()})", flush=True)
            check(ok, f"phase 22c: K1 disagrees with its plain version "
                  f"(fp32, B={b})")
            check(k1[b]["form"] == "cluster_fp32", f"phase 22c: the "
                  f"teacher's K1 at B={b} takes the {k1[b]['form']} form")
    source, to_env = teacher.as_pilot()
    a = source(frames[0][..., None], goals[0], 0)
    check(np.array_equal(a, np.clip(got["B=1"], -e.max_action,
                                    e.max_action))
          and to_env(a) == [(a[0] + 1.0) * e.linear_cmd_scale,
                            a[1] * e.angular_cmd_scale],
          "phase 22c: as_pilot's source or command map")
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    kept = rtd.main(["--actor", str(TEACHER), "--world", "rand2",
                     "--episodes", "2", "--max-steps", str(TEACHER_STEPS),
                     "--out", str(Path(out_dir) / "teacher"),
                     "--keep-failures", "--device", DEVICE], base=cfg)
    tool_s = time.perf_counter() - t0
    launches = {kk: fn.launches for kk, fn in counters.items()}
    rows, wins = 0, 0
    for path in kept:
        with np.load(path) as z:
            check(set(z.files) == {"obs", "act", "goal", "reward",
                                   "next_obs", "next_goal", "done"}
                  and z["obs"].shape[1:] == tuple(cfg.model.image_size)
                  and z["next_obs"].shape == z["obs"].shape
                  and z["act"].shape == (len(z["obs"]), 2)
                  and bool((np.abs(z["act"]) <= e.max_action).all()),
                  f"phase 22c: {path} is not in the reference layout with "
                  f"policy-unit actions")
            rows += len(z["obs"])
            wins += int(z["reward"].max() >= 100.0)
    # every step acts once and records its frame (no action is zero)
    check(launches == {**{kk: 0 for kk in counters}, "K1": rows},
          f"phase 22c: the tool launched {launches} for {rows} recorded "
          f"steps")
    print(f"phase 22c teacher ({card()}): record_teacher_demos on rand2, "
          f"{len(kept)} episodes, {rows} steps ({wins} reached the goal) "
          f"in {tool_s:.1f} s (host clock, {tool_s / max(rows, 1) * 1e3:.2f}"
          f" ms a step: env and K1 at B=1); launches {launches}",
          flush=True)
    return {"launches": launches, "k1": k1, "episodes": len(kept),
            "steps": rows, "successes": wins, "seconds": tool_s}


def phase_generalization(out_dir, bc_fit):
    """Phase 22d, a main path: generalization_eval.main on 22b's corpus
    from the round-3 warm start (GEN_ARGS, GEN_BUDGET): the copy byte for
    byte, the fine-tune's actor before its first update equal to it bit
    for bit, every guided update PER_GUIDED's launches and K1 once a
    collection step and once an evaluation step, finite losses,
    final_actor.npz in JAX's key set, the summary's keys; then --skip-rl
    on a 2-epoch fit of the same corpus."""
    import torch

    from dgvit_tpu_torch.core.checkpoint import load_params_npz
    from dgvit_tpu_torch.examples import generalization_eval as ge
    from dgvit_tpu_torch.models import params_from_jax
    from dgvit_tpu_torch.train import fused_train as ft

    counters = kernel_counters()
    warm_npz = Path(str(BC_WARM) + "_actor.npz")
    warm_keys = set(load_params_npz(str(warm_npz)))
    corpus = bc_fit["demo_dir"]
    first = {}
    real = ft.make_fused_round

    def make_round(*a, **kw):
        run = real(*a, **kw)

        def first_seen(state, *ra, **rk):
            if not first:
                first.update({kk: v.detach().clone() for kk, v in
                              state.actor.state_dict().items()})
            return run(state, *ra, **rk)
        return first_seen

    out = Path(out_dir) / "gen"
    argv = GEN_ARGS + GEN_BUDGET + ["--demos", corpus, "--bc-params",
                                    str(BC_WARM)]
    args = ge.parser().parse_args(argv)
    for fn in counters.values():
        fn.launches = 0
    ft.make_fused_round = make_round
    t0 = time.perf_counter()
    try:
        summary = ge.main(argv + ["--out", str(out), "--device", DEVICE],
                          base=gen_base())
    finally:
        ft.make_fused_round = real
    gen_s = time.perf_counter() - t0
    launches = {kk: fn.launches for kk, fn in counters.items()}
    rows = [json.loads(line) for line in next((out / "rl").glob(
        "train_fused_*.jsonl")).read_text().splitlines()]
    rounds = len(rows)
    updates = rounds * args.n_envs * args.chunk
    eval_steps = 2 * 200          # rrc and hospital, env.max_steps each
    want = {**{kk: n * updates for kk, n in PER_GUIDED.items()},
            "K1": rounds * args.chunk + eval_steps}
    check(launches == want, f"phase 22d: the launcher launched {launches},"
          f" expected {want} ({rounds} rounds of {updates // rounds} guided "
          f"updates, then {eval_steps} evaluation steps)")
    check((out / "il" / "bc_warm_actor.npz").read_bytes()
          == warm_npz.read_bytes(), "phase 22d: the copied warm start is "
          "not the source byte for byte")
    warm = params_from_jax(load_params_npz(str(warm_npz)))
    check(set(first) == set(warm) and all(
        torch.equal(first[kk].cpu(), warm[kk]) for kk in warm),
        "phase 22d: the fine-tune's actor before its first update is not "
        "the warm start")
    check(all(math.isfinite(r[kk]) for r in rows
              for kk in ("qf1_loss", "policy_loss", "alpha")),
          "phase 22d: the fine-tune's losses are not finite")
    check(set(load_params_npz(str(out / "final_actor.npz"))) == warm_keys,
          "phase 22d: final_actor.npz lacks JAX's keys")
    check(list(summary) == GEN_KEYS and summary["sac_goals"] >= 0
          and summary["recipe"] == "alpha0=0.05 expert=True gw=10.0",
          f"phase 22d: the summary line {summary}")
    print(f"phase 22d generalization_eval ({card()}): "
          f"{' '.join(GEN_ARGS + GEN_BUDGET)} from the round-3 warm start on"
          f" 22b's corpus: {rounds} rounds, {updates} guided updates, "
          f"{rows[-1]['episodes']} episodes, then run_eval_vec of "
          f"{args.eval_episodes} episodes on rrc and hospital, in "
          f"{gen_s:.1f} s (host clock); summary {json.dumps(summary)}",
          flush=True)

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    bc_only = ge.main(["--demos", corpus, "--bc-epochs", "2", "--skip-rl",
                       "--vec-eval", "--eval-episodes",
                       str(args.eval_episodes), "--out",
                       str(Path(out_dir) / "gen_bc"), "--device", DEVICE],
                      base=gen_base())
    bc_s = time.perf_counter() - t0
    bc_launches = {kk: fn.launches for kk, fn in counters.items()}
    want = {**{kk: 2 * n for kk, n in bc_fit["per_epoch"].items()},
            "K1": eval_steps}
    check(bc_launches == want and list(bc_only) == GEN_KEYS
          and math.isfinite(bc_only["bc_val_rmse"])
          and bc_only["recipe"] == "bc-only",
          f"phase 22d --skip-rl: launches {bc_launches}, expected {want}; "
          f"summary {bc_only}")
    print(f"phase 22d --skip-rl ({card()}): a 2-epoch fit and the "
          f"evaluations in {bc_s:.1f} s (host clock); summary "
          f"{json.dumps(bc_only)}", flush=True)
    return {"launches": launches, "rounds": rounds, "updates": updates,
            "seconds": gen_s, "summary": summary,
            "bc_only": {"launches": bc_launches, "seconds": bc_s,
                        "summary": bc_only}}


def imitation_launches(imitation, short):
    """A kernel's launches on phase 22's paths, for the kernels line."""
    return {"bc_fit": imitation["bc_fit"]["launches"][short],
            "teacher": imitation["teacher"]["launches"][short],
            "generalization":
                imitation["generalization"]["launches"][short],
            "generalization_bc_only":
                imitation["generalization"]["bc_only"]["launches"][short]}


def phase_imitation():
    """Phase 22 (22a-22d; 22e is the kernels line's bc_fit, teacher and
    generalization paths), on its own generator."""
    import numpy as np

    rng = np.random.default_rng(IMITATION_SEED)
    kernels = phase_bc_kernels(rng)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        fit = phase_bc_fit(out_dir)
        teacher = phase_teacher(out_dir)
        gen = phase_generalization(out_dir, fit)
    return {"bc_kernels": kernels, "bc_fit": fit, "teacher": teacher,
            "generalization": gen}


# --------------------------------------------------------------------------
# phase 23: the reference's own configuration and the rest of the model zoo
# --------------------------------------------------------------------------

ZOO_SEED = SEED + 23          # phase 23's own generator
ZOO_BATCH, ZOO_UPDATES = 32, 5    # the reference's BATCH_SIZE
# the reference's config.yaml (config.yaml:1-63 as SURVEY.md reads it: a
# GoT actor and a CNN critic, fp32), its episodes cut to ZOO_MAX_STEPS
# steps; the train runs' episodes (23a)
ZOO_MAX_STEPS, ZOO_EPISODES, ZOO_EVAL_EPISODES = 40, 10, 2
REFERENCE_YAML = {
    "SEED": 3407, "LATENT_FEATURES_SIZE": 64, "VIS_SENSOR": "fish_image",
    "MAX_STEPS": ZOO_MAX_STEPS, "MAX_EPISODES": 800, "BATCH_SIZE": 32,
    "LR_A": 1e-3, "LR_C": 1e-3, "GAMMA": 0.999, "TAU": 0.0005,
    "BUFFER_SIZE": 30000, "PRE_TRAIN": True, "PRE_BUFFER": True,
    "IF_TEST": False, "AUTO_TUNE": True, "FRAME_STACK": 4, "L_SCALE": 0.25,
    "A_SCALE": 1.0,
    "GoT-SAC": {"name": "gtrl", "actor_type": "GaussianTransformer",
                "critic_type": "CNN", "block": 4, "head": 4}}
# an update of the reference's configuration: the TD target's actor
# forward (K4), the actor's gradient-bearing pass (K2f x3 + K3f, back
# K3b + K2b x3); the CNN critic and its target run no kernel
PER_ZOO_UPDATE = {**{k: 0 for k in PER_UPDATE}, "K4": 1, "K2f": 3,
                  "K2b": 3, "K3f": 1, "K3b": 1}
NO_KERNELS = {k: 0 for k in PER_UPDATE}
# the SimpleViT pair at 256 patches: five attention-bearing forwards of
# two blocks each (the TD target's actor and target critic, the critic
# update, the actor step's actor and critic), K8 in each block
PER_VIT_UPDATE = {**NO_KERNELS, "K8": 10}
# K8 at the SimpleViT's shapes: 64 patches (attn_impl="pallas") and 256
VIT_ATTN_SHAPES = ((ZOO_BATCH, 8, 64, 64), (ZOO_BATCH, 8, 256, 64))
# the SimpleViT at 256 patches: JAX's factory hands the ViT no patch
# size (its patches stay 16 x 20), so 256 patches are 256 x 320 frames
VIT_LONG_IMAGE = (256, 320)
# the largest parameter difference allowed between 5 fp32 ViT updates
# through K8 and the same 5 through the plain version: about 6 times the
# 3.49e-5 an H100 80GB HBM3 at 700 W read, a fifth of one Adam step (lr
# 1e-3, which moves each parameter by about 1e-3 a step)
VIT_UPDATE_PARAM_MAX = 2e-4


def zoo_batch(rng, frame, b=None):
    """A seeded replay batch on the card, ZOO_BATCH rows unless `b`:
    frames in [0, 1] of `frame` shape, goals, actions in [-1, 1],
    rewards."""
    import torch

    b = ZOO_BATCH if b is None else b
    t = lambda a: torch.from_numpy(a.astype("float32")).to(DEVICE)
    return {"obs": t(rng.uniform(0, 1, (b, *frame))),
            "pobs": t(rng.uniform(0, 1, (b, 2))),
            "act": t(rng.uniform(-1, 1, (b, 2))),
            "rew": t(rng.normal(0, 1, (b, 1))),
            "next_obs": t(rng.uniform(0, 1, (b, *frame))),
            "next_pobs": t(rng.uniform(0, 1, (b, 2))),
            "done": torch.zeros((b, 1), device=DEVICE)}


def zoo_cfg(**model):
    """Config() at the flagship widths with `model` overrides, the
    reference's batch."""
    from dgvit_tpu_torch.config import Config

    return Config.from_dict({"model": model,
                             "sac": {"batch_size": ZOO_BATCH}})


def zoo_updates(cfg, batch, per_update, label, steps=None, dtype=None):
    """`steps` learn steps of a fresh agent on `batch`, each launching
    exactly `per_update` (None: any) with finite metrics; the median
    update time (host clock, synchronized, steps 1 on) and the act time of
    the batch (CUDA events). Returns (readings, agent, state)."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent

    steps = ZOO_UPDATES if steps is None else steps
    agent = SACAgent(cfg, dtype=dtype, device=DEVICE, seed=ZOO_SEED)
    state = agent.init_state()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    times, deltas = [], []
    for step in range(steps):
        before = {k: fn.launches for k, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = agent.learn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        deltas.append({k: fn.launches - before[k]
                       for k, fn in counters.items()})
        vals = {k: float(v) for k, v in m.items()}
        check(all(math.isfinite(v) for v in vals.values()),
              f"phase 23 {label}: non-finite metrics at step {step}: {vals}")
        check(per_update is None or deltas[-1] == per_update,
              f"phase 23 {label} step {step} launched {deltas[-1]}, "
              f"expected {per_update}")
    launches = {k: fn.launches for k, fn in counters.items()}
    obs, pobs = batch["obs"], batch["pobs"]
    act_ms = cuda_ms(lambda: agent.act_batch(state.actor, obs, pobs,
                                             evaluate=True), 10, runs=5)
    out = {"update_ms": statistics.median(times[1:]) * 1e3,
           "first_update_ms": times[0] * 1e3, "act_ms": act_ms,
           "launches": launches, "per_update": deltas[-1],
           "metrics": vals, "batch": int(obs.shape[0]),
           "dtype": str(agent.dtype or torch.float32).split(".")[-1]}
    print(f"phase 23 {label} ({card()}): {steps} updates at B="
          f"{out['batch']} {out['dtype']}, median {out['update_ms']:.2f} ms "
          f"an update (host clock, synchronized; first "
          f"{out['first_update_ms']:.1f} ms), act {act_ms:.4f} ms (CUDA "
          f"events); launches an update {deltas[-1]}; last metrics "
          + ", ".join(f"{k} {v:.5g}" for k, v in vals.items()), flush=True)
    return out, agent, state


def update_tensors(agent, state, batch):
    """One update of `state` in place: its metrics (0-d tensors) and the
    gradient of every actor and critic parameter that has one."""
    _, m = agent.learn(state, batch)
    grads = [p.grad for k in ("actor", "critic")
             for p in getattr(state, k).parameters() if p.grad is not None]
    return [v.detach().float().reshape(1) for v in m.values()] + grads


def reference_yaml(out_dir):
    import yaml

    path = Path(out_dir) / "config.yaml"
    path.write_text(yaml.safe_dump(REFERENCE_YAML))
    return str(path)


# fp32 K4's batches, each timed in the cluster form and the FMA body
# (phase 23a): the reference config's B=32 among batches from one frame
# to past K1's cluster bound (90 frames on an H100), where K4's route
# rule would keep or drop it
K4_FP32_BATCHES = (1, 32, 64, 128, 256, 512)


def k4_fp32_times(actor, rng):
    """Phase 23a's K4 in fp32 on `actor`'s trunk (the reference config's
    widths: 4 heads x 64, MLP 2048): at each of K4_FP32_BATCHES seeded
    frames embedded by the actor, the cluster form and the FMA body forced
    (`body`), each held to the plain version (F32_TOL) and timed (CUDA
    events) beside the plain version and the bound at the fp32 peak; at
    ZOO_BATCH the route's form must be the fp32 cluster. Returns B=32's
    times with every batch's under "by_batch"."""
    import torch

    from dgvit_tpu_torch.ops import got_megakernel as gm

    trans, forms = actor.trans, {"cluster": gm.K4_FORMS["cluster_fp32"],
                                 "fma": gm.K4_FORMS["fma"]}
    by_batch = {}
    for b in K4_FP32_BATCHES:
        batch = zoo_batch(rng, (128, 160), b)
        with torch.no_grad():
            x = trans.embed(batch["obs"], actor.fc_embed(
                batch["pobs"])).contiguous()
            _, _, blocks, fn = trans.fused_params(torch.float32)
            blocks, fn = gm._flat_vectors(blocks, fn)
            k4 = (x, blocks, fn, trans.heads, trans.dim_head,
                  trans.final_norm)
            form = gm.k4_form(x, blocks, trans.heads, trans.dim_head)
            ref = gm.blocks_forward_plain(*k4)
            bnd, by = bound_ms(*train_work("K4", b, esize=4), "float32")
            row = {"form": form, "bound_ms": bnd, "bound_by": by,
                   "library_ms": None,
                   "plain_ms": cuda_ms(lambda: gm.blocks_forward_plain(*k4),
                                       5, runs=5)}
            for name, body in forms.items():
                run = lambda: gm._launch_blocks(*k4, body=body)
                err = f32_ratio(run(), ref)
                check(err <= 1, f"phase 23a: K4 fp32 {name} at B={b} "
                      f"disagrees with its plain version ({err:.3e} of "
                      "F32_TOL)")
                row[f"{name}_ms"] = cuda_ms(run, 10, runs=5)
                row[f"{name}_err"] = (run() - ref).abs().max().item()
        by_batch[b] = row
        print(f"phase 23a K4 fp32 at B={b} ({card()}): the route's form "
              f"{form}; cluster {row['cluster_ms']:.4f} ms, FMA body "
              f"{row['fma_ms']:.4f}, plain {row['plain_ms']:.4f}, bound "
              f"{bnd:.5f} ({by}); max|err| vs plain: cluster "
              f"{row['cluster_err']:.3e}, FMA {row['fma_err']:.3e} (CUDA "
              "events)", flush=True)
    t = by_batch[ZOO_BATCH]
    check(t["form"] == "cluster_fp32", f"phase 23a: K4 fp32 at B="
          f"{ZOO_BATCH} takes the {t['form']} form")
    return {"ms": t["cluster_ms"], "fma_ms": t["fma_ms"],
            "max_abs_err": t["cluster_err"],
            **{k: t[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "form")},
            "by_batch": {str(b): v for b, v in by_batch.items()}}


# fp32 K3's batches, each timed in the cluster form and the FMA body
# (phase 23a): the reference config's B=32 among batches from one frame
# to 512, where a batch bound of the route rule would show
K3_FP32_BATCHES = (1, 8, 32, 64, 128, 256, 512)
K3_FP32_SPLIT = (32, 64, 128)   # ... and read by device time by kernel


def k3_fp32_times(actor, rng):
    """Phase 23a's K3f and K3b in fp32 on `actor`'s last block (the
    reference config's widths: 4 heads x 64, MLP 2048): at each of
    K3_FP32_BATCHES seeded frames embedded by the actor and run through
    its other blocks (the plain version), the cluster form and the FMA
    body forced (`form`; each K3b on its own K3f's records), each held to
    the plain version (F32_TOL, every tensor) and timed (CUDA events)
    beside the plain version and the bound at the fp32 peak; K3f with its
    records, as under autograd; at K3_FP32_SPLIT the cluster form's
    device time by CUDA kernel (torch.profiler). At ZOO_BATCH the route's
    form must be the fp32 cluster. Returns {"K3f": ..., "K3b": ...}, each
    B=32's times with every batch's under "by_batch"."""
    import torch

    from dgvit_tpu_torch.ops import cls_block as cb
    from dgvit_tpu_torch.ops import fused_transformer as ft

    trans, by_batch = actor.trans, {"K3f": {}, "K3b": {}}
    heads, dh = trans.heads, trans.dim_head
    for b in K3_FP32_BATCHES:
        batch = zoo_batch(rng, (128, 160), b)
        with torch.no_grad():
            x = trans.embed(batch["obs"], actor.fc_embed(
                batch["pobs"])).contiguous()
            blocks = trans.fused_params(torch.float32)[2]
            for w in blocks[:-1]:
                x = ft.block_fwd_plain(x, w, heads, dh)
        w = blocks[-1]
        dy = torch.from_numpy(rng.standard_normal((b, x.shape[2])).astype(
            "float32")).to(DEVICE)
        recs = {2: cb.saved_buffer(x, w, heads, dh),
                0: cb.saved_buffer(x, w, heads, dh)}
        fwd = {f: (lambda f=f: ft.launch_block_fwd(
            x, w, heads, dh, True, saved=recs[f], form=f)) for f in recs}
        bwd = {f: (lambda f=f: ft.launch_block_bwd(
            x, dy, w, heads, dh, True, saved=recs[f], form=f)) for f in recs}
        plain = {"K3f": lambda: cb.cls_fwd_plain(x, w, heads, dh),
                 "K3b": lambda: cb.cls_bwd_plain(x, dy, w, heads, dh,
                                                 recs[2])}
        for name, calls, form in (
                ("K3f", fwd, ft.block_form(x, w, dh, True)),
                ("K3b", bwd, ft.block_form(x, w, dh, True, dy))):
            bnd, by = bound_ms(*train_work(name, b, esize=4), "float32")
            row = {"form": form, "bound_ms": bnd, "bound_by": by,
                   "library_ms": None,
                   "plain_ms": cuda_ms(plain[name], 5, runs=5)}
            for label, f in (("cluster", 2), ("fma", 0)):
                if name == "K3b":   # each backward on its own forward
                    fwd[f]()
                got, ref = tensors(calls[f]()), tensors(
                    cb.cls_bwd_plain(x, dy, w, heads, dh, recs[f])
                    if name == "K3b" else plain[name]())
                err = max(f32_ratio(o, r) for o, r in zip(got, ref))
                check(err <= 1, f"phase 23a: {name} fp32 {label} at B={b} "
                      f"disagrees with its plain version ({err:.3e} of "
                      "F32_TOL)")
                row[f"{label}_ms"] = cuda_ms(calls[f], 10, runs=5)
                row[f"{label}_err"] = max((o - r).abs().max().item()
                                          for o, r in zip(got, ref))
            if b in K3_FP32_SPLIT:   # the cluster form by CUDA kernel
                row["cluster_device_ms"] = {
                    re.search(r"::(\w+)", k).group(1) if "::" in k else k:
                    v for k, v in device_kernels_ms(calls[2], 20).items()}
            by_batch[name][b] = row
            print(f"phase 23a {name} fp32 at B={b} ({card()}): the route's "
                  f"form {form}; cluster {row['cluster_ms']:.4f} ms, FMA "
                  f"body {row['fma_ms']:.4f}, plain {row['plain_ms']:.4f}, "
                  f"bound {bnd:.5f} ({by}); max|err| vs plain: cluster "
                  f"{row['cluster_err']:.3e}, FMA {row['fma_err']:.3e} "
                  "(CUDA events)", flush=True)
    out = {}
    for name, rows in by_batch.items():
        t = rows[ZOO_BATCH]
        check(t["form"] == 2, f"phase 23a: {name} fp32 at B={ZOO_BATCH} "
              f"takes form {t['form']}")
        out[name] = {"ms": t["cluster_ms"], "fma_ms": t["fma_ms"],
                     "max_abs_err": t["cluster_err"], "form": "cluster_fp32",
                     **{k: t[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                          "library_ms")},
                     "by_batch": {str(b): v for b, v in rows.items()}}
    return out


def phase_reference_config(rng, out_dir):
    """Phase 23a: the reference's configuration (load_reference_yaml: a
    GoT actor, a CNN critic, fp32). One fp32 update at B=32 through the
    kernels held to the float64-sum version of the plain versions under
    phase 5's fp32 rule (EXACT_K), a tanh GELU failing it; 5 updates in
    fp32 and in bf16, each launching PER_ZOO_UPDATE; the CNN critic's
    TF32 difference; K1's form for its actor at B=1 (the fp32 cluster);
    `train_rl.main(["--reference-config", ...])` on the card, the bf16
    config through `train`, then `run_eval`."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.config import load_reference_yaml
    from dgvit_tpu_torch.core.checkpoint import load_params_npz
    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.models.policies import GoTPolicy, QNetwork
    from dgvit_tpu_torch.ops import got_megakernel as gm
    from dgvit_tpu_torch.train import train_rl
    from dgvit_tpu_torch.train.evaluate import run_eval

    path = reference_yaml(out_dir)
    cfg = load_reference_yaml(path)
    check(cfg.model.critic_type == "CNN" and cfg.model.compute_dtype ==
          "float32" and cfg.sac.batch_size == ZOO_BATCH,
          "phase 23a: the translated config is not the reference's")
    batch = zoo_batch(rng, (128, 160))
    counters = kernel_counters()

    def one_update():
        agent = SACAgent(cfg, device=DEVICE, seed=ZOO_SEED)
        state = agent.init_state()
        check(isinstance(state.actor, GoTPolicy)
              and isinstance(state.critic, QNetwork),
              "phase 23a: not a GoT actor beside a CNN critic")
        return update_tensors(agent, state, batch)

    for fn in counters.values():
        fn.launches = 0
    out = one_update()
    launches = {k: fn.launches for k, fn in counters.items()}
    check(launches == PER_ZOO_UPDATE, f"phase 23a: the fp32 update "
          f"launched {launches}, expected {PER_ZOO_UPDATE}")
    with plain_kernels():
        ref = one_update()
        ex = exact(one_update)
        with other_gelu():
            bad = one_update()
    check(all(fn.launches == launches[k] for k, fn in counters.items()),
          "phase 23a: the plain update launched a kernel")
    k = EXACT_K["fp32"]
    ok, got, limit = restated(rel_max, TRAIN_F32_MAX, k, out, ref, ex)
    bad_ok, bad_got, _ = restated(rel_max, TRAIN_F32_MAX, k, bad, ref, ex)
    own = rel_max(ref, ex)
    check_reading = {"got": got, "limit": limit, "plain": own,
                     "old": rel_max(out, ref), "tanh_gelu": bad_got,
                     "tensors": len(out), "pass": ok,
                     "tanh_gelu_pass": bad_ok}
    print(f"phase 23a fp32 update of the reference's configuration, B="
          f"{ZOO_BATCH}: metrics and {len(out) - 6} gradients, largest "
          f"max|err|/L against float64 sums {got:.3e} (limit max("
          f"{TRAIN_F32_MAX:g}, {k:g} x plain {own:.3e}) = {limit:.3e}), old "
          f"reading vs plain {check_reading['old']:.3e}; "
          f"{'passes' if ok else 'FAILS'}; wrong (tanh GELU) {bad_got:.3e},"
          f" {'passes' if bad_ok else 'FAILS'} (must fail)", flush=True)
    record("reference config update fp32", k=k, **check_reading)
    check(ok, "phase 23a: the reference config's update through the "
          "kernels disagrees with the float64-sum version")
    check(not bad_ok, "phase 23a: the fp32 rule passes a wrong update "
          "(tanh GELU)")

    runs = {}
    runs["fp32"], agent, state = zoo_updates(
        cfg, batch, PER_ZOO_UPDATE, "23a reference config fp32")
    cfg_bf = load_reference_yaml(path)
    cfg_bf.model.compute_dtype = "bfloat16"
    runs["bf16"], _, _ = zoo_updates(cfg_bf, batch, PER_ZOO_UPDATE,
                                     "23a reference config bf16")

    # K4 in fp32 alone on the actor's widths (the no-grad learn forward of
    # each update; main's launches below): its form at B=32 (the fp32
    # cluster), timed beside the FMA body, its plain version and its bound
    # at the fp32 peak, and the two forms forced at K4_FP32_BATCHES, where
    # the route rule's batch bound is read (frames of a generator of their
    # own: the later phases of 23 keep their draws)
    k4_fp32 = k4_fp32_times(state.actor,
                            np.random.default_rng((ZOO_SEED, ZOO_BATCH)))
    # K3f and K3b in fp32 alone on the actor's last block (the learn
    # step's gradient-bearing pass), the same way, on a generator of their
    # own
    k3_fp32 = k3_fp32_times(state.actor,
                            np.random.default_rng((ZOO_SEED, ZOO_BATCH, 3)))

    # the CNN critic's convolutions with TF32 on (PyTorch's default)
    # against full fp32 (this script's setting), on the same batch
    with torch.no_grad():
        args = (batch["obs"], batch["pobs"], batch["act"])
        full = torch.cat(state.critic(*args), 1)
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = torch.cat(state.critic(*args), 1)
        finally:
            torch.backends.cudnn.allow_tf32 = False
    tf32_rel = ((tf32 - full).abs().max()
                / full.abs().max().clamp(min=1e-30)).item()
    print(f"phase 23a CNN critic fp32 at B={ZOO_BATCH}, cuDNN with TF32 on "
          f"against off: Q max|diff|/L {tf32_rel:.3e}", flush=True)

    # the entry points: main on the card, train with the bf16 config
    # the form K1 takes for the reference config's fp32 actor at B=1, as
    # its train loop and run_eval act
    with torch.no_grad():
        act_form = gm.k1_form(*trunk_inputs(
            state.actor, 1, np.random.default_rng(ZOO_SEED)))
    print(f"phase 23a: the reference config's fp32 actor acts through K1's "
          f"{act_form} form (B=1)", flush=True)
    check(act_form == "cluster_fp32", f"phase 23a: K1 at B=1 takes the "
          f"{act_form} form")
    for fn in counters.values():
        fn.launches = 0
    for kk in ("K4", "K3f", "K3b"):
        counters[kk].cluster_launches = 0
    t0 = time.perf_counter()
    main_dir = Path(out_dir) / "main"
    train_rl.main(["--reference-config", path, "--episodes",
                   str(ZOO_EPISODES), "--out", str(main_dir),
                   *(["--device", DEVICE] if DEVICE != "cuda" else [])])
    main_s = time.perf_counter() - t0
    main_launches = {k: fn.launches for k, fn in counters.items()}
    main_cluster = counters["K4"].cluster_launches
    updates = main_launches["K4"]
    check(updates >= ZOO_UPDATES and main_launches["K1"] > 0
          and all(main_launches[k] == n * updates
                  for k, n in PER_ZOO_UPDATE.items() if k != "K1"),
          f"phase 23a: train_rl.main launched {main_launches}")
    check(main_cluster == updates, f"phase 23a: {main_cluster} of main's "
          f"{updates} fp32 K4 launches took the cluster form")
    k3_cluster = {kk: counters[kk].cluster_launches for kk in ("K3f", "K3b")}
    check(k3_cluster["K3f"] == k3_cluster["K3b"] == main_launches["K3f"]
          == main_launches["K3b"], f"phase 23a: of main's fp32 K3f and K3b "
          f"launches {main_launches['K3f']}, {main_launches['K3b']}, "
          f"{k3_cluster} took the cluster form")
    for fn in counters.values():
        fn.launches = 0
    timings = {}
    env = KinematicNavEnv(seed=SEED, world="rrc")
    out_bf = train_rl.train(cfg_bf, env, out_dir=str(Path(out_dir) / "bf16"),
                            max_episodes=ZOO_EPISODES, device=DEVICE,
                            timings=timings)
    bf_launches = {k: fn.launches for k, fn in counters.items()}
    n_up, n_env = timings["updates"], timings["env_steps"]
    check(n_up >= ZOO_UPDATES and bf_launches["K1"] == n_env
          and all(bf_launches[k] == n * n_up
                  for k, n in PER_ZOO_UPDATE.items() if k != "K1"),
          f"phase 23a: train (bf16) launched {bf_launches} for {n_env} env "
          f"steps and {n_up} updates")
    for fn in counters.values():
        fn.launches = 0
    actor = load_params_npz(str(next((main_dir / "models").glob(
        "*_actor.npz"))))
    report = run_eval(cfg, KinematicNavEnv(seed=SEED, world="rrc"), actor,
                      max_episodes=ZOO_EVAL_EPISODES,
                      out_dir=str(Path(out_dir) / "eval"), device=DEVICE)
    eval_launches = {k: fn.launches for k, fn in counters.items()}
    check(eval_launches["K1"] > 0 and sum(eval_launches.values())
          == eval_launches["K1"], f"phase 23a: run_eval launched "
          f"{eval_launches}")
    print(f"phase 23a entry points ({card()}): train_rl.main "
          f"--reference-config, {ZOO_EPISODES} episodes of at most "
          f"{ZOO_MAX_STEPS} steps in {main_s:.1f} s, launches "
          f"{main_launches}, on the fp32 cluster forms K4 {main_cluster}, "
          f"K3f {k3_cluster['K3f']}, K3b {k3_cluster['K3b']}; train with "
          f"the bf16 config: {n_env} env steps, "
          f"{n_up} updates, launches {bf_launches}, {out_bf['episodes']} "
          f"episodes; run_eval {ZOO_EVAL_EPISODES} episodes: launches "
          f"{eval_launches}, successes {report['successes']}", flush=True)
    return {"check": check_reading, "updates": runs, "tf32_q_rel": tf32_rel,
            "launches": {"reference_config_main": main_launches,
                         "reference_config_train_bf16": bf_launches,
                         "reference_config_run_eval": eval_launches,
                         "reference_config_updates_fp32":
                             runs["fp32"]["launches"],
                         "reference_config_updates_bf16":
                             runs["bf16"]["launches"]},
            "train_bf16": {"env_steps": n_env, "updates": n_up},
            "main_s": main_s, "k1_form": act_form, "k4_fp32": k4_fp32,
            "k4_cluster_launches": main_cluster, "k3_fp32": k3_fp32,
            "k3_cluster_launches": k3_cluster}


def vit_attention_checks(rng):
    """K8 at the SimpleViT's shapes against its plain version, fp32 and
    bf16, forward and backward (phase 15's limits), a mis-scaled version
    failing them; times beside the plain version, the bound and
    scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F

    from dgvit_tpu_torch.ops.attention import (attention_fused,
                                               attention_plain)

    worst, times = {}, {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for shape in VIT_ATTN_SHAPES:
            s = shape[-1] ** -0.5
            q, k, v, dy = (torch.from_numpy(rng.standard_normal(shape)
                                            .astype("float32"))
                           .to(DEVICE).to(dt) for _ in range(4))
            out, ref = attention_fused(q, k, v, s), attention_plain(q, k, v,
                                                                    s)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            grads = torch.autograd.grad(attention_fused(*leaves, s), leaves,
                                        dy)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            ref_grads = torch.autograd.grad(attention_plain(*leaves, s),
                                            leaves, dy)
            wrong = attention_plain(q, k, v, s * s)
            scale = ref.float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            gerr = rel_max(grads, ref_grads)
            reading = ""
            if dtype == "float32":
                ok, reading = k8_f32_reading(
                    "phase 23b", str(shape), out, ref, grads, ref_grads,
                    (q, k, v), s, {"scale 1 / D": wrong})
                caught = ((wrong - ref).abs().max().item()
                          > TRAIN_F32_MAX * scale)
            else:
                e, w = TrainErrors(), TrainErrors()
                e.add([(out, ref), *zip(grads, ref_grads)])
                w.add([(wrong, ref)])
                ok, caught = e.ok, not w.ok
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            print(f"phase 23b K8 vs plain {dtype} {shape}: max|err| "
                  f"{err:.3e} (max|ref| {scale:.3e}), backward max|err|/L "
                  f"{gerr:.3e} {'ok' if ok else 'FAIL'}; wrong (scale 1 / "
                  f"D) {'fails' if caught else 'PASSES'}{reading}",
                  flush=True)
            check(ok, f"phase 23b: K8 disagrees with its plain version "
                  f"({dtype} {shape})")
            check(caught, f"phase 23b: K8's limits pass a wrong version "
                  f"({dtype} {shape})")
            bnd, by = k8_bound(shape, dtype)
            kern = lambda: attention_fused(q, k, v, s)
            times[f"{dtype} {shape}"] = t = dict(
                ms=cuda_ms(kern, 10, runs=5),
                plain_ms=cuda_ms(lambda: attention_plain(q, k, v, s), 5,
                                 runs=5),
                bound_ms=bnd, bound_by=by,
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=s), 10, runs=5),
                **({"fma_ms": cuda_ms(lambda: k8_fma(q, k, v, s), 10,
                                      runs=5)} if dtype == "float32"
                   else {}))
            print(f"phase 23b K8 {dtype} {shape} ({card()}): kernel "
                  f"{t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
                  f"({t['bound_by']}), scaled_dot_product_attention "
                  f"{t['library_ms']:.4f} ms" + (
                      f", its first design (the FMA attention_kernel) "
                      f"{t['fma_ms']:.4f} ms" if "fma_ms" in t else "")
                  + " (CUDA events)", flush=True)
    return worst, times


def phase_vit(rng):
    """Phase 23b: the SimpleViT family at its published widths (vit_dim
    256, depth 2, 8 heads x 64, MLP 2048). K8 at (32, 8, 64, 64) and
    (32, 8, 256, 64); build_actor(cfg, attn_impl="pallas") at 64 patches,
    its actions through K8 (K8 x2 a forward) against the plain route, fp32
    and bf16; at 256 patches (256 x 320 frames), where `auto` takes K8, 5
    fp32 SAC updates through K8 against the same 5 through the plain
    version (metrics and parameters), and 5 bf16 updates."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.models import build_actor

    worst, times = vit_attention_checks(rng)
    counters = kernel_counters()
    cfg = zoo_cfg(backbone="simple_vit")
    obs = torch.from_numpy(rng.uniform(0, 1, (ZOO_BATCH, 128, 160)).astype(
        "float32")).to(DEVICE)
    goal = torch.from_numpy(rng.uniform(-1, 1, (ZOO_BATCH, 2)).astype(
        "float32")).to(DEVICE)
    acting, acting_launches = {}, {k: 0 for k in counters}
    gen = torch.Generator().manual_seed(ZOO_SEED)
    sd = build_actor(cfg, generator=gen).state_dict()
    for fn in counters.values():
        fn.launches = 0
    for dtype, tol in (("float32", ACTION_FP32), ("bfloat16", ACTION_BF16)):
        pol = build_actor(cfg, dtype=getattr(torch, dtype),
                          attn_impl="pallas")
        pol.load_state_dict(sd)
        pol = pol.to(DEVICE).eval()
        before = {k: fn.launches for k, fn in counters.items()}
        with torch.no_grad():
            a = torch.tanh(pol(obs, goal, inference=True)[0])
            delta = {k: fn.launches - before[k]
                     for k, fn in counters.items()}
            with plain_kernels():
                p = torch.tanh(pol(obs, goal, inference=True)[0])
        for k, n in delta.items():
            acting_launches[k] += n
        n_k8 = delta["K8"]
        err = (a - p).abs().max().item()
        acting[dtype] = {"max_abs_err": err, "k8_launches": n_k8,
                         "act_ms": cuda_ms(lambda: pol(obs, goal,
                                                       inference=True),
                                           10, runs=5)}
        print(f"phase 23b ViT actor attn_impl='pallas' {dtype}, 64 patches,"
              f" B={ZOO_BATCH}: K8 x{n_k8} a forward, actions vs the plain "
              f"route max|err| {err:.3e} (limit {tol:g}); act "
              f"{acting[dtype]['act_ms']:.4f} ms ({card()}, CUDA events)",
              flush=True)
        check(delta == {**NO_KERNELS, "K8": 2} and err <= tol,
              f"phase 23b: the ViT actor's {dtype} actions through K8 "
              f"(launches {delta}) disagree with the plain route")

    long_cfg = zoo_cfg(backbone="simple_vit",
                       image_size=list(VIT_LONG_IMAGE))
    batch = zoo_batch(rng, VIT_LONG_IMAGE)

    def five():
        agent = SACAgent(long_cfg, device=DEVICE, seed=ZOO_SEED)
        state = agent.init_state()
        metrics = []
        for _ in range(ZOO_UPDATES):
            state, m = agent.learn(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, {f"{k}.{n}": p.detach().clone()
                         for k in ("actor", "critic")
                         for n, p in getattr(state, k).named_parameters()}

    def differences(other):
        om, op = other
        return (max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                    for a, b in zip(km, om) for k in a),
                max((kp[n] - op[n]).abs().max().item() for n in kp))

    for fn in counters.values():
        fn.launches = 0
    km, kp = five()
    updates_launches = {k: fn.launches for k, fn in counters.items()}
    with plain_kernels():
        worst_m, worst_p = differences(five())
        # planted fault: the plain route with the scores scaled by 1 / D
        # where the model asks 1 / sqrt(D)
        from dgvit_tpu_torch.ops import attention as att
        launch = att._launch
        att._launch = lambda q, k, v, s: att.attention_plain(q, k, v, s * s)
        try:
            wrong_m, wrong_p = differences(five())
        finally:
            att._launch = launch
    want = {k: ZOO_UPDATES * n for k, n in PER_VIT_UPDATE.items()}
    print(f"phase 23b ViT SAC, 256 patches ({VIT_LONG_IMAGE} frames), fp32,"
          f" B={ZOO_BATCH}: {ZOO_UPDATES} updates through K8 (launches "
          f"{updates_launches}) against the plain version: metrics largest "
          f"relative difference {worst_m:.3e} (limit {UPDATE_RTOL:g}), "
          f"parameters max|diff| {worst_p:.3e} (limit "
          f"{VIT_UPDATE_PARAM_MAX:g}); planted fault (scores scaled 1 / D): "
          f"metrics {wrong_m:.3e}, parameters {wrong_p:.3e} "
          f"({'fails' if wrong_p > VIT_UPDATE_PARAM_MAX else 'PASSES'} the "
          f"parameter limit)", flush=True)
    check(updates_launches == want,
          f"phase 23b: 5 ViT updates launched {updates_launches}, "
          f"expected {want}")
    check(worst_m <= UPDATE_RTOL and worst_p <= VIT_UPDATE_PARAM_MAX,
          "phase 23b: the ViT updates through K8 disagree with the plain "
          "version")
    check(wrong_p > VIT_UPDATE_PARAM_MAX, "phase 23b: the parameter limit "
          "passes the updates of a wrongly scaled attention")
    runs = {}
    runs["fp32"], _, _ = zoo_updates(long_cfg, batch, PER_VIT_UPDATE,
                                     "23b SimpleViT 256 patches fp32")
    runs["bf16"], _, _ = zoo_updates(long_cfg, batch, PER_VIT_UPDATE,
                                     "23b SimpleViT 256 patches bf16",
                                     dtype=torch.bfloat16)
    short_batch = zoo_batch(rng, (128, 160))
    runs["fp32_64_patches"], _, _ = zoo_updates(
        cfg, short_batch, NO_KERNELS, "23b SimpleViT 64 patches fp32 (auto:"
        " the plain route)")
    return {"k8_worst": worst, "k8_times": times, "acting": acting,
            "updates_vs_plain": {"metrics_rel": worst_m,
                                 "params_max": worst_p,
                                 "params_limit": VIT_UPDATE_PARAM_MAX,
                                 "wrong_scale_metrics_rel": wrong_m,
                                 "wrong_scale_params_max": wrong_p},
            "updates": runs,
            "launches": {"vit_pallas_acting": acting_launches,
                         "vit_256_updates_vs_plain": updates_launches,
                         "vit_256_updates_fp32": runs["fp32"]["launches"],
                         "vit_256_updates_bf16": runs["bf16"]["launches"]}}


def phase_cnn_deterministic(rng):
    """Phase 23c: the CNN and deterministic families at B=32: 5 fp32
    updates of GaussianConvNet + CNN (no kernel) and of
    DeterministicTransformer + Transformer (the GoT pair: PER_UPDATE's
    launches), alpha 0 for the deterministic actor; the Deterministic
    actor (a CNN on (B, H, W, 4) stacks), which SACAgent refuses by name
    as the JAX package's update fails on it, acts on such stacks (no
    kernel)."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.models import build_actor

    frames = (128, 160)
    runs = {}
    for key, label, model, per in (
            ("gaussian_cnn", "GaussianConvNet + CNN",
             dict(actor_type="GaussianConvNet", critic_type="CNN"),
             NO_KERNELS),
            ("deterministic_got", "DeterministicTransformer + Transformer",
             dict(actor_type="DeterministicTransformer"), PER_UPDATE)):
        runs[key], agent, _ = zoo_updates(zoo_cfg(**model),
                                          zoo_batch(rng, frames), per,
                                          f"23c {label}")
        if agent.deterministic_actor:
            check(runs[key]["metrics"]["alpha"] == 0.0,
                  f"phase 23c: {label} has alpha "
                  f"{runs[key]['metrics']['alpha']}")
    cfg = zoo_cfg(actor_type="Deterministic", critic_type="CNN")
    try:
        SACAgent(cfg, device=DEVICE)
        refused = False
    except NotImplementedError as e:
        refused = "Deterministic" in str(e)
    check(refused, "phase 23c: SACAgent did not refuse the Deterministic "
          "actor by name")
    pol = build_actor(cfg, generator=torch.Generator().manual_seed(
        ZOO_SEED)).to(DEVICE).eval()
    batch = zoo_batch(rng, (*frames, 4))
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    with torch.no_grad():
        a = pol(batch["obs"], batch["pobs"], inference=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    check(tuple(a.shape) == (ZOO_BATCH, 2) and bool(torch.isfinite(a).all())
          and float(a.abs().max()) <= 1.0 and launches == NO_KERNELS,
          f"phase 23c: the Deterministic actor's action {tuple(a.shape)}, "
          f"launches {launches}")
    act_ms = cuda_ms(lambda: pol(batch["obs"], batch["pobs"],
                                 inference=True), 10, runs=5)
    runs["deterministic_cnn_act"] = {"act_ms": act_ms, "launches": launches,
                                     "batch": ZOO_BATCH, "refused": refused}
    print(f"phase 23c Deterministic actor ({card()}): SACAgent refuses it "
          f"by name; act on ({ZOO_BATCH}, 128, 160, 4) stacks fp32 "
          f"{act_ms:.4f} ms (CUDA events), launches {launches}", flush=True)
    return runs


def phase_attention_fix(rng):
    """Phase 23d: head-only fine-tuning on the card: the GoT pair with
    train.policy_attention_fix and critic_attention_fix, 5 fp32 updates:
    `trans` and `fc_embed` bit-equal after them, the heads moved, no
    backward kernel launched (the frozen trunks take none); without the
    flags the trunks move."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.config import Config

    batch = zoo_batch(rng, (128, 160))
    out = {}
    for fix in (True, False):
        cfg = Config.from_dict({"sac": {"batch_size": ZOO_BATCH},
                                "train": {"policy_attention_fix": fix,
                                          "critic_attention_fix": fix}})
        fresh = SACAgent(cfg, device=DEVICE, seed=ZOO_SEED).init_state()
        before = {k: {n: p.detach().clone() for n, p in
                      getattr(fresh, k).named_parameters()}
                  for k in ("actor", "critic")}
        label = f"23d GoT pair, attention fix {'on' if fix else 'off'}"
        run, _, state = zoo_updates(cfg, batch, None, label)
        frozen_moved, heads_moved = [], []
        for k in ("actor", "critic"):
            for n, p in getattr(state, k).named_parameters():
                moved = not torch.equal(p, before[k][n])
                if n.startswith(("trans.", "fc_embed.")):
                    frozen_moved += [f"{k}.{n}"] if moved else []
                elif moved:
                    heads_moved.append(f"{k}.{n}")
        run.update(frozen_moved=len(frozen_moved),
                   heads_moved=len(heads_moved))
        print(f"phase 23d attention fix {'on' if fix else 'off'}: "
              f"{len(frozen_moved)} trunk / fc_embed tensors moved, "
              f"{len(heads_moved)} head tensors moved", flush=True)
        check(heads_moved, "phase 23d: the heads did not train")
        if fix:
            check(not frozen_moved, f"phase 23d: frozen tensors moved: "
                  f"{frozen_moved[:4]}")
            check(run["per_update"]["K2b"] == run["per_update"]["K3b"] == 0,
                  "phase 23d: a frozen trunk launched a backward kernel")
        else:
            check(frozen_moved, "phase 23d: the trunks did not train "
                  "without the flags")
        out["on" if fix else "off"] = run
    return out


def reference_state_dict(flat):
    """The reference's GoTPolicy state dict (GoalFormer.py module paths,
    torch layouts, the cls_token its forward never reads) holding the
    JAX-layout actor `flat`."""
    import numpy as np
    import torch

    sd, t = {}, lambda a: torch.from_numpy(np.ascontiguousarray(a))

    def linear(ref, key):
        sd[f"{ref}.weight"] = t(flat[f"{key}/kernel"].T)
        if f"{key}/bias" in flat:
            sd[f"{ref}.bias"] = t(flat[f"{key}/bias"])

    for name in ("fc_embed", "fc1", "fc2", "mean_linear", "log_std_linear"):
        linear(name, name)
    linear("trans.to_patch_embedding.1", "trans/patch_embed")
    sd["trans.pos_embedding"] = t(flat["trans/pos_embedding"])
    sd["trans.cls_token"] = torch.zeros(1, 1, flat["trans/norm_out/g"].size)
    sd["trans.layer_norm.g"] = t(flat["trans/norm_out/g"])
    i = 0
    while f"trans/transformer/block_{i}/attn_norm/scale" in flat:
        jb, lp = f"trans/transformer/block_{i}", f"trans.transformer.layers.{i}"
        for ref, key in (("0.norm", "attn_norm"), ("1.norm", "ff_norm")):
            sd[f"{lp}.{ref}.weight"] = t(flat[f"{jb}/{key}/scale"])
            sd[f"{lp}.{ref}.bias"] = t(flat[f"{jb}/{key}/bias"])
        for ref, key in (("0.fn.to_qkv", "attn/to_qkv"),
                         ("0.fn.to_out.0", "attn/to_out"),
                         ("1.fn.net.0", "ff/fc1"), ("1.fn.net.3", "ff/fc2")):
            linear(f"{lp}.{ref}", f"{jb}/{key}")
        i += 1
    return sd


def phase_torch_io(out_dir):
    """Phase 23e: the trained flagship actor as a reference checkpoint
    (reference_state_dict, saved with torch.save) loaded through
    torch_io.load_actor_pth: every tensor equal to params_from_jax's, and
    its bf16 actions through K1 on the golden frames bit-equal to those of
    the params_from_jax actor."""
    import torch

    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.core.checkpoint import load_params_npz
    from dgvit_tpu_torch.models import build_actor, params_from_jax
    from dgvit_tpu_torch.models import torch_io

    flat = load_params_npz(str(ACTOR))
    path = Path(out_dir) / "reference_actor.pth"
    torch.save(reference_state_dict(flat), path)
    loaded = torch_io.load_actor_pth(str(path))
    direct = params_from_jax(flat)
    check(set(loaded) == set(direct) and all(
        torch.equal(loaded[k], direct[k]) for k in direct),
        "phase 23e: load_actor_pth's parameters differ from params_from_jax")
    obs, goal = (torch.from_numpy(a).to(DEVICE) for a in golden_inputs())
    acts, counters = [], kernel_counters()
    before = counters["K1"].launches
    for sd in (loaded, direct):
        pol = build_actor(Config(), dtype=torch.bfloat16)
        pol.load_state_dict(sd)
        with torch.no_grad():
            acts.append(torch.tanh(pol.to(DEVICE).eval()(
                obs, goal, inference=True)[0]))
    k1 = counters["K1"].launches - before
    same = torch.equal(*acts)
    print(f"phase 23e torch_io: a reference checkpoint of the flagship actor"
          f" through load_actor_pth acts through K1 (x{k1}) bit-equal to "
          f"the params_from_jax actor: {same}", flush=True)
    check(k1 == 2 and same, "phase 23e: the torch_io actor acts otherwise")
    return {"k1_launches": k1, "bit_equal": same}


def phase_zoo():
    """Phase 23 (23a-23e), on its own generator; each sub-phase's time."""
    import numpy as np

    rng = np.random.default_rng(ZOO_SEED)
    out, secs = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        for key, fn in (("reference_config",
                         lambda: phase_reference_config(rng, out_dir)),
                        ("vit", lambda: phase_vit(rng)),
                        ("cnn_deterministic",
                         lambda: phase_cnn_deterministic(rng)),
                        ("attention_fix", lambda: phase_attention_fix(rng)),
                        ("torch_io", lambda: phase_torch_io(out_dir))):
            t0 = time.perf_counter()
            out[key] = fn()
            secs[key] = time.perf_counter() - t0
            print(f"phase 23 {key}: {secs[key]:.1f} s", flush=True)
    out["seconds"] = secs
    return out


def zoo_launches(zoo, short):
    """The launches of one kernel on phase 23's paths, by path."""
    paths = {**zoo["reference_config"]["launches"], **zoo["vit"]["launches"],
             **{f"zoo_{k}": v["launches"]
                for k, v in zoo["cnn_deterministic"].items()},
             **{f"zoo_attention_fix_{k}": v["launches"]
                for k, v in zoo["attention_fix"].items()}}
    return {k: v[short] for k, v in paths.items()}


# --------------------------------------------------------------------------
# phase 24: the fleet tier
# --------------------------------------------------------------------------

FLEET_ROBOTS = (8, 32)     # 24a: the serving fleets, one episode a robot
FLEET_EVAL_STEPS = 60      # 24a, 24b: the evaluation episodes' length
# 24b: device rollout against the host loop, with the actor that reaches
# goals and collides on rrc (phase 19b's second case), so both loops'
# success and collision accounting run
ROLLOUT_EPISODES = 8
FLEET_RECORD_SEED = SEED   # one record table; robot i starts at record i
# 24c: train_fleet at the flagship width from the flagship actor (the
# pre_train warm start), SAC batch FLEET_BATCH, Config()'s, at which
# phase 5 holds the bf16 training kernels against their plain versions:
# (label, robots, episodes a robot, steps an episode, updates a step)
FLEET_BATCH, FLEET_BUFFER = 32, 4096
FLEET_TRAIN = (("plain", 4, 1, 60, 1.0),
               ("guided_per", 8, 1, 40, 0.5))
FLEET_DEMO_EPISODES = 3
# 24d: the adapter's states on the card against the CPU's chain
ADAPTER_FRAME, ADAPTER_STEPS, ADAPTER_TOL = (512, 640), 5, 1e-6


def fleet_cfg(**sac):
    """Config() at the flagship widths in bf16 (phase 4's K1), episodes of
    FLEET_EVAL_STEPS; `sac` overrides."""
    from dgvit_tpu_torch.config import Config

    cfg = Config.from_dict({
        "model": {"compute_dtype": "bfloat16"},
        "env": {"max_steps": FLEET_EVAL_STEPS},
        "sac": {"batch_size": FLEET_BATCH, "buffer_size": FLEET_BUFFER,
                **sac},
        "train": {"seed": SEED, "pre_buffer": False}})
    m = cfg.model
    check((m.block, m.head, m.dim_head, m.mlp_dim, m.latent_size,
           tuple(m.image_size)) == (4, 4, 64, 2048, 64, (128, 160)),
          "phase 24's model is not the flagship")
    check(FLEET_BATCH == Config().sac.batch_size
          and FLEET_BATCH in TRAIN_BATCHES["bfloat16"],
          f"phase 24's SAC batch {FLEET_BATCH} is not Config()'s or not "
          "held against plain by phase 5")
    return cfg


_FLEET_RECORDS: list = []


def fleet_envs(n, log=None):
    """n port KinematicNavEnv robots on rrc over one record table, robot
    i starting at record i; with `log`, each robot's commands in log[i]."""
    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.envs.kinematic import default_records

    if not _FLEET_RECORDS:
        _FLEET_RECORDS.extend(default_records(seed=FLEET_RECORD_SEED))

    class Logged(KinematicNavEnv):
        def step(self, action, t):
            if log is not None:
                log[self.robot].append((float(action[0]), float(action[1])))
            return super().step(action, t)

    envs = []
    for i in range(n):
        env = Logged(_FLEET_RECORDS, world="rrc")
        env.robot, env.indice_position = i, i % len(_FLEET_RECORDS)
        if log is not None:
            log[i] = []
        envs.append(env)
    return envs


def counted(fn):
    """(fn's result, every kernel's launches in it): the counters set to 0
    just before, read just after."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    return out, {k: c.launches for k, c in counters.items()}


def phase_fleet_eval(flat):
    """Phase 24a, a main path: serve_fleet of the flagship actor (bf16 K1)
    over 8 and 32 robots on rrc, one episode each, with the default
    bucket ladder and pinned to bucket 1: every robot's commands and
    outcomes equal (bit for bit, or reported where the heads' library
    kernels round otherwise by batch), K1 launches equal to the server's
    dispatches and nothing else launched; run_eval_fleet's report over 8
    robots; actions/s, per-robot Hz and the mean batch."""
    import torch

    from dgvit_tpu_torch.serve import (BatchingActorServer, FleetRunner,
                                       make_action_fn, serve_fleet)
    from dgvit_tpu_torch.train.evaluate import run_eval_fleet

    cfg = fleet_cfg()
    act = make_action_fn(cfg, flat, dtype=torch.bfloat16, device=DEVICE)
    act(torch.zeros(1, 128, 160), torch.zeros(1, 2))   # the cast weights

    def pinned(envs):
        with BatchingActorServer(act, max_wait_ms=4.0, buckets=(1,)) as srv:
            out = FleetRunner(envs, srv, cfg).run(1)
        out["serving"] = srv.stats()
        return out

    out, launches = {}, {}
    totals = {k: 0 for k in PER_UPDATE}
    for n in FLEET_ROBOTS:
        runs = {}
        for label, run in (("ladder", lambda e: serve_fleet(cfg, e, act)),
                           ("bucket 1", pinned)):
            log = {}
            envs = fleet_envs(n, log)
            t0 = time.perf_counter()
            res, k = counted(lambda: run(envs))
            wall = time.perf_counter() - t0
            st = res["serving"]
            check(res["errors"] == {}, f"phase 24a: robots failed "
                  f"{res['errors']}")
            check(k == {**{kk: 0 for kk in k}, "K1": st["dispatches"]},
                  f"phase 24a ({n} robots, {label}): launches {k}, the "
                  f"server made {st['dispatches']} dispatches")
            steps = sum(len(v) for v in log.values())
            runs[label] = (res, log)
            totals = {kk: totals[kk] + v for kk, v in k.items()}
            print(f"phase 24a fleet eval, {n} robots ({label}): "
                  f"{res['episodes']} episodes, {res['successes']} goals, "
                  f"{res['collisions']} collisions; {st['rows']} actions in "
                  f"{wall:.3f} s = {st['rows'] / wall:.1f} actions/s, "
                  f"{steps / n / wall:.2f} Hz a robot (host clock, "
                  f"{card()}); {st['dispatches']} dispatches (K1 x"
                  f"{k['K1']}), mean batch {st['mean_batch']:.2f}",
                  flush=True)
            out[f"{n}_{label.replace(' ', '')}"] = {
                "actions_per_s": st["rows"] / wall,
                "robot_hz": steps / n / wall,
                "mean_batch": st["mean_batch"], "dispatches": st["dispatches"],
                "successes": res["successes"],
                "collisions": res["collisions"], "launches": k}
        (a, la), (b, lb) = runs["ladder"], runs["bucket 1"]
        first = {}
        for i in range(n):
            for t, (x, y) in enumerate(zip(la[i], lb[i])):
                if x != y:
                    first[i] = (t, max(abs(x[0] - y[0]), abs(x[1] - y[1])))
                    break
            else:
                if len(la[i]) != len(lb[i]):
                    first[i] = (min(len(la[i]), len(lb[i])), None)
        same_outcomes = all(a[key] == b[key] for key in
                            ("successes", "collisions", "durations",
                             "bad_inits"))
        print(f"phase 24a, {n} robots: ladder against bucket 1: commands "
              f"bit-equal for {n - len(first)} of {n} robots, outcomes "
              f"equal {same_outcomes}; first differences (robot: step, "
              f"|command diff|) {first}", flush=True)
        out[f"{n}_compare"] = {"robots_bit_equal": n - len(first),
                               "first_differences": {str(r): v for r, v in
                                                     first.items()},
                               "outcomes_equal": same_outcomes}
        # a robot whose commands part does so by the heads' rounding (one
        # bf16 step of the action, 2^-8, times the command scale), never
        # by a frame computed with another
        check(all(d is not None and d <= 2.0 ** -7 for _, d in
                  first.values()),
              f"phase 24a: commands part by more than the heads' rounding: "
              f"{first}")
        if first:   # pinned, as the JAX test pins: two bucket-1 runs agree
            log = {}
            again = pinned(fleet_envs(n, log))
            check(log == lb and all(again[key] == b[key] for key in
                                    ("successes", "collisions",
                                     "durations")),
                  f"phase 24a: two bucket-1 fleets of {n} differ")
        else:
            check(same_outcomes, "phase 24a: bit-equal commands, other "
                  "outcomes")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        rep, k = counted(lambda: run_eval_fleet(
            cfg, flat, max_episodes=FLEET_ROBOTS[0],
            n_robots=FLEET_ROBOTS[0], out_dir=out_dir, device=DEVICE))
    check(k == {**{kk: 0 for kk in k},
                "K1": rep["serving"]["dispatches"]},
          f"phase 24a run_eval_fleet launched {k}")
    totals = {kk: totals[kk] + v for kk, v in k.items()}
    print(f"phase 24a run_eval_fleet ({FLEET_ROBOTS[0]} robots): success "
          f"rate {rep['success_rate']:.3f}, {rep['collisions']} collisions, "
          f"mean batch {rep['serving']['mean_batch']:.2f}, K1 x{k['K1']}",
          flush=True)
    out["run_eval_fleet"] = {"success_rate": rep["success_rate"],
                             "launches": k}
    out["launches"] = totals
    return out


def phase_device_rollout():
    """Phase 24b, a main path: run_eval(device_rollout_loop=True) of the
    drqc actor (SECOND_ACTOR) against the host run_eval on one record
    table, over ROLLOUT_EPISODES episodes: successes, success rate and durations
    equal (collisions: the device loop's env keeps counting through the
    frozen steps, JAX's quirk, printed); K1 once a step of every episode's
    FLEET_EVAL_STEPS and nothing else; one host wait a step; env steps/s
    of both loops."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.core.checkpoint import load_params_npz
    from dgvit_tpu_torch.serve import make_action_fn
    from dgvit_tpu_torch.train.device_rollout import device_rollout
    from dgvit_tpu_torch.train.evaluate import run_eval

    cfg = fleet_cfg()
    flat = load_params_npz(str(SECOND_ACTOR))
    reports, rates = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        for label, device_loop in (("host", False), ("device", True)):
            log = {}
            env = fleet_envs(1, log)[0]
            t0 = time.perf_counter()
            rep, k = counted(lambda: run_eval(
                cfg, env, flat, ROLLOUT_EPISODES, out_dir, device=DEVICE,
                device_rollout_loop=device_loop))
            wall = time.perf_counter() - t0
            steps = len(log[0])
            reports[label], rates[label] = (rep, k), steps / wall
            print(f"phase 24b {label} loop: {rep}; {steps} env steps in "
                  f"{wall:.3f} s = {steps / wall:.1f} env steps/s (host "
                  f"clock, {card()}); launches {k}", flush=True)
            want = steps if label == "host" else \
                ROLLOUT_EPISODES * FLEET_EVAL_STEPS
            check(k == {**{kk: 0 for kk in k}, "K1": want} and (
                label == "host" or steps == want),
                f"phase 24b {label}: launches {k}, {steps} env steps")
    (host, _), (dev, k) = reports["host"], reports["device"]
    for key in ("successes", "success_rate", "durations"):
        check(host[key] == dev[key], f"phase 24b: {key} {dev[key]} on the "
              f"device loop, {host[key]} on the host")
    check(dev["collisions"] >= host["collisions"],
          "phase 24b: fewer collisions on the device loop")
    # one host wait a step
    agent = SACAgent(cfg, device=DEVICE)
    actor = make_action_fn(cfg, flat, dtype=torch.bfloat16,
                           device=DEVICE).policy
    state = type("State", (), {"actor": actor})()
    env = fleet_envs(1)[0]
    e = cfg.env
    device_rollout(agent, state, env, 4, e.linear_cmd_scale,
                   e.angular_cmd_scale)                    # warm
    _, syncs, kinds = count_syncs(lambda: device_rollout(
        agent, state, env, FLEET_EVAL_STEPS, e.linear_cmd_scale,
        e.angular_cmd_scale))
    print(f"phase 24b: {syncs} host syncs in an episode of "
          f"{FLEET_EVAL_STEPS} steps {kinds}", flush=True)
    check(syncs == FLEET_EVAL_STEPS, f"phase 24b: {syncs} syncs, expected "
          f"one a step ({FLEET_EVAL_STEPS})")
    return {"host": host, "device": dev, "env_steps_per_s": rates,
            "syncs": syncs, "launches": k}


def phase_train_fleet(out_dir):
    """Phase 24c, a main path: train_fleet at the flagship width from the
    flagship actor, plain with 4 robots and guided PER with 8 (the expert
    buffer of policy-unit demos that train/demo_record records): finite
    logged losses; the learner's launches the updates times phase 6's
    (plain) or phase 18's (guided) counts; K1 launches the warm-up's and
    the server's dispatches; the updates after the drain the cadence
    rule's; the served copy equal to the learner's actor bit for bit;
    every dispatch on one whole published version (`audit`, over the
    casts K1 reads); a publish and a dispatch after the campaign, the
    bodies that run under the lock, with no host sync; env steps/s,
    updates/s and the mean batch."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.train.demo_record import (policy_unit_pilot,
                                                   record_episodes)
    from dgvit_tpu_torch.train.train_fleet import train_fleet

    out = {}
    launches = {k: 0 for k in PER_UPDATE}
    for label, robots, episodes, max_steps, ups in FLEET_TRAIN:
        guided = label.startswith("guided")
        cfg = fleet_cfg(prioritized_replay=guided)
        cfg.env.max_steps = max_steps
        cfg.train.pre_train = True
        cfg.train.pre_train_model = str(ACTOR)[:-len("_actor.npz")]
        cfg.train.pre_buffer = guided
        cfg.train.save = False
        run_dir = Path(out_dir) / label
        glob_ = None
        if guided:
            pilot, to_env = policy_unit_pilot(cfg)
            check(record_episodes(fleet_envs(1)[0], pilot,
                                  str(run_dir / "demos"),
                                  episodes=FLEET_DEMO_EPISODES,
                                  max_steps=200, action_to_env=to_env),
                  "phase 24c recorded no demos")
            glob_ = str(run_dir / "demos" / "RRC" / "torch" / "*.npz")
        res, k = counted(lambda: train_fleet(
            cfg, fleet_envs(robots), out_dir=str(run_dir),
            max_episodes=robots * episodes, expert_glob=glob_,
            updates_per_step=ups, log_every_updates=10, device=DEVICE,
            audit=True))
        torch.cuda.synchronize()
        per = PER_GUIDED if guided else PER_UPDATE
        st = res["serving"]
        want = {**{kk: n * res["updates"] for kk, n in per.items()},
                "K1": res["warm_dispatches"] + st["dispatches"]}
        steps = res["env_steps"]
        cadence = (math.ceil(steps * ups) if steps >= FLEET_BATCH else 0)
        rows = [json.loads(line) for p in run_dir.glob("train_fleet_*.jsonl")
                for line in p.read_text().splitlines()]
        losses = [r[key] for r in rows for key in
                  ("qf1_loss", "policy_loss", "alpha", "entropy") if key in r]
        same = all(torch.equal(x, y) for x, y in zip(
            res["served"].state_dict().values(),
            res["state"].actor.state_dict().values()))
        published = set(res["audit"]["published"])
        torn = [s for s in res["audit"]["dispatched"] if s not in published]
        # what runs under dev_lock, once more after the campaign: the
        # publish and the dispatch's cast check and K1 enqueue (the
        # action's read comes after, outside the count)
        learner = res["learner"]
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        obs = torch.zeros((robots,) + tuple(cfg.model.image_size),
                          device=DEVICE)
        pobs = torch.zeros((robots, 2), device=DEVICE)

        def locked():
            learner.publish(res["state"])
            return learner.dispatch(obs, pobs, gen)

        act, lock_syncs, lock_what = count_syncs(locked)
        act_ok = (tuple(act.shape) == (robots, 2)
                  and bool(torch.isfinite(act.float()).all()))
        print(f"phase 24c train_fleet ({label}, {robots} robots): "
              f"{res['episodes']} episodes, {steps} env steps, "
              f"{res['updates']} updates (cadence {cadence}) in "
              f"{res['wall_s']:.2f} s = {res['steps_per_s']:.2f} env "
              f"steps/s, {res['updates_per_s']:.2f} updates/s (host clock, "
              f"{card()}); mean batch {st['mean_batch']:.2f} over "
              f"{st['dispatches']} dispatches; launches {k}; "
              f"{len(losses)} logged losses; served copy equal {same}; "
              f"{len(res['audit']['dispatched'])} dispatches against "
              f"{len(published)} published versions, {len(torn)} on none; "
              f"{lock_syncs} host syncs under the lock {lock_what}",
              flush=True)
        check(res["errors"] == {}, f"phase 24c robots failed {res['errors']}")
        check(res["updates"] > 0 and res["updates"] == cadence
              and res["state"].itera == res["updates"],
              f"phase 24c ({label}): {res['updates']} updates, the cadence "
              f"rule gives {cadence}")
        check(k == want, f"phase 24c ({label}): launches {k}, expected "
              f"{want}")
        check(losses and all(math.isfinite(v) for v in losses),
              f"phase 24c ({label}): non-finite or no logged losses")
        check(same, f"phase 24c ({label}): the served copy is not the "
              "learner's actor")
        check(not torn and len(res["audit"]["dispatched"])
              == st["dispatches"],
              f"phase 24c ({label}): {len(torn)} dispatches read no "
              "published version")
        check(lock_syncs == 0 and act_ok,
              f"phase 24c ({label}): {lock_syncs} host syncs under the "
              f"lock {lock_what}, action ok {act_ok}")
        launches = {kk: launches[kk] + v for kk, v in k.items()}
        out[label] = {"robots": robots, "env_steps": steps,
                      "updates": res["updates"], "wall_s": res["wall_s"],
                      "steps_per_s": res["steps_per_s"],
                      "updates_per_s": res["updates_per_s"],
                      "mean_batch": st["mean_batch"],
                      "dispatches": st["dispatches"],
                      "published": len(published),
                      "syncs_under_lock": lock_syncs, "launches": k}
    out["launches"] = launches
    return out


def phase_adapter(flat):
    """Phase 24d: one GazeboRos2Env on the card over tests/fake_ros2.py
    with 512 x 640 depth frames: a reset and ADAPTER_STEPS steps, each
    state equal to the same raw frame through the chain on the CPU with
    the same noise draws (within ADAPTER_TOL), the commands from the
    flagship actor through K1, one launch a step."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.ops.preprocess import preprocess_depth
    from dgvit_tpu_torch.serve import make_action_fn

    sys.path.insert(0, str(ROOT / "tests"))
    import fake_ros2

    world = fake_ros2.install()
    sys.modules.pop("dgvit_tpu_torch.envs.ros2_adapter", None)
    try:
        from dgvit_tpu_torch.envs.ros2_adapter import GazeboRos2Env

        cfg = fleet_cfg()
        env = GazeboRos2Env(cfg, position_records=[
            {"xR": 0.0, "yR": 0.0, "xG": 3.0, "yG": 1.0}], device=DEVICE)
        draws = []
        noise = env._noise
        env._noise = lambda shape: draws.append(noise(shape)) or draws[-1]
        rng = np.random.default_rng(SEED + 24)
        raws = []

        def frame():
            raw = rng.uniform(0.3, 8.0, ADAPTER_FRAME).astype(np.float32)
            raws.append(raw)
            world.deliver("/camera/depth/image_raw", fake_ros2.Image(
                height=ADAPTER_FRAME[0], width=ADAPTER_FRAME[1],
                encoding="32FC1", data=raw.tobytes()))
            world.deliver("/odom", fake_ros2.Odometry(x=0.1 * len(raws)))
            world.deliver("/front_laser/scan",
                          fake_ros2.LaserScan([5.0] * 36))

        act = make_action_fn(cfg, flat, dtype=torch.bfloat16, device=DEVICE)
        frame()
        (states, cmds), k = counted(lambda: drive_adapter(env, act, cfg,
                                                          frame))
        worst = 0.0
        for raw, z, s in zip(raws, draws, states):
            ref = preprocess_depth(torch.from_numpy(raw[None]),
                                   noise=z.cpu())[0].numpy()
            worst = max(worst, float(np.abs(s[..., 0] - ref).max()))
        print(f"phase 24d adapter on the card: {len(states)} states of "
              f"{ADAPTER_FRAME} frames, max |card - CPU| {worst:.3e} "
              f"(limit {ADAPTER_TOL}); commands {cmds}; launches {k}",
              flush=True)
        check(len(states) == ADAPTER_STEPS + 1 and worst <= ADAPTER_TOL,
              f"phase 24d: states {worst:.3e} off the CPU chain")
        check(k == {**{kk: 0 for kk in k}, "K1": ADAPTER_STEPS + 1}
              and all(np.isfinite(c).all() for c in cmds),
              f"phase 24d: launches {k}, commands {cmds}")
        check(len(world.twists()) == ADAPTER_STEPS,
              "phase 24d: the adapter published other commands")
        return {"max_abs_err": worst, "launches": k}
    finally:
        fake_ros2.uninstall()
        sys.modules.pop("dgvit_tpu_torch.envs.ros2_adapter", None)


def drive_adapter(env, act, cfg, frame):
    """A reset and ADAPTER_STEPS steps of `env`, each command from `act`
    on the state before it: (states, commands)."""
    e = cfg.env
    r = env.reset()
    states, cmds, s = [r.state], [], r
    for t in range(ADAPTER_STEPS):
        a = act(s.state[None, ..., 0], s.to_goal[None, :2])[0]
        a = a.clip(-e.max_action, e.max_action)
        cmd = [(a[0] + 1.0) * e.linear_cmd_scale, a[1] * e.angular_cmd_scale]
        cmds.append([float(c) for c in cmd])
        frame()
        s = env.step(cmd, t)
        states.append(s.state)
    act(s.state[None, ..., 0], s.to_goal[None, :2])
    return states, cmds


def phase_fleet(flat):
    """Phase 24 (24a-24d), the fleet tier; each sub-phase's time."""
    out, secs = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        for key, fn in (("fleet_eval", lambda: phase_fleet_eval(flat)),
                        ("device_rollout", phase_device_rollout),
                        ("train_fleet", lambda: phase_train_fleet(out_dir)),
                        ("adapter", lambda: phase_adapter(flat))):
            t0 = time.perf_counter()
            out[key] = fn()
            secs[key] = time.perf_counter() - t0
            print(f"phase 24 {key}: {secs[key]:.1f} s", flush=True)
    out["seconds"] = secs
    return out


def fleet_launches(fleet, short):
    """A kernel's launches on phase 24's paths, for the kernels line."""
    return {"fleet_eval": fleet["fleet_eval"]["launches"][short],
            "device_rollout": fleet["device_rollout"]["launches"][short],
            "train_fleet": fleet["train_fleet"]["launches"][short],
            "ros2_adapter": fleet["adapter"]["launches"][short]}


# --------------------------------------------------------------------------
# phase 25: the recorded-data trainer, critic-latent reuse, the deployable
# artifact and attention capture
# --------------------------------------------------------------------------

SLICE_SEED = SEED + 25        # phase 25's own generator
# 25a: the demos (the flagship's (128, 160) frames, an episode every
# OFFLINE_EPISODE transitions), the updates of each offline run
OFFLINE_N, OFFLINE_EPISODE, OFFLINE_STEPS = 1024, 16, 20
# 25b: the updates of each latent-reuse run, at the default batch
REUSE_STEPS = 5
# an update with sac.critic_latent_reuse: the actor step's critic trunk
# (one K4) goes, the gradient passes (K2, K3) stay
PER_REUSE = {**PER_UPDATE, "K4": PER_UPDATE["K4"] - 1}
PER_GUIDED_REUSE = {**PER_GUIDED, "K4": PER_GUIDED["K4"] - 1}
# the frozen-critic pair: one update with reuse against one without,
# lr_critic 0 and emb-dropout 0 (the same critic before and after its
# step, no dropout draw), held as phase 6b holds the kernels' update to
# the plain one: the metrics, gradient norms and update norms by
# update_mismatches, every gradient within SAC_RTOL of its tensor's
# largest, the parameters within 2.2e-3 (an Adam step of lr 1e-3 moves an
# element at most 1e-3, so this alone cannot tell a wrong step). In fp32
# K3f's latent and K4's are one cluster body summed alike (the pair reads
# 0). In bf16 they are two bodies whose latents part in their last bits,
# and a head's ReLU then flips for a few rows: there the terms that read
# the latent are held apart, the policy loss within one bf16 rounding
# (2^-9) relative, the actor's gradients each within 2^-6 of its tensor's
# largest (the bf16 per-tensor rule of a kernel against its plain version)
# and their pooled mean|err|/L within REUSE_BF16_MEAN (the H100 read
# 1.55e-5 and 1.75e-5 for the pair and 2.2e-4 to 3.9e-4 for a wrong
# latent). The same update with the reused latent's rows rolled by one
# (each row's Q from another frame) must fail the rule.
REUSE_BF16_LOSS, REUSE_BF16_MEAN = 2.0 ** -9, 2.0 ** -14
# 25c: the artifact's batches, and its limit against the card's composed
# plain route (fp32 both, the same products; the library may sum the
# program's in another order)
EXPORT_BATCHES, EXPORT_TOL = (1, 3, 32), 1e-5
# 25d: the kinematic steps the visualizer watches, and the maps' limit:
# rows sum to 1 within CAPTURE_TOL; the maps against the CPU's capture of
# the same frames evaluated in float64 (the norms in fp32, as the route
# takes them) within max(CAPTURE_TOL, EXACT_K["fp32"] x the CPU's fp32
# capture's distance from it), a capture with its scores scaled by
# CAPTURE_WRONG_SCALE failing. The CPU's fp32 capture of the trained
# actor read 3.0e-5 from the float64 one (this phase, an H100 host; its
# first block's maps are one-hot, the logits large), so two fp32
# evaluations may part by more than CAPTURE_TOL; their distance is
# printed beside, read only.
CAPTURE_STEPS, CAPTURE_TOL, CAPTURE_WRONG_SCALE = 5, 1e-5, 1.01


def slice_cfg(dtype="float32", **sac):
    """Config() (the fp32 flagship at B=32), in `dtype`, with `sac`
    overrides: phase 25's configuration."""
    from dgvit_tpu_torch.config import Config

    cfg = Config()
    cfg.model.compute_dtype = dtype
    for k, v in sac.items():
        setattr(cfg.sac, k, v)
    return cfg


CLUSTER_KERNELS = ("K4", "K2f", "K2b", "K3f", "K3b")   # fp32 cluster forms


def counted_forms(fn):
    """(fn's result, every kernel's launches in it, the fp32 cluster-form
    launches of K4, K2 and K3 in it): the counters set to 0 just before,
    read just after."""
    counters = kernel_counters()
    for k in CLUSTER_KERNELS:
        counters[k].cluster_launches = 0
    out, launches = counted(fn)
    return out, launches, {k: counters[k].cluster_launches
                           for k in CLUSTER_KERNELS}


def offline_demos(out_dir, rng):
    """OFFLINE_N transitions in the demo npz layout (2-D frames of the
    config's size), drawn with numpy; the file's glob."""
    import numpy as np

    n = OFFLINE_N
    f32 = lambda a: a.astype(np.float32)
    hw = tuple(slice_cfg().model.image_size)
    frames = lambda: f32(rng.uniform(0, 1, (n, *hw)))
    np.savez(Path(out_dir) / "demo_0.npz", obs=frames(),
             act=f32(rng.uniform(-1, 1, (n, 2))),
             goal=f32(rng.uniform(0, 1, (n, 4))),
             reward=f32(rng.normal(0, 1, n)), next_obs=frames(),
             next_goal=f32(rng.uniform(0, 1, (n, 4))),
             done=np.arange(n) % OFFLINE_EPISODE == OFFLINE_EPISODE - 1)
    return str(Path(out_dir) / "demo_*.npz")


class FirstState:
    """The offline trainer's checkpointer contract, keeping the parameters
    it resumes from."""

    def resume(self, state):
        self.before = update_start(state)
        return state, 0

    def maybe_save(self, step, state):
        pass


def offline_first_update(pattern, out_dir, plain):
    """The first update of `train_offline` at Config() (buffer sized to the
    demos), through the kernels or their plain versions on the card, in
    `golden_update`'s form."""
    import contextlib

    from dgvit_tpu_torch.train import train_offline as off

    cfg = slice_cfg(buffer_size=OFFLINE_N)
    buf = off.fill_buffer_from_demos(pattern, cfg)
    rec = FirstState()
    with plain_kernels() if plain else contextlib.nullcontext():
        state, stats = off.train_offline(cfg, buf, 1, out_dir=out_dir,
                                         checkpointer=rec, device=DEVICE)
    return update_record(state, stats["final"], rec.before)


def phase_offline(out_dir, rng):
    """Phase 25a, a main path: demos -> fill_buffer_from_demos ->
    train_offline at Config() (the flagship GoT in fp32, B=32) for
    OFFLINE_STEPS updates three ways (plain, PER, augment_sigma 2), every
    update's launches phase 6's; the first plain update held to the same
    update through the plain versions on the card by phase 6b's rule;
    then `train_rl --env replay` for one episode of the demos (K1 once a
    step). Returns updates/s and launches by run."""
    import torch
    import yaml

    from dgvit_tpu_torch.train import train_offline as off
    from dgvit_tpu_torch.train import train_rl

    pattern = offline_demos(out_dir, rng)
    out = {"launches": {}, "cluster_launches": {}, "updates_per_s": {}}
    for label, per, sigma in (("offline_plain", False, 0.0),
                              ("offline_per", True, 0.0),
                              ("offline_augment", False, 2.0)):
        cfg = slice_cfg(prioritized_replay=per)
        buf = off.fill_buffer_from_demos(pattern, cfg)
        calls = {"per": 0}
        if per:
            learn_per = off.SACAgent.learn_per
            off.SACAgent.learn_per = lambda self, *a, **k: (
                calls.__setitem__("per", calls["per"] + 1),
                learn_per(self, *a, **k))[1]
        try:
            (state, stats), launches, cluster = counted_forms(
                lambda: off.train_offline(
                    cfg, buf, OFFLINE_STEPS, out_dir=out_dir,
                    augment_sigma=sigma, log_every=OFFLINE_STEPS,
                    device=DEVICE))
        finally:
            if per:
                off.SACAgent.learn_per = learn_per
        torch.cuda.synchronize()
        want = {k: n * OFFLINE_STEPS for k, n in PER_UPDATE.items()}
        print(f"offline {label} ({cfg.model.compute_dtype}, B="
              f"{cfg.sac.batch_size}, {OFFLINE_STEPS} updates): "
              f"{stats['steps_per_sec']:.3f} updates/s (host clock, the "
              f"prefetcher staging beside); launches an update "
              f"{ {k: v / OFFLINE_STEPS for k, v in launches.items()} }; "
              f"final {stats['final']} ({card()})", flush=True)
        check(launches == want, f"offline {label} launches {launches}, "
              f"expected {want}")
        check(all(math.isfinite(v) for v in stats["final"].values()),
              f"offline {label}: non-finite metrics")
        check(calls["per"] == (OFFLINE_STEPS if per else 0),
              f"offline {label}: {calls['per']} PER updates")
        check(cluster == {k: launches[k] for k in CLUSTER_KERNELS},
              f"offline {label}: fp32 launches off the cluster forms, "
              f"{cluster} of {launches}")
        out["launches"][label] = launches
        out["cluster_launches"][label] = cluster
        out["updates_per_s"][label] = stats["steps_per_sec"]
        del buf

    kern = offline_first_update(pattern, out_dir, plain=False)
    plain = offline_first_update(pattern, out_dir, plain=True)
    bad, worst = update_mismatches(kern, plain)
    gerr = max(((a - plain["grads"][n]).abs().max()
                / plain["grads"][n].abs().max().clamp(min=1e-30)).item()
               for n, a in kern["grads"].items())
    pmax = max((a - plain["params"][n]).abs().max().item()
               for n, a in kern["params"].items())
    print(f"offline first update through the kernels against the plain "
          f"versions on the card: largest relative differences {worst}; "
          f"grads max|err|/L {gerr:.3e} (limit {SAC_RTOL:g}); parameters "
          f"max|diff| {pmax:.3e} (limit 2.2e-3)", flush=True)
    check(not bad, f"the offline update disagrees with the plain: {bad}")
    check(gerr <= SAC_RTOL, "the offline update's grads disagree")
    check(pmax <= 2.2e-3, "the offline update's parameters disagree")
    out["first_update_vs_plain"] = dict(worst, grads=gerr, params=pmax)

    run_dir = Path(out_dir) / "env_replay"
    cfg_path = Path(out_dir) / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(slice_cfg().to_dict()))
    _, launches = counted(lambda: train_rl.main([
        "--env", "replay", "--expert-glob", pattern, "--episodes", "1",
        "--config", str(cfg_path), "--out", str(run_dir),
        "--device", DEVICE]))
    logs = [json.loads(x) for p in run_dir.glob("*.jsonl")
            for x in p.read_text().splitlines() if x.strip()]
    print(f"train_rl --env replay, one episode of {OFFLINE_EPISODE} logged "
          f"steps: launches {launches}; logged {logs[-1] if logs else None}",
          flush=True)
    check(launches == {**NO_KERNELS, "K1": OFFLINE_EPISODE},
          f"--env replay launches {launches}: K1 once a logged step")
    check(bool(logs), "--env replay logged nothing")
    out["launches"]["train_env_replay"] = launches
    return out


def slice_params():
    """(actor, critic) flat parameters of phase 25b's agents: the golden
    SAC state's."""
    return golden_params()


def reuse_update(agent, state, flavour, batch, expert):
    """One update of `flavour` (plain, per: importance weights 0.5-1.5,
    guided: half the expert rows valid): (state, metrics)."""
    import torch

    rows = batch["obs"].shape[0]
    if flavour == "per":
        w = torch.linspace(0.5, 1.5, rows, device=batch["obs"].device)
        state, m, td = agent.learn_per(state, batch, w)
        return state, dict(m, td=td.mean())
    if flavour == "guided":
        return agent.learn_guidence(state, batch, expert, rows // 2)
    return agent.learn(state, batch)


def frozen_critic_update(dtype, flavour, reuse, params, batch, expert,
                         roll=False):
    """One update of `flavour` from the (actor, critic) flat `params` at
    lr_critic 0 and emb-dropout 0, latent reuse on or off (`roll`: the
    reused latent's rows rolled by one, a wrong latent), in
    `update_record`'s form."""
    from dgvit_tpu_torch.agents import SACAgent

    cfg = slice_cfg(dtype, critic_latent_reuse=reuse,
                    prioritized_replay=flavour == "per", lr_critic=0.0)
    cfg.model.emb_dropout = 0.0
    agent = SACAgent(cfg, device=DEVICE, seed=SLICE_SEED)
    if roll:
        critic_q = agent._critic_q

        def rolled(state, b):
            q1, q2, latent = critic_q(state, b)
            return q1, q2, latent.roll(1, 0)

        agent._critic_q = rolled
    state = sac_state(agent, *params)
    before = update_start(state)
    state, m = reuse_update(agent, state, flavour, batch, expert)
    return update_record(state, m, before)


def reuse_mismatches(on, off, dtype):
    """The frozen-critic pair's faults under 25b's rule (REUSE_BF16_*),
    and its readings: the largest relative difference of each kind, the
    gradients' max|err|/L (actor, critic), the actor's pooled mean|err|/L
    (TrainErrors'), the policy loss's relative difference, the parameters'
    max|diff| and the share of the actor's elements equal bit for bit."""
    actor = lambda name: name.startswith("actor.")
    bf16 = dtype == "bfloat16"
    held = on, off
    if bf16:
        held = [{**r, "metrics": {k: v for k, v in r["metrics"].items()
                                  if k != "policy_loss"},
                 "grad": {k: v for k, v in r["grad"].items()
                          if not actor(k)}} for r in held]
    bad, worst = update_mismatches(*held)
    gerr = {n: ((on["grads"][n] - g).float().abs().max()
                / g.float().abs().max().clamp(min=1e-30)).item()
            for n, g in off["grads"].items()}
    pl = on["metrics"]["policy_loss"], off["metrics"]["policy_loss"]
    pooled = TrainErrors()
    pooled.add([(on["grads"][n], g) for n, g in off["grads"].items()
                if actor(n)])
    read = dict(worst, actor_grads=max(v for n, v in gerr.items()
                                       if actor(n)),
                actor_grads_mean=pooled.mean,
                critic_grads=max(v for n, v in gerr.items() if not actor(n)),
                policy_loss=abs(pl[0] - pl[1]) / max(abs(pl[1]), 1e-30),
                params=max((a - off["params"][n]).abs().max().item()
                           for n, a in on["params"].items()))
    same = [(a == off["params"][n]) for n, a in on["params"].items()
            if actor(n)]
    read["actor_equal_share"] = (sum(x.sum().item() for x in same)
                                 / sum(x.numel() for x in same))
    limits = [("actor_grads", TRAIN_BF16_MAX if bf16 else SAC_RTOL),
              ("critic_grads", SAC_RTOL), ("params", 2.2e-3)]
    if bf16:
        limits += [("actor_grads_mean", REUSE_BF16_MEAN),
                   ("policy_loss", REUSE_BF16_LOSS)]
    bad += [f"{what} {read[what]:.3e} over {lim:g}" for what, lim in limits
            if not read[what] <= lim]
    return bad, read


def phase_latent_reuse(rng):
    """Phase 25b, a main path: sac.critic_latent_reuse in bf16 (the
    default config with bf16 compute) and fp32 (Config()), plain, PER and
    guided, REUSE_STEPS updates each beside the same updates without
    reuse: each reuse update launches one K4 fewer and the K2 and K3
    calls of the update without it; finite losses; with lr_critic 0 and
    emb-dropout 0 one update with reuse held to one without by phase 6b's
    rule (REUSE_BF16_* for the bf16 terms that read the latent), the same
    update on a wrong latent failing it. Returns launches by run, the
    update times and the pair's readings."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent

    params = slice_params()
    cfg = slice_cfg()
    hw, rows = tuple(cfg.model.image_size), cfg.sac.batch_size
    batch, expert = (zoo_batch(rng, hw, rows) for _ in range(2))
    batch["engage"] = (torch.arange(rows, device=DEVICE) % 8 == 1).float()
    out = {"launches": {}, "cluster_launches": {}, "host_ms": {},
           "frozen_critic_pair": {}}
    for dtype in ("bfloat16", "float32"):
        for flavour in ("plain", "per", "guided"):
            runs = {}
            for reuse in (False, True):
                agent = SACAgent(slice_cfg(
                    dtype, critic_latent_reuse=reuse,
                    prioritized_replay=flavour == "per"),
                    device=DEVICE, seed=SLICE_SEED)
                state = sac_state(agent, *params)
                times = []

                def steps():
                    nonlocal state
                    for _ in range(REUSE_STEPS):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        state, m = reuse_update(agent, state, flavour,
                                                batch, expert)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                        check(all(math.isfinite(float(v))
                                  for v in m.values()),
                              f"reuse {reuse} {dtype} {flavour}: "
                              "non-finite metrics")

                _, launches, cluster = counted_forms(steps)
                runs[reuse] = (launches, statistics.median(times[1:]))
            base = PER_GUIDED if flavour == "guided" else PER_UPDATE
            want = PER_GUIDED_REUSE if flavour == "guided" else PER_REUSE
            label = f"latent_reuse_{flavour}_{dtype}"
            (off_l, off_s), (on_l, on_s) = runs[False], runs[True]
            print(f"latent reuse {dtype} {flavour} (B={rows}, "
                  f"{REUSE_STEPS} updates): launches {on_l} against "
                  f"{off_l} without; host clock {on_s * 1e3:.2f} ms an "
                  f"update against {off_s * 1e3:.2f} ms (medians of steps "
                  f"1-{REUSE_STEPS - 1}; {card()})", flush=True)
            check(off_l == {k: n * REUSE_STEPS for k, n in base.items()},
                  f"{label}: reuse off launches {off_l}")
            check(on_l == {k: n * REUSE_STEPS for k, n in want.items()},
                  f"{label}: reuse on launches {on_l}, expected one K4 "
                  "fewer an update")
            out["launches"][label] = on_l
            if dtype == "float32":
                check(cluster == {k: on_l[k] for k in CLUSTER_KERNELS},
                      f"{label}: fp32 launches off the cluster forms")
                out["cluster_launches"][label] = cluster
            out["host_ms"][label] = {"reuse": on_s * 1e3,
                                     "no_reuse": off_s * 1e3}
            # the frozen critic: one update each way, and on a wrong latent
            pair = [frozen_critic_update(dtype, flavour, reuse, params,
                                         batch, expert)
                    for reuse in (True, False)]
            bad, read = reuse_mismatches(*pair, dtype)
            wrong, wread = reuse_mismatches(frozen_critic_update(
                dtype, flavour, True, params, batch, expert, roll=True),
                pair[1], dtype)
            print(f"latent reuse {dtype} {flavour}, lr_critic 0 and "
                  f"emb-dropout 0, one update against reuse off: {read}; "
                  f"the latent's rows rolled: {wread} ({card()})",
                  flush=True)
            check(not bad, f"{label}: the frozen-critic update with reuse "
                  f"disagrees with the one without: {bad}")
            check(bool(wrong), f"{label}: the rule passed a wrong latent")
            out["frozen_critic_pair"][label] = dict(read, wrong=wread)
    return out


def phase_export(flat):
    """Phase 25c: export_actor of the flagship actor on the card with a
    symbolic batch; the loaded artifact at EXPORT_BATCHES against the
    card's composed plain route (EXPORT_TOL) and against make_action_fn
    in fp32 (K1) under phase 2's fp32 rule, launching no kernel; env units
    and a pinned batch (another size refused). Returns the readings."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.serve import make_action_fn
    from dgvit_tpu_torch.serve.export import (action_map, export_actor,
                                              load_actor)

    cfg = slice_cfg()
    hw = tuple(cfg.model.image_size)
    rng = np.random.default_rng(SLICE_SEED + 1)
    t0 = time.perf_counter()
    data = export_actor(cfg, flat, platforms=[DEVICE])
    secs = time.perf_counter() - t0
    act = load_actor(data)
    check(act.device.type == torch.device(DEVICE).type,
          "the artifact is bound to the card")
    plain = action_map(cfg, flat, device=DEVICE)
    live = make_action_fn(cfg, flat, dtype=torch.float32, device=DEVICE)
    reads = {}
    for b in EXPORT_BATCHES:
        obs = rng.uniform(0, 1, (b, *hw)).astype(np.float32)
        goal = rng.uniform(-1, 1, (b, 2)).astype(np.float32)
        o, g = (torch.from_numpy(x).to(DEVICE) for x in (obs, goal))
        got, launches = counted(lambda: act(o, g))
        with torch.no_grad():
            ref = plain(o, g)
        k1 = torch.from_numpy(live(obs, goal)).to(DEVICE)
        err = (got - ref).abs().max().item()
        ratio = f32_ratio(got, k1)
        reads[b] = {"vs_plain": err, "vs_k1_ratio": ratio}
        print(f"artifact b={b}: max|err| {err:.3e} against the composed "
              f"plain route (limit {EXPORT_TOL:g}); against K1 fp32 "
              f"max|err| over {F32_TOL:g} (1 + |ref|) {ratio:.3e} (passing "
              f"at 1); launches {launches}", flush=True)
        check(got.shape == (b, 2) and bool(torch.isfinite(got).all()),
              f"artifact b={b}: shape or non-finite")
        check(err <= EXPORT_TOL, f"artifact b={b} disagrees with the plain "
              "route")
        check(ratio <= 1, f"artifact b={b} disagrees with K1")
        check(launches == NO_KERNELS, f"the artifact launched {launches}")
    pinned = load_actor(export_actor(cfg, flat, env_units=True,
                                     platforms=[DEVICE], batch=3))
    obs = torch.from_numpy(rng.uniform(0, 1, (3, *hw)).astype(
        np.float32)).to(DEVICE)
    goal = torch.from_numpy(rng.uniform(-1, 1, (3, 2)).astype(
        np.float32)).to(DEVICE)
    e = cfg.env
    with torch.no_grad():
        a = torch.clamp(plain(obs, goal), -e.max_action, e.max_action)
    want = torch.stack([(a[:, 0] + 1) * e.linear_cmd_scale,
                        a[:, 1] * e.angular_cmd_scale], dim=-1)
    units = (pinned(obs, goal) - want).abs().max().item()
    try:
        pinned(obs[:2], goal[:2])
        refused = False
    except Exception:
        refused = True
    print(f"artifact with env units, batch pinned to 3: max|err| {units:.3e}"
          f" against the clipped, scaled map; another batch refused: "
          f"{refused}; export took {secs:.1f} s, {len(data)} bytes",
          flush=True)
    check(units <= EXPORT_TOL, "the env-units artifact disagrees")
    check(refused, "the pinned artifact took another batch")
    return {"by_batch": reads, "env_units": units, "export_s": secs,
            "bytes": len(data)}


def phase_capture(flat):
    """Phase 25d: AttentionVisualizer over GoTPolicy(capture=True) (the
    flagship actor, fp32) on the card for CAPTURE_STEPS kinematic steps
    (`examples/attention_maps.collect_episode`): every map's rows sum to
    1; the maps against the CPU's capture of the same frames in float64
    under the rule at CAPTURE_TOL (the CPU's fp32 capture beside, a
    mis-scaled capture failing); the actions equal K1's fp32 route under
    phase 2's rule; the active visualizer launches no kernel, the
    inactive one K1."""
    import numpy as np
    import torch

    from dgvit_tpu_torch.examples.attention_maps import (capture_policy,
                                                         collect_episode)
    from dgvit_tpu_torch.models import layers
    from dgvit_tpu_torch.serve import make_action_fn

    cfg = slice_cfg()
    viz = capture_policy(cfg, flat, DEVICE)
    env = fleet_envs(1)[0]
    records, launches = counted(lambda: collect_episode(
        viz, env, cfg, CAPTURE_STEPS))
    check(launches == NO_KERNELS, f"capture launched {launches}")
    cpu = capture_policy(cfg, flat, "cpu")
    f64 = capture_policy(cfg, flat, "cpu")
    f64.model.double()
    probs = layers.attention_probs

    def maps(v, rec, dt=torch.float32):
        v.clear()
        v(torch.from_numpy(rec["frame"][None]).to(dt),
          torch.from_numpy(rec["goal"][None]).to(dt))
        return {k: m[0].astype(np.float64) for k, m in v.cache.items()}

    reads = {"card": 0.0, "CPU fp32": 0.0, "mis-scaled scores": 0.0}
    worst_sum = vs_cpu = 0.0
    for rec in records:
        ref, mine = maps(f64, rec, torch.float64), maps(cpu, rec)
        layers.attention_probs = lambda q, k, scale: probs(
            q, k, scale * CAPTURE_WRONG_SCALE)
        try:
            wrong = maps(cpu, rec)
        finally:
            layers.attention_probs = probs
        check(sorted(rec["maps"]) == sorted(ref) and
              len(rec["maps"]) == cfg.model.block, "capture keys")
        for k, m in rec["maps"].items():
            worst_sum = max(worst_sum, float(np.abs(m.sum(-1) - 1).max()))
            vs_cpu = max(vs_cpu, float(np.abs(m - mine[k]).max()))
            for name, o in (("card", m), ("CPU fp32", mine[k]),
                            ("mis-scaled scores", wrong[k])):
                reads[name] = max(reads[name],
                                  float(np.abs(o - ref[k]).max()))
    limit = max(CAPTURE_TOL, EXACT_K["fp32"] * reads["CPU fp32"])
    live = make_action_fn(cfg, flat, dtype=torch.float32, device=DEVICE)
    frames = np.stack([r["frame"] for r in records]).astype(np.float32)
    goals = np.stack([r["goal"] for r in records])
    k1, k1_launches = counted(lambda: live(frames, goals))
    ratio = f32_ratio(torch.from_numpy(np.stack(
        [r["action"] for r in records])), torch.from_numpy(k1))
    viz.deactivate()
    _, inactive = counted(lambda: viz(
        torch.from_numpy(frames).to(DEVICE),
        torch.from_numpy(goals).to(DEVICE), inference=True))
    shape = next(iter(records[0]["maps"].values())).shape
    print(f"capture over {len(records)} kinematic steps ({cfg.model.block} "
          f"blocks, {shape} maps): rows sum to 1 within {worst_sum:.3e}; "
          f"maps against the CPU's float64 capture, max|err| (limit max("
          f"{CAPTURE_TOL:g}, {EXACT_K['fp32']:g} x the CPU fp32 one's) = "
          f"{limit:.3e}): " + ", ".join(f"{n} {v:.3e}" for n, v in
                                        reads.items())
          + f" (the mis-scaled must fail); the card against the CPU's fp32 "
          f"capture {vs_cpu:.3e} (read only); actions against K1 fp32 "
          f"max|err| over {F32_TOL:g} (1 + |ref|) {ratio:.3e}; inactive "
          f"launches {inactive}", flush=True)
    check(len(records) == CAPTURE_STEPS, "the episode ended early")
    check(worst_sum <= CAPTURE_TOL, "capture rows do not sum to 1")
    check(reads["card"] <= limit, "capture maps disagree with the float64 "
          "capture")
    check(reads["mis-scaled scores"] > limit, "the capture check passes "
          "mis-scaled scores")
    check(ratio <= 1, "capture actions disagree with K1")
    check(k1_launches["K1"] == 1 and inactive["K1"] == 1,
          "the inactive visualizer's forward is not K1's")
    return {"rows": worst_sum, "maps": reads, "limit": limit,
            "vs_cpu_fp32": vs_cpu, "actions": ratio,
            "inactive_launches": inactive}


def phase_slice(flat):
    """Phase 25 (25a-25d), on its own generator; each sub-phase's time."""
    import numpy as np

    rng = np.random.default_rng(SLICE_SEED)
    out, secs = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        for key, fn in (("offline", lambda: phase_offline(out_dir, rng)),
                        ("latent_reuse", lambda: phase_latent_reuse(rng)),
                        ("export", lambda: phase_export(flat)),
                        ("capture", lambda: phase_capture(flat))):
            t0 = time.perf_counter()
            out[key] = fn()
            secs[key] = time.perf_counter() - t0
            print(f"phase 25 {key}: {secs[key]:.1f} s", flush=True)
    out["seconds"] = secs
    return out


def slice_launches(sl, short, dtype):
    """A kernel's launches on phase 25's paths in `dtype`, for the kernels
    line: bf16 the latent-reuse runs; fp32 (25a runs Config(), fp32) the
    cluster forms' launches of the offline and latent-reuse runs."""
    if dtype == "float32":
        paths = {**sl["offline"]["cluster_launches"],
                 **sl["latent_reuse"]["cluster_launches"]}
    else:
        paths = {k: v for k, v in sl["latent_reuse"]["launches"].items()
                 if k.endswith(dtype)}
    return {k: v[short] for k, v in paths.items()}


# ---------------------------------------------------------------------------
# Phase 26: the data-parallel tier (core/distributed, core/mesh,
# parallel/shard, core/elastic) on two ranks of the card
# ---------------------------------------------------------------------------
MESH_SEED = SEED + 26         # phase 26's own draws
MESH_FLAVORS = ("plain", "per", "guided", "guided_per")
# the three wrong data axes 26a must fail, each on the flavour it breaks
MESH_WRONGS = (("summed", "plain"), ("rows_from_zero", "plain"),
               ("expert_contiguous", "guided"))
# 26a: `steps` updates of each flavour at the global `batch` (bf16 at the
# flagship's SAC batch, fp32 at the recipe's), the wrong versions
# `wrong_steps`; 26b: the elastic drill's updates (fp32), the fault after
# update `fault_after`, a checkpoint every `interval`. `model` overrides
# the flagship's widths and `params` "init" takes the agent's own seeded
# parameters (a rehearsal on the CPU); "golden" the golden SAC state's.
MESH_SPEC = {"device": "cuda", "dtypes": ("bfloat16", "float32"),
             "batch": {"bfloat16": SAC_BATCH, "float32": 32},
             "steps": 5, "wrong_steps": 2, "model": {}, "params": "golden",
             "versions": {"float32": ("plain",)}, "world": 2,
             "elastic": {"updates": 12, "fault_after": 7, "interval": 3,
                         "batch": 32},
             "round": {"lanes": 16, "chunk": 16, "ring": 1024, "batch": 32,
                       "rounds": 3, "updates": 8, "expert": 192,
                       "world": "randm32"},
             "fleet": {"robots": 2, "episodes": 1, "max_steps": 40,
                       "batch": 32, "demo_episodes": 2}}
# 26a at world 4 (lead x): the fp32 flavours at B=32 (8 rows a rank), each
# update beside two more four-rank versions from the same state: the
# plain versions in fp32 (a correct order of sums that is not the
# kernels') and the float64-sum version (every product summed in float64
# on the plain versions, the all_reduce in float64).
MESH_W4_SPEC = dict(MESH_SPEC, dtypes=("float32",), steps=3, wrong_steps=2,
                    world=4, versions={"float32": ("plain", "float64")},
                    elastic=None, round=None, fleet=None)
# 26a's rule. Each data-parallel update is held to the single-rank update
# of the global batch from the same state (the ranks' state before it),
# one update at a time, so that no reading is of two trajectories that
# parted updates before. Phase 6b's fixed limits fail correct updates
# here: a rank's kernels sum the weight products over its rows and the
# all_reduce adds the halves, and some gradients are sums whose terms
# cancel. On the golden state (one plain fp32 update at B=32) the plain
# versions read 1.6e-3 of L on actor.fc_embed.bias from their float64-sum
# version and the kernels 7.9e-4 (chip_mesh_probe.py on an H100 80GB HBM3
# at 700 W), past 6b's 1e-4 for every correct order of the sums. So the
# readings are restated against float64 sums, as EXACT_K restates a
# kernel's check: the data-parallel update held to the float64-sum
# version of the single-rank update (the plain versions, every product
# summed in float64, the rounding points where they are), each reading
# under max(6b's limit, k x the single-rank update's own reading against
# the same version), k = MESH_K. The readings: the metrics, gradient
# norms, update norms and PER's |TD errors| as update_mismatches reads
# them (the largest |err| over its tolerance); the gradients' mean|err|/L
# pooled over the tensors (F32_POOLED, TRAIN_BF16_MEAN) and in bf16 their
# largest max|err|/L over the tensors (TRAIN_BF16_MAX). In fp32 that
# largest one is printed, not held: as in gap r, the ill-conditioned
# tensors decide it (the single-rank update's own reading moves by an
# order of magnitude from one update's state to the next).
MESH_K = 2.0
# Which readings set 26a's (and 26c's) limits: "single", max(6b's limit,
# MESH_K x the single-rank update's own reading), or "restated", max(6b's
# limit, MESH_K x the larger of the single-rank update's reading and the
# w-rank plain versions' from the same state, where they ran). The
# single-rank rule fails correct orders of sums past one rank: at world 4
# (fp32, 8 rows a rank) the plain versions read up to 7.7x its limit on
# the gradient norms and the float64-sum four-rank version at most
# 0.006 (lead x, on an H100 80GB HBM3 at 700 W): the spread is the
# partial sums' order, not the data axis. Wrong data axes still fail the
# restated rule by 8x and more at worlds 2 and 4.
MESH_RULE = "restated"


def mesh_cfg(spec, dtype, batch=None, dropout=0.0):
    """Phase 26's config: the flagship (or spec's widths) in `dtype` at
    the global batch, emb-dropout `dropout`."""
    from dgvit_tpu_torch.config import Config

    return Config.from_dict({
        "model": {"compute_dtype": dtype, "emb_dropout": dropout,
                  **spec["model"]},
        "sac": {"batch_size": batch or spec["batch"][dtype]}})


def mesh_inputs(spec, dtype, batch=None, seed=MESH_SEED):
    """The global inputs of 26a in `dtype` (every rank draws them alike):
    the agent batch (engaged rows in rank 0's half only), an expert batch
    of which the first 5/8 are valid, importance weights, and each
    update's global noise (B rows; 2B for the guided flavours)."""
    import numpy as np

    b = batch or spec["batch"][dtype]
    hw = tuple(mesh_cfg(spec, dtype, b).model.image_size)
    rng = np.random.default_rng(seed + (dtype == "float32"))
    f = lambda *s: rng.uniform(0, 1, s).astype(np.float32)

    def rows():
        return {"obs": f(b, *hw), "pobs": f(b, 2),
                "act": rng.uniform(-1, 1, (b, 2)).astype(np.float32),
                "rew": rng.normal(0, 1, (b, 1)).astype(np.float32),
                "next_obs": f(b, *hw), "next_pobs": f(b, 2),
                "done": np.zeros((b, 1), np.float32)}

    batch, expert = rows(), rows()
    batch["engage"] = ((np.arange(b) % 16 == 3) & (np.arange(b) < b // 2)
                       ).astype(np.float32)
    expert["done"][::7] = 1.0
    steps = max(spec["steps"], spec["wrong_steps"]) + 1
    normal = lambda n: rng.normal(0, 1, (n, 2)).astype(np.float32)
    return {"batch": batch, "expert": expert, "n_expert": 5 * b // 8,
            "weights": (0.5 + rng.uniform(0, 1, b)).astype(np.float32),
            "noise": [(normal(b), normal(b)) for _ in range(steps)],
            "guided_noise": [(normal(2 * b), normal(2 * b))
                             for _ in range(steps)]}


def mesh_state(spec, agent):
    if spec["params"] == "golden":
        return sac_state(agent, *golden_params())
    return agent.init_state()


def mesh_wrong(agent, wrong, rank, world):
    """A wrong data axis on `agent`: the gradients summed over the group
    instead of averaged; every rank taking noise rows 0..b-1; the guided
    step's merged rows taken as one contiguous global slice."""
    import torch

    if wrong == "summed":
        def sync(opt):
            params = [p for g in opt.param_groups for p in g["params"]
                      if p.grad is not None]
            flat = agent._all_sum(torch.cat([p.grad.reshape(-1)
                                             for p in params]))
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad = g.view_as(p)
        agent._sync_grads = sync
    elif wrong == "rows_from_zero":
        agent._rows = lambda b, be=0: (
            torch.arange(b + be, device=agent.device), world * (b + be))
    else:
        agent._rows = lambda b, be=0: (
            torch.arange(b + be, device=agent.device) + rank * (b + be),
            world * (b + be))


def mesh_step(spec, dtype, flavour, agent, step):
    """(one update of `flavour` on the global inputs: u -> the step's
    result, the input's device)."""
    import torch

    dev = agent.device
    inp = mesh_inputs(spec, dtype)
    t = lambda d: {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
    batch, w = t(inp["batch"]), torch.from_numpy(inp["weights"]).to(dev)
    args = {"plain": (), "per": (w,),
            "guided": (t(inp["expert"]), inp["n_expert"]),
            "guided_per": (t(inp["expert"]), inp["n_expert"], w)}[flavour]
    noises = inp["guided_noise" if flavour.startswith("guided")
                 else "noise"]
    return lambda state, u: step(state, batch, *args, noise=noises[u])


def mesh_host(tree):
    """A copy of a state payload on the host."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: mesh_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(mesh_host(v) for v in tree)
    return tree


def mesh_updates(state, run, steps, sync, keep, start=None, load=None):
    """`steps` updates through run(state, u): each in update_record's form
    on the host (with `keep`, its gradients and the train state before it,
    else a digest of the gradients), the launches of each and of them all
    (the counters set to 0 just before, read just after), the fp32
    cluster forms' launches, and the median host ms of updates 1 on, each
    timed from start() (default sync()) to sync() after it. load(state,
    u), when given, sets the state before update u."""
    import torch

    from dgvit_tpu_torch.core.checkpoint import state_payload

    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    for k in CLUSTER_KERNELS:
        counters[k].cluster_launches = 0
    records, per_update, times = [], [], []
    for u in range(steps):
        if load is not None:
            load(state, u)
        before_state = mesh_host(state_payload(state)) if keep else None
        was = {k: c.launches for k, c in counters.items()}
        before = update_start(state)
        (start or sync)()
        t0 = time.perf_counter()
        res = run(state, u)
        sync()
        times.append(time.perf_counter() - t0)
        per_update.append({k: c.launches - was[k]
                           for k, c in counters.items()})
        rec = update_record(res[0], res[1], before)
        rec.pop("params")
        grads = {n: g.float().cpu() for n, g in rec.pop("grads").items()}
        rec["digest"] = [g.double().sum().item() for g in grads.values()]
        if keep:
            rec["grads"], rec["before"] = grads, before_state
        if len(res) == 3:
            rec["td"] = res[2].float().cpu()
        records.append(rec)
    return {"records": records, "per_update": per_update,
            "launches": {k: c.launches for k, c in counters.items()},
            "cluster": {k: counters[k].cluster_launches
                        for k in CLUSTER_KERNELS},
            "host_ms": statistics.median(times[1:] or times) * 1e3}


def mesh_reference(spec, dtype, flavour, run, device, exact=False):
    """The single-rank update of the global batch on `device` from the
    state before each update of the data-parallel `run` (exact: its
    float64-sum version), in mesh_updates' form."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.core.checkpoint import load_payload

    agent = SACAgent(mesh_cfg(spec, dtype), device=device, seed=MESH_SEED)
    state = agent.init_state()
    step = mesh_step(spec, dtype, flavour, agent, {
        "plain": agent.learn, "per": agent.learn_per,
        "guided": agent.learn_guidence,
        "guided_per": agent.learn_guidence_per}[flavour])
    def one(state, u):
        with contextlib.ExitStack() as stack:
            if exact:
                stack.enter_context(plain_kernels())
                stack.enter_context(exact_sums())
            return step(state, u)

    sync = (torch.cuda.synchronize if agent.device.type == "cuda"
            else lambda: None)
    return mesh_updates(
        state, one, len(run["records"]), sync, keep=True,
        load=lambda st, u: load_payload(st, run["records"][u]["before"]))


def mesh_readings(run, ref, dtype):
    """One update's readings against `ref` (26a's rule): the largest
    |err| over update_mismatches' tolerance of each kind of quantity, the
    gradients' largest max|err|/L and pooled mean|err|/L."""
    read = {}
    for kind in ("metrics", "grad", "update"):
        worst = 0.0
        for name, r in ref[kind].items():
            tol = SAC_RTOL * abs(r) + SAC_ATOL
            if kind == "update":
                tol = (UPDATE_RTOL * abs(r) + SAC_ATOL
                       + 2.0 ** -22 * run["param_norm"].get(name, 0.0))
            worst = max(worst, abs(run[kind][name] - r) / tol)
        read[kind] = worst
    if "td" in ref:
        read["td"] = ((run["td"] - ref["td"]).abs()
                      / (SAC_RTOL * ref["td"].abs() + SAC_ATOL)).max().item()
    e = TrainErrors()
    e.add((run["grads"][n], g) for n, g in ref["grads"].items())
    read["grads_max"] = max(
        ((run["grads"][n] - g).abs().max()
         / g.abs().max().clamp(min=1e-30)).item()
        for n, g in ref["grads"].items())
    read["grads_mean"] = e.mean
    return read


def mesh_limits(dtype):
    """6b's limits of the mesh_readings held in `dtype`: in fp32 not the
    gradients' largest max|err|/L, which ill-conditioned tensors decide
    (MESH_K's note); it is printed."""
    if dtype == "bfloat16":
        return {"metrics": 1.0, "grad": 1.0, "update": 1.0, "td": 1.0,
                "grads_max": TRAIN_BF16_MAX, "grads_mean": TRAIN_BF16_MEAN}
    return {"metrics": 1.0, "grad": 1.0, "update": 1.0, "td": 1.0,
            "grads_mean": F32_POOLED}


def mesh_mismatches(dtype, run, single, exact, versions=None):
    """26a's faults of a data-parallel run (rank 0's records, with its
    gradients) and its readings by update: each reading against the
    float64-sum version of the single-rank update from the same state,
    under MESH_RULE's limit. `versions` ({'plain': run, 'float64': run},
    the w-rank versions from the same states): the plain versions'
    reading sets the restated limit; the float64-sum version is held to
    the single-rank limit (it reads near zero unless the data axis itself
    is wrong)."""
    bad, reads = [], []
    versions = versions or {}
    for u, (a, s, x) in enumerate(zip(run["records"], single["records"],
                                      exact["records"])):
        got, own = mesh_readings(a, x, dtype), mesh_readings(s, x, dtype)
        vread = {v: mesh_readings(r["records"][u], x, dtype)
                 for v, r in versions.items()}
        read = {}
        for k, old in mesh_limits(dtype).items():
            if k not in got:
                continue
            one = max(old, MESH_K * own[k])
            read[k] = {"dp": got[k], "single": own[k], "limit_single": one}
            if "plain" in vread:
                read[k]["plain_w"] = vread["plain"][k]
                read[k]["limit_restated"] = max(
                    old, MESH_K * max(own[k], vread["plain"][k]))
            if "float64" in vread:
                read[k]["float64_w"] = vread["float64"][k]
                if not vread["float64"][k] <= one:
                    bad.append(f"update {u} {k}: the float64-sum version "
                               f"{vread['float64'][k]:.3e} over {one:.3e}")
            limit = read[k].get("limit_restated", one) \
                if MESH_RULE == "restated" else one
            read[k]["limit"] = limit
            if not got[k] <= limit:
                bad.append(f"update {u} {k} {got[k]:.3e} over {limit:.3e} "
                           f"(the single-rank update {own[k]:.3e})")
        if dtype == "float32":
            read["grads_max (read only)"] = {"dp": got["grads_max"],
                                             "single": own["grads_max"]}
        reads.append(read)
    limited = [k for k in reads[0] if "limit" in reads[0][k]]
    share = lambda key, lim: {k: max(r[k][key] / r[k][lim] for r in reads)
                              for k in limited if key in reads[0][k]}
    summary = {"worst_of_limit": share("dp", "limit"),
               "dp_of_single": share("dp", "limit_single")}
    for v in versions:
        summary[f"{v}_w_of_single"] = share(f"{v}_w", "limit_single")
    if "plain" in versions:
        summary["dp_of_restated"] = share("dp", "limit_restated")
    return bad, {**summary, "by_update": reads}


def f64_sync(agent):
    """The data axis's gradient mean summed in float64: each rank's
    gradients widened, one all_reduce in float64, rounded once to the
    parameter's dtype."""
    import torch

    def sync(opt):
        world = agent._world()
        params = [p for g in opt.param_groups for p in g["params"]
                  if p.grad is not None]
        flat = agent._all_sum(torch.cat([p.grad.reshape(-1).double()
                                         for p in params]))
        flat.div_(world)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p).to(p.dtype)
    agent._sync_grads = sync


def mesh_version(spec, dtype, flavour, rt, version, befores, sync):
    """A w-rank version of `flavour`'s data-parallel update from each of
    `befores` (the states before a run's updates): 'plain', the plain
    versions in `dtype`; 'float64', the plain versions with every product
    summed in float64 and the gradients' all_reduce in float64. In
    mesh_updates' form (rank 0 keeps the gradients)."""
    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.core.checkpoint import load_payload
    from dgvit_tpu_torch.parallel import shardmap_learn

    agent = SACAgent(mesh_cfg(spec, dtype), device=rt.device,
                     seed=MESH_SEED, grad_axis="data")
    if version == "float64":
        f64_sync(agent)
    step = mesh_step(spec, dtype, flavour, agent,
                     shardmap_learn(agent, rt, flavour))

    def one(state, u):
        with contextlib.ExitStack() as stack:
            stack.enter_context(plain_kernels())
            if version == "float64":
                stack.enter_context(exact_sums())
            return step(state, u)

    return mesh_updates(agent.init_state(), one, len(befores), sync,
                        keep=rt.rank == 0,
                        load=lambda st, u: load_payload(st, befores[u]))


def mesh_run(spec, dtype, flavour, rt, wrong=None, steps=None):
    """26a on this rank: `steps` data-parallel updates of `flavour` in
    `dtype` from the phase's state (with `wrong`, a wrong data axis), and
    spec's w-rank versions of each from the same state (a wrong run: the
    plain versions, with the right data axis); rank 0 then takes the
    single-rank update and its float64-sum version from the state before
    each and reads the rule (mesh_mismatches). Returns what the parent
    checks: launches (each update's, the run's, the cluster forms'), the
    single-rank update's launches, host ms at world w and world 1, each
    update's gradient digest and metrics, and rank 0's faults and
    readings."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.parallel import shard_sac_state, shardmap_learn

    versions = tuple(v for v in spec.get("versions", {}).get(dtype, ())
                     if not wrong or v == "plain")
    agent = SACAgent(mesh_cfg(spec, dtype), device=rt.device,
                     seed=MESH_SEED, grad_axis="data")
    if wrong:
        mesh_wrong(agent, wrong, rt.rank, rt.world)
    state = shard_sac_state(rt, mesh_state(spec, agent))
    step = mesh_step(spec, dtype, flavour, agent,
                     shardmap_learn(agent, rt, flavour))
    sync = (torch.cuda.synchronize if rt.device.type == "cuda"
            else lambda: None)
    # every rank starts each timed update together (rank 0 first copies
    # the state aside for its references)
    run = mesh_updates(state, step, steps or spec["steps"], sync,
                       keep=rt.rank == 0 or bool(versions),
                       start=lambda: (sync(), rt.barrier()))
    out = {k: run[k] for k in ("per_update", "launches", "cluster",
                               "host_ms")}
    out["digests"] = [(r["digest"], r["metrics"]) for r in run["records"]]
    befores = [r["before"] for r in run["records"]] if versions else []
    vruns = {v: mesh_version(spec, dtype, flavour, rt, v, befores, sync)
             for v in versions}
    if rt.rank == 0:
        single = mesh_reference(spec, dtype, flavour, run, rt.device)
        exact = mesh_reference(spec, dtype, flavour, run, rt.device, True)
        out["bad"], out["read"] = mesh_mismatches(dtype, run, single, exact,
                                                  vruns)
        out["single_per_update"] = single["per_update"]
        out["world1_ms"] = single["host_ms"]
    return out


def mesh_state_equal(a, b):
    """Whether two SACStates hold the same parameters, log_alpha, Adam
    moments and generator state, bit for bit."""
    import torch

    for k in UPDATED:
        for p, q in zip(getattr(a, k).parameters(),
                        getattr(b, k).parameters()):
            if not torch.equal(p, q):
                return False
    for k in ("actor_opt", "critic_opt", "alpha_opt"):
        sa, sb = getattr(a, k).state_dict(), getattr(b, k).state_dict()
        for i, st in sa["state"].items():
            for n, v in st.items():
                if not torch.equal(v, sb["state"][i][n]):
                    return False
    return (torch.equal(a.log_alpha, b.log_alpha)
            and torch.equal(a.generator.get_state(), b.generator.get_state())
            and a.itera == b.itera)


def mesh_elastic(spec, rt, workdir):
    """26b on the ranks: the elastic drill (fp32, emb-dropout 0, the
    generator's own noise, a step-keyed batch an update): an unbroken run
    and one that raises SimulatedFault after update `fault_after` on its
    first attempt and restarts under run_elastic from the newest periodic
    checkpoint; whether the two end bit-equal, the attempts' start steps,
    the checkpoints kept; then the next update of the final state with
    injected noise (update_record's form, its gradients on rank 0), which
    the parent holds a world-1 resume of the last checkpoint to."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.core.elastic import (ElasticCheckpointer,
                                              SimulatedFault, run_elastic)
    from dgvit_tpu_torch.parallel import shard_sac_state, shardmap_learn

    e = spec["elastic"]
    agent = SACAgent(mesh_cfg(spec, "float32", e["batch"]), device=rt.device,
                     seed=MESH_SEED, grad_axis="data")
    learn = shardmap_learn(agent, rt)
    dev = rt.device

    def batch_at(step):
        b = mesh_inputs(spec, "float32", e["batch"], MESH_SEED + 100 + step)
        return {k: torch.from_numpy(v).to(dev) for k, v in b["batch"].items()}

    batches = [batch_at(s) for s in range(e["updates"])]

    def template():
        return shard_sac_state(rt, mesh_state(spec, agent))

    def loop(state, start, ck, fail_at=None):
        for step in range(start, e["updates"]):
            if step == fail_at:
                raise SimulatedFault(f"injected after update {step}")
            state, _ = learn(state, batches[step])
            ck.maybe_save(step + 1, state)
        return state

    ref = loop(template(), 0, ElasticCheckpointer(workdir / "ref", 10 ** 6))
    attempts = []

    def train_fn(state, start, ck):
        attempts.append(start)
        return loop(state, start, ck,
                    e["fault_after"] if len(attempts) == 1 else None)

    ck = ElasticCheckpointer(workdir / "elastic", e["interval"], keep=2)
    t0 = time.perf_counter()
    final = run_elastic(train_fn, template, ck, max_restarts=1)
    seconds = time.perf_counter() - t0
    bit_equal = mesh_state_equal(ref, final)
    inp = mesh_inputs(spec, "float32", e["batch"], MESH_SEED + 99)
    before = update_start(final)
    final, m = learn(final, {k: torch.from_numpy(v).to(dev)
                             for k, v in inp["batch"].items()},
                     noise=inp["noise"][0])
    nxt = update_record(final, m, before)
    nxt.pop("params")
    grads = nxt.pop("grads")
    if rt.rank == 0:
        nxt["grads"] = {n: g.float().cpu() for n, g in grads.items()}
    return {"bit_equal": bit_equal, "attempts": attempts,
            "seconds": seconds,
            "kept": sorted(p.name for p in (workdir / "elastic").iterdir()),
            "next": nxt}


def mesh_rank(rank, world, port, workdir, backend, spec):
    """One rank of phase 26 (torch.multiprocessing.spawn's target): joins
    the group through core/distributed.initialize over `backend`, runs
    26a (every flavour, dtype and wrong data axis; mesh_run), over gloo
    26b's elastic drill, then as spec asks 26c's sharded fused round
    (mesh_round) and 26d's train_fleet --mesh-data (mesh_fleet), and
    saves what it saw to workdir/rank<r>.pt. The kernels load from the
    build root the parent built."""
    import os

    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dgvit_tpu_torch.core import distributed
    from dgvit_tpu_torch.core.mesh import MeshRuntime

    distributed.initialize(backend=backend, timeout_s=300.0)
    workdir = Path(workdir)
    try:
        rt = MeshRuntime.create(device=None if spec["device"] == "cuda"
                                else "cpu")
        t0 = time.perf_counter()
        out = {"device": str(rt.device), "backend": dist.get_backend(),
               "runs": {}}
        for dtype in spec["dtypes"]:
            for flavour in MESH_FLAVORS:
                out["runs"][(dtype, flavour)] = mesh_run(spec, dtype,
                                                         flavour, rt)
            for wrong, flavour in MESH_WRONGS:
                out["runs"][(dtype, wrong)] = mesh_run(
                    spec, dtype, flavour, rt, wrong, spec["wrong_steps"])
        out["seconds"] = {"26a": time.perf_counter() - t0}
        for part, run, on in (
                ("26b", mesh_elastic,
                 backend == "gloo" and spec.get("elastic")),
                ("26c", mesh_round, spec.get("round")),
                ("26d", mesh_fleet, spec.get("fleet"))):
            if on:
                t1 = time.perf_counter()
                out[{"26b": "elastic", "26c": "round",
                     "26d": "fleet"}[part]] = run(spec, rt, workdir)
                out["seconds"][part] = time.perf_counter() - t1
        torch.save(out, workdir / f"rank{rank}.pt")
        rt.barrier()
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A free localhost port for the process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_spawn(backend, spec, workdir, world=None):
    """Phase 26's ranks over `backend` (gloo: every rank on the first
    card; nccl: one rank a card), spec's world of them by default; their
    saved results, rank by rank. A failing rank fails the phase."""
    import os

    import torch
    import torch.multiprocessing as mp

    world = world or spec.get("world", 2)
    keep = os.environ.get("CUDA_VISIBLE_DEVICES")
    if backend == "gloo" and spec["device"] == "cuda":
        os.environ["CUDA_VISIBLE_DEVICES"] = keep.split(",")[0] if keep \
            else "0"
    try:
        mp.spawn(mesh_rank, args=(world, free_port(), str(workdir), backend,
                                  spec), nprocs=world, join=True)
    finally:
        if keep is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = keep
    return [torch.load(Path(workdir) / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def mesh_world1(spec, directory, nxt):
    """26b in the parent: the ranks' newest checkpoint restored at world
    1 (no process group) into a single-rank agent, placed by
    reshard_state; its next update (the ranks' noise) and that update's
    float64-sum version; the ranks' next update held to the float64-sum
    version under 26a's rule, the world-1 update's reading setting it."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.core.elastic import (ElasticCheckpointer,
                                              reshard_state)
    from dgvit_tpu_torch.core.mesh import MeshRuntime

    e = spec["elastic"]
    dev = torch.device(spec["device"])
    inp = mesh_inputs(spec, "float32", e["batch"], MESH_SEED + 99)
    runs = []
    for exact in (False, True):
        agent = SACAgent(mesh_cfg(spec, "float32", e["batch"]), device=dev,
                         seed=MESH_SEED)
        state, start = ElasticCheckpointer(directory).resume(
            agent.init_state())
        state = reshard_state(state, MeshRuntime.create(
            device=None if dev.type == "cuda" else "cpu"))
        before = update_start(state)
        with contextlib.ExitStack() as stack:
            if exact:
                stack.enter_context(plain_kernels())
                stack.enter_context(exact_sums())
            state, m = agent.learn(state, {
                k: torch.from_numpy(v).to(dev)
                for k, v in inp["batch"].items()}, noise=inp["noise"][0])
        rec = update_record(state, m, before)
        rec["grads"] = {n: g.float().cpu() for n, g in rec["grads"].items()}
        rec.pop("params")
        runs.append({"records": [rec]})
    bad, read = mesh_mismatches("float32", {"records": [nxt]}, *runs)
    return start, bad, read


def phase_mesh(spec=None, w4=None):
    """Phase 26, a main path: the data-parallel tier on gloo ranks of the
    card (`mesh_rank`), and with enough cards one rank a card over NCCL
    too. 26a: every flavour's data-parallel update at world 2 (bf16 at
    B=256, fp32 at B=32, emb-dropout 0, the same injected global noise)
    and the fp32 flavours at world 4 (lead x: beside them the plain and
    the float64-sum four-rank versions), each held to the single-rank
    update from the same state by MESH_K's rule (MESH_RULE), the three
    wrong data axes failing it at both worlds; each rank's launches an
    update the single-rank update's (fp32 on the cluster forms: the forms
    of K4, K2 and K3 follow dtype, widths and alignment, not the batch);
    every rank on one state; the host ms an update at world 1 and w. 26b:
    the elastic drill bit-equal to the unbroken run, resumed from the
    checkpoint before the fault, then its last checkpoint resumed at
    world 1, the ranks' next update held to it by 26a's rule. 26c: the
    sharded fused round (mesh_round, round_verdicts); 26d: train_fleet
    --mesh-data 2 (mesh_fleet, fleet_verdicts). Returns its readings and
    launches."""
    import torch

    spec = spec or MESH_SPEC
    w4 = MESH_W4_SPEC if w4 is None else w4
    t0 = time.perf_counter()
    cards = torch.cuda.device_count() if spec["device"] == "cuda" else 0
    out = {"card": card(), "backends": {}, "readings": {}, "launches": {},
           "cluster_launches": {}, "host_ms": {}, "seconds": {},
           "lead_x": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        tmp = Path(tmp)
        prep = mesh_prepare(spec, tmp) if spec.get("round") or \
            spec.get("fleet") else {}
        if spec.get("fleet"):
            spec = dict(spec, fleet=dict(spec["fleet"], demos=prep["demos"]))
        for sp in (spec, w4):
            if not sp:
                continue
            world = sp["world"]
            backends = ["gloo"] + (["nccl"] if spec["device"] == "cuda"
                                   and cards >= world else [])
            out["backends"][world] = backends
            for backend in backends:
                name = backend if world == 2 else f"{backend}{world}"
                t1 = time.perf_counter()
                workdir = tmp / name
                workdir.mkdir()
                ranks = mesh_spawn(backend, sp, workdir, world)
                out["seconds"][name] = time.perf_counter() - t1
                out["seconds"][f"{name} parts"] = ranks[0]["seconds"]
                print(f"phase 26 ({backend}, world {world}): ranks on "
                      f"{[r['device'] for r in ranks]}, "
                      f"{out['seconds'][name]:.1f} s (rank 0's parts "
                      f"{ranks[0]['seconds']})", flush=True)
                mesh_verdicts(sp, name, ranks, out)
                if backend == "gloo" and sp.get("elastic"):
                    mesh_elastic_verdicts(sp, ranks, workdir, out)
                if sp.get("round"):
                    round_verdicts(sp, name, ranks, prep, out)
                if sp.get("fleet"):
                    fleet_verdicts(sp, name, ranks, workdir, prep, out)
    out["seconds"]["total"] = time.perf_counter() - t0
    print(f"phase 26: {out['seconds']['total']:.1f} s; lead x by flavour "
          f"(the kernels' and the plain versions' worst share of the "
          f"single-rank limit at each world): {json.dumps(out['lead_x'])}",
          flush=True)
    return out


def lead_x_verdict(read):
    """Lead x's reading of one w-rank run (its versions beside it): the
    kernels' and the w-rank plain versions' worst share of the single-rank
    limit, and what the summation-order contract makes of them."""
    dp = max(read["dp_of_single"].values())
    plain = max(read.get("plain_w_of_single", {"-": float("nan")}).values())
    f64 = max(read.get("float64_w_of_single", {"-": float("nan")}).values())
    if dp <= 1.0:
        verdict = "the single-rank rule holds"
    elif plain > 1.0:
        verdict = ("check gap: a correct order of sums (the plain "
                   "versions) fails the single-rank rule")
    else:
        verdict = ("port fault: the plain versions pass where the kernels "
                   "fail")
    return {"kernels": dp, "plain_w": plain, "float64_w": f64,
            "verdict": verdict}


def mesh_verdicts(spec, name, ranks, out):
    """26a's checks of one backend's ranks (see phase_mesh); `name` the
    backend and, past world 2, the world."""
    others = range(1, len(ranks))
    for dtype in spec["dtypes"]:
        for flavour in MESH_FLAVORS:
            label = f"{name} {dtype} {flavour}"
            runs = [r["runs"][(dtype, flavour)] for r in ranks]
            want = runs[0]["single_per_update"]
            for r, run in enumerate(runs):
                check(run["per_update"] == want,
                      f"26a {label} rank {r}: launches an update "
                      f"{run['per_update']}, the single-rank update's "
                      f"{want}")
                if dtype == "float32":
                    check(run["cluster"] == {k: run["launches"][k]
                                             for k in CLUSTER_KERNELS},
                          f"26a {label} rank {r}: fp32 launches off the "
                          f"cluster forms {run['cluster']}")
            for r in others:
                check(runs[0]["digests"] == runs[r]["digests"],
                      f"26a {label}: rank {r}'s gradients or metrics "
                      "differ from rank 0's")
            run = runs[0]
            read = run["read"]
            print(f"26a {label}: launches an update, rank 0 "
                  f"{run['per_update'][0]} (each rank's, each update's, "
                  f"equal to the single-rank update's); host "
                  f"{run['host_ms']:.2f} ms an update at world "
                  f"{len(ranks)} (ranks {[round(x['host_ms'], 2) for x in runs]}) "
                  f"against {run['world1_ms']:.2f} at world 1 (B="
                  f"{spec['batch'][dtype]}, medians of updates 1 on, read "
                  f"only; {card()}); against the float64-sum single-rank "
                  f"update ({MESH_RULE} rule), each reading's largest "
                  f"share of its limit: {read['worst_of_limit']}; of the "
                  f"single-rank limit: kernels {read['dp_of_single']}"
                  + "".join(f", {v} {read[v]}" for v in (
                      "plain_w_of_single", "float64_w_of_single",
                      "dp_of_restated") if v in read), flush=True)
            if "plain_w_of_single" in read:
                out["lead_x"][label] = lead_x_verdict(read)
                print(f"26a {label} lead x: {out['lead_x'][label]}",
                      flush=True)
            check(not run["bad"], f"26a {label}: {run['bad'][:6]}")
            out["readings"][label] = read
            out["host_ms"][label] = {"world1": run["world1_ms"], **{
                f"rank{r}": x["host_ms"] for r, x in enumerate(runs)}}
            out["launches"][label] = [x["launches"] for x in runs]
            if dtype == "float32":
                out["cluster_launches"][label] = [x["cluster"]
                                                  for x in runs]
        for wrong, flavour in MESH_WRONGS:
            run = ranks[0]["runs"][(dtype, wrong)]
            read = run["read"]
            print(f"26a {name} {dtype} wrong data axis ({wrong}): "
                  f"largest share of each limit ({MESH_RULE} rule) "
                  f"{read['worst_of_limit']}"
                  + (f"; of the restated limit {read['dp_of_restated']}"
                     if "dp_of_restated" in read else ""), flush=True)
            check(bool(run["bad"]), f"26a {name} {dtype}: the rule "
                  f"passed a wrong data axis ({wrong})")
            if "dp_of_restated" in read:
                check(max(read["dp_of_restated"].values()) > 1.0,
                      f"26a {name} {dtype}: the restated rule passed a "
                      f"wrong data axis ({wrong})")
            out["readings"][f"{name} {dtype} wrong {wrong}"] = read


def mesh_elastic_verdicts(spec, ranks, workdir, out):
    """26b's checks (see phase_mesh)."""
    e = spec["elastic"]
    el = [r["elastic"] for r in ranks]
    for r, x in enumerate(el):
        print(f"26b rank {r}: attempts {x['attempts']}, bit-equal to the "
              f"unbroken run {x['bit_equal']}, kept {x['kept']}, "
              f"{x['seconds']:.1f} s", flush=True)
        check(x["bit_equal"], f"26b rank {r}: the resumed run is not the "
              "unbroken run")
        check(x["attempts"] == [0, e["fault_after"] // e["interval"]
                                * e["interval"]],
              f"26b rank {r}: attempts {x['attempts']}")
    start, bad, read = mesh_world1(spec, workdir / "elastic", el[0]["next"])
    print(f"26b: the world-2 checkpoint of update {start} resumed at world "
          f"1; the ranks' next update against its float64-sum version, "
          f"each reading's share of its limit: {read['worst_of_limit']} "
          f"({card()})", flush=True)
    check(start == e["updates"], f"26b resumed at {start}")
    check(not bad, f"26b world-1 resume: {bad}")
    out["elastic"] = {"attempts": el[0]["attempts"], "kept": el[0]["kept"],
                      "seconds": el[0]["seconds"], "world1": read}


# ---------------------------------------------------------------------------
# 26c: the sharded fused round; 26d: train_fleet --mesh-data 2
# ---------------------------------------------------------------------------
# 26c's flavours: (label, PER, guided, fault knobs), the knobs the aug
# recipe's (AUG_ARGS) at its aug_prob
ROUND_FLAVOURS = (("plain", False, False, None),
                  ("per_aug", True, False,
                   {"patch_occlusion": 0.25, "obs_noise": 0.196}),
                  ("guided_per", True, True, None))
ROUND_AUG_PROB = 0.5
# the wrong versions 26c's checks must fail, each on the flavour it breaks
# (one round each); the replicated fault stream is read on a collection
ROUND_WRONGS = (("per_global_td", "per_aug"), ("per_rank0_rows", "per_aug"),
                ("stats_local", "plain"), ("n_expert_local", "guided_per"))


def round_cfg(spec, per):
    """26c's config: the flagship recipe's (bf16, device PER, nan_guard,
    alpha in [0.1, 2.0]) at spec's global batch and ring, emb-dropout 0
    (each update is held to the single-rank update, and a rank's dropout
    masks are its own); `per` PER on or off."""
    from dgvit_tpu_torch.config import Config

    r = spec["round"]
    return Config.from_dict({
        "model": {"compute_dtype": "bfloat16", "emb_dropout": 0.0,
                  **spec["model"]},
        "sac": {"batch_size": r["batch"], "buffer_size": r["ring"],
                "prioritized_replay": per, "nan_guard": True,
                "alpha_min": 0.1, "alpha_max": 2.0},
        "train": {"seed": MESH_SEED, "pre_buffer": False}})


def round_consts(spec, cfg, dev):
    from dgvit_tpu_torch.envs import vec_kinematic as vk

    return vk.make_consts(spec["round"]["world"],
                          image_hw=tuple(cfg.model.image_size),
                          max_steps=cfg.env.max_steps, seed=MESH_SEED,
                          device=dev)


def round_expert(spec, cfg, dev):
    """A staged expert corpus of spec's rows, drawn from a seed (the same
    on every rank: it is replicated)."""
    import numpy as np
    import torch

    n, hw = spec["round"]["expert"], tuple(cfg.model.image_size)
    rng = np.random.default_rng(MESH_SEED + 260)
    f = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    host = {"obs": f(n, *hw), "act": rng.uniform(-1, 1, (n, 2)),
            "pobs": f(n, 2), "next_pobs": f(n, 2),
            "rew": rng.normal(0, 1, (n, 1)), "next_obs": f(n, *hw),
            "done": (np.arange(n) % 9 == 8)[:, None]}
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
            for k, v in host.items()}


def round_kw(cfg):
    e = cfg.env
    return dict(l_scale=e.linear_cmd_scale, a_scale=e.angular_cmd_scale,
                max_action=e.max_action)


def round_digest(state):
    """Every parameter's float64 sum, log_alpha and the counter."""
    import torch

    sums = torch.stack([p.detach().double().sum() for k in UPDATED
                        for p in getattr(state, k).parameters()])
    return sums.cpu().tolist() + [state.log_alpha.item(), int(state.itera)]


@contextlib.contextmanager
def round_wrong(wrong, world):
    """A wrong version of the sharded round, patched in for the block."""
    from dgvit_tpu_torch.train import fused_train as ft
    from dgvit_tpu_torch.train import vec_rollout as vr

    mod, name = {"per_global_td": (ft, "rank_rows"),
                 "per_rank0_rows": (ft, "rank_rows"),
                 "stats_local": (ft, "group_reduce"),
                 "n_expert_local": (ft, "expert_rows"),
                 "fault_replicated": (vr, "rank_fault_generator")}[wrong]
    orig = getattr(mod, name)
    setattr(mod, name, {
        "per_global_td": lambda td, rank, b: td,
        "per_rank0_rows": lambda td, rank, b: td[:b],
        "stats_local": lambda t, mesh, op="sum":
            orig(t, mesh, op) if op == "max" else t,
        "n_expert_local": lambda n, size, b: orig(n, size // world,
                                                  b // world),
        "fault_replicated": lambda gen, rank, device: gen}[wrong])
    try:
        yield
    finally:
        setattr(mod, name, orig)


@contextlib.contextmanager
def round_hooks(agent, rt, log, every, b):
    """Readings inside a sharded round: each update's launches and global
    td; every `every`-th update held (its inputs and the state before it
    on every rank; on rank 0 its update_record); each priority update
    against a single-device per_update of the rank's rows of the td
    (max|prios - expected| / 1e-6 of the largest, with the running max);
    the stats each rank hands the group's sum."""
    import torch

    from dgvit_tpu_torch.core.checkpoint import state_payload
    from dgvit_tpu_torch.replay.device_per import DevicePER
    from dgvit_tpu_torch.train import fused_train as ft

    counters = kernel_counters()
    n = [0]
    names = ("learn", "learn_per", "learn_guidence", "learn_guidence_per")

    def wrap(real):
        def learn(state, batch, *args, **kw):
            keep = (n[0] + 1) % every == 0
            n[0] += 1
            was = {k: c.launches for k, c in counters.items()}
            if keep:
                before = update_start(state)
                payload = mesh_host(state_payload(state))
                inputs = mesh_host({"batch": dict(batch), "args": args})
            res = real(state, batch, *args, **kw)
            log["launches"].append({k: c.launches - was[k]
                                    for k, c in counters.items()})
            log["td"][0] = res[2] if len(res) == 3 else None
            if keep:
                rec = None
                if rt.rank == 0:
                    rec = update_record(res[0], res[1], before)
                    rec.pop("params")
                    rec["grads"] = {k: g.float().cpu()
                                    for k, g in rec["grads"].items()}
                    if len(res) == 3:
                        rec["td"] = res[2].float().cpu()
                log["held"].append({"name": real.__name__,
                                    "before": payload, "inputs": inputs,
                                    "record": rec})
            return res
        return learn

    real_pu, real_gr = ft.per_update, ft.group_reduce

    def per_update(per, idx, raw):
        own = log["td"][0][rt.rank * b:(rt.rank + 1) * b].abs() + 1e-6
        want = real_pu(DevicePER(per.prios.clone(), per.max_p.clone()), idx,
                       own)
        res = real_pu(per, idx, raw)
        diff = torch.maximum((per.prios - want.prios).abs().max(),
                             (per.max_p - want.max_p).abs())
        tol = 1e-6 * torch.maximum(want.prios.abs().max(), want.max_p)
        log["per"].append((diff / tol.clamp(min=1e-30)).item())
        return res

    def group_reduce(t, mesh, op="sum"):
        if op == "sum":
            log["stats"].append(t.detach().float().cpu().clone())
        return real_gr(t, mesh, op)

    for name in names:
        setattr(agent, name, wrap(getattr(agent, name)))
    ft.per_update, ft.group_reduce = per_update, group_reduce
    try:
        yield
    finally:
        ft.per_update, ft.group_reduce = real_pu, real_gr
        for name in names:
            delattr(agent, name)


def round_flavour(spec, rt, workdir, label, per, guided, knobs, wrong=None,
                  rounds=None):
    """26c on this rank: `rounds` sharded rounds of one flavour from the
    seeded state (with `wrong`, a wrong version): each round's stats,
    state digest and PER's running max; the launches; the hooks'
    readings (round_hooks); on rank 0 the held updates against the
    single-rank update of the union of the ranks' minibatches
    (round_replay)."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.parallel import shard_sac_state
    from dgvit_tpu_torch.parallel.shard import shardmap_fused_round

    r = spec["round"]
    dev = rt.device
    cfg = round_cfg(spec, per)
    agent = SACAgent(cfg, device=dev, seed=MESH_SEED, grad_axis="data")
    state = shard_sac_state(rt, agent.init_state())
    run, init = shardmap_fused_round(
        agent, rt, round_consts(spec, cfg, dev), r["lanes"], r["chunk"],
        r["updates"], r["batch"], r["ring"], **round_kw(cfg),
        prioritized=per, guided=guided, fault_knobs=knobs,
        aug_prob=ROUND_AUG_PROB if knobs else 1.0, seed=MESH_SEED)
    carry, ring, *p = init(tuple(cfg.model.image_size))
    per_state = p[0] if per else None
    expert = round_expert(spec, cfg, dev) if guided else None
    log = {"launches": [], "held": [], "td": [None], "per": [], "stats": []}
    stats, digests, max_p = [], [], []
    with contextlib.ExitStack() as stack:
        if wrong:
            stack.enter_context(round_wrong(wrong, rt.world))
        stack.enter_context(round_hooks(agent, rt, log, r["updates"],
                                        r["batch"] // rt.world))
        counters = kernel_counters()
        for c in counters.values():
            c.launches = 0
        for i in range(rounds or r["rounds"]):
            res = run(state, carry, ring, [i], expert, per=per_state)
            state, carry, ring, st = res[:4]
            stats.append({k: float(v[0]) for k, v in st.items()})
            digests.append(round_digest(state))
            if per:
                max_p.append(per_state.max_p.item())
        launches = {k: c.launches for k, c in counters.items()}
    plain = round_plain(cfg, rt, log["held"], dev)
    tag = f"{label}_{wrong}"
    torch.save([h["inputs"] for h in log["held"]],
               Path(workdir) / f"held_{tag}_{rt.rank}.pt")
    rt.barrier()
    out = {"stats": stats, "local": [v.tolist() for v in log["stats"]],
           "digests": digests, "max_p": max_p, "per_check": log["per"],
           "launches": launches, "per_update": log["launches"]}
    if rt.rank == 0:
        inputs = [torch.load(Path(workdir) / f"held_{tag}_{k}.pt",
                             weights_only=False) for k in range(rt.world)]
        out.update(round_replay(cfg, per, guided, log["held"], inputs, dev,
                                plain))
    return out


def to_device(tree, dev):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, dev) for v in tree)
    return tree


def round_plain(cfg, rt, held, dev):
    """The held updates again on every rank through the plain versions,
    on the data axis, each from the state before it with the rank's own
    inputs: the w-rank plain versions that set MESH_RULE's restated limit
    (rank 0 keeps the records)."""
    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.core.checkpoint import load_payload
    from dgvit_tpu_torch.core.mesh import use_mesh

    agent = SACAgent(cfg, device=dev, seed=MESH_SEED, grad_axis="data")
    state = agent.init_state()
    records = []
    for h in held:
        load_payload(state, h["before"])
        before = update_start(state)
        inp = to_device(h["inputs"], dev)
        with plain_kernels(), use_mesh(rt):
            res = getattr(agent, h["name"])(state, inp["batch"],
                                             *inp["args"])
        if rt.rank == 0:
            rec = update_record(res[0], res[1], before)
            rec.pop("params")
            rec["grads"] = {n: g.float().cpu()
                            for n, g in rec["grads"].items()}
            if len(res) == 3:
                rec["td"] = res[2].float().cpu()
            records.append(rec)
    return {"records": records}


def round_replay(cfg, per, guided, held, inputs, dev, plain):
    """Rank 0: each held update against the single-rank update (and its
    float64-sum version) on the rank-major union of the ranks'
    minibatches (agent rows, expert rows, importance weights), from the
    same state, with the same noise (the state's generator draws the
    global noise on both sides), by MESH_K's rule (MESH_RULE; `plain`,
    round_plain's records, the w-rank plain versions); the single-rank
    update's launches."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.core.checkpoint import load_payload

    agent = SACAgent(cfg, device=dev, seed=MESH_SEED)
    state = agent.init_state()
    fn = {"learn": agent.learn, "learn_per": agent.learn_per,
          "learn_guidence": agent.learn_guidence,
          "learn_guidence_per": agent.learn_guidence_per}
    cat = lambda parts: torch.cat(parts).to(dev)
    recs = {False: [], True: []}
    launches = []
    for i, h in enumerate(held):
        parts = [inp[i] for inp in inputs]
        batch = {k: cat([q["batch"][k] for q in parts])
                 for k in parts[0]["batch"]}
        args = list(parts[0]["args"])
        if guided:
            args[0] = {k: cat([q["args"][0][k] for q in parts])
                       for k in args[0]}
        if per:
            args[-1] = cat([q["args"][-1] for q in parts])
        for exact in (False, True):
            load_payload(state, h["before"])
            before = update_start(state)
            with contextlib.ExitStack() as stack:
                if exact:
                    stack.enter_context(plain_kernels())
                    stack.enter_context(exact_sums())
                res, k = counted(lambda: fn[h["name"]](state, batch, *args))
            rec = update_record(res[0], res[1], before)
            rec.pop("params")
            rec["grads"] = {n: g.float().cpu()
                            for n, g in rec["grads"].items()}
            if len(res) == 3:
                rec["td"] = res[2].float().cpu()
            recs[exact].append(rec)
            if not exact:
                launches.append(k)
    bad, read = mesh_mismatches(
        "bfloat16", {"records": [h["record"] for h in held]},
        {"records": recs[False]}, {"records": recs[True]}, {"plain": plain})
    return {"bad": bad, "read": read, "single_per_update": launches}


def round_collect(spec, rt):
    """26c's collection on this rank: the rank's lanes of a shardmap_collect
    chunk (the flagship's state from the seed, one generator for every
    rank) and its K1 launches; on rank 0 the unsharded collector's chunk
    of every lane from the same generator, and K1 against its plain
    version on the rank's frames (collected_k1, after the counts); then
    one step with patch occlusion, each rank's patch masks with its own
    fault stream and with one stream on every rank."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.core.rng import generator, step_key
    from dgvit_tpu_torch.envs.vec_kinematic import vec_reset
    from dgvit_tpu_torch.parallel.shard import shardmap_collect
    from dgvit_tpu_torch.train.vec_rollout import make_collect_fn

    r = spec["round"]
    dev = rt.device
    cfg = round_cfg(spec, False)
    agent = SACAgent(cfg, device=dev, seed=MESH_SEED, grad_axis="data")
    actor = agent.init_state().actor
    consts = round_consts(spec, cfg, dev)
    gen = lambda: generator(step_key(MESH_SEED, 2601), dev)
    collect, init = shardmap_collect(agent, rt, consts, r["lanes"],
                                     r["chunk"], **round_kw(cfg))
    (carry, traj), k = counted(lambda: collect(actor, init(), gen()))
    fields = ("obs", "act", "rew", "done", "next_obs", "episode_end")
    out = {"traj": {f: traj[f].cpu() for f in fields},
           "rec_idx": carry[0].rec_idx.cpu(), "k1": k["K1"]}
    if rt.rank == 0:
        one = SACAgent(cfg, device=dev, seed=MESH_SEED)
        c1, t1 = make_collect_fn(one, consts, r["chunk"], **round_kw(cfg))(
            actor, vec_reset(consts, r["lanes"]), gen())
        out["unsharded"] = {f: t1[f].cpu() for f in fields}
        out["unsharded_rec_idx"] = c1[0].rec_idx.cpu()
        out["k1_check"] = collected_k1(actor, traj, "26c rank 0's")
    collect_f, _ = shardmap_collect(
        agent, rt, consts, r["lanes"], 1, **round_kw(cfg),
        fault_knobs={"patch_occlusion": 0.25})
    for name, wrong in (("faults", None),
                        ("faults_replicated", "fault_replicated")):
        with contextlib.ExitStack() as stack:
            if wrong:
                stack.enter_context(round_wrong(wrong, rt.world))
            t = collect_f(actor, init(), gen(),
                          fault_gen=generator(step_key(MESH_SEED, 2602),
                                              dev))[1]
        out[name] = (t["obs"][0] == 0).cpu()
    return out


def round_rates(spec, rt, cfg, sharded):
    """The plain round's host time of each of spec's rounds, no hooks: on
    the data axis at world w (`sharded`, the ranks starting each round
    together), else the unsharded round of every lane at world 1."""
    import torch

    from dgvit_tpu_torch.agents import SACAgent
    from dgvit_tpu_torch.parallel import shard_sac_state
    from dgvit_tpu_torch.parallel.shard import shardmap_fused_round
    from dgvit_tpu_torch.train.fused_train import make_fused_round, ring_init

    r = spec["round"]
    dev = rt.device if sharded else torch.device(spec["device"])
    sync = (torch.cuda.synchronize if dev.type == "cuda" else lambda: None)
    agent = SACAgent(cfg, device=dev, seed=MESH_SEED,
                     grad_axis="data" if sharded else None)
    state = agent.init_state()
    consts = round_consts(spec, cfg, dev)
    hw = tuple(cfg.model.image_size)
    if sharded:
        state = shard_sac_state(rt, state)
        run, init = shardmap_fused_round(
            agent, rt, consts, r["lanes"], r["chunk"], r["updates"],
            r["batch"], r["ring"], **round_kw(cfg), seed=MESH_SEED)
        carry, ring = init(hw)
    else:
        from dgvit_tpu_torch.envs.vec_kinematic import vec_reset

        run = make_fused_round(agent, consts, r["lanes"], r["chunk"],
                               r["updates"], r["batch"], **round_kw(cfg),
                               seed=MESH_SEED)
        carry = vec_reset(consts, r["lanes"])
        ring = ring_init(r["ring"], hw, device=dev)
    times = []
    for i in range(r["rounds"]):
        sync()
        if sharded:
            rt.barrier()
        t0 = time.perf_counter()
        state, carry, ring, _ = run(state, carry, ring, [i])
        sync()
        times.append(time.perf_counter() - t0)
    return times


def round_rate_summary(spec, times):
    """Env steps/s and updates/s of the median round after the first."""
    r = spec["round"]
    t = statistics.median(times[1:] or times)
    return {"round_s": times, "env_steps_per_s": r["lanes"] * r["chunk"] / t,
            "updates_per_s": r["updates"] / t}


def mesh_round(spec, rt, workdir):
    """26c on this rank: the collection (round_collect), each flavour's
    rounds (round_flavour), the wrong versions (one round each) and the
    plain round's times (round_rates)."""
    out = {"collect": round_collect(spec, rt)}
    for label, per, guided, knobs in ROUND_FLAVOURS:
        out[label] = round_flavour(spec, rt, workdir, label, per, guided,
                                   knobs)
    flavours = {f[0]: f for f in ROUND_FLAVOURS}
    for wrong, label in ROUND_WRONGS:
        out[f"wrong {wrong}"] = round_flavour(
            spec, rt, workdir, *flavours[label], wrong=wrong, rounds=1)
    out["times"] = round_rates(spec, rt, round_cfg(spec, False), True)
    return out


def mesh_fleet_cfg(spec, guided):
    """26d's config: bf16 at the flagship's widths (or spec's), warm from
    the flagship actor, spec's episodes and global batch, PER and the
    expert buffer with `guided`."""
    from dgvit_tpu_torch.config import Config

    f = spec["fleet"]
    return Config.from_dict({
        "model": {"compute_dtype": "bfloat16", **spec["model"]},
        "env": {"max_steps": f["max_steps"]},
        "sac": {"batch_size": f["batch"], "buffer_size": FLEET_BUFFER,
                "prioritized_replay": guided},
        "train": {"seed": SEED, "pre_buffer": guided, "save": True,
                  "pre_train": spec["params"] == "golden",
                  "pre_train_model": str(ACTOR)[:-len("_actor.npz")]}})


def mesh_fleet_envs(n, hw):
    """n KinematicNavEnv robots on rrc at `hw` over phase 24's record
    table, robot i starting at record i."""
    from dgvit_tpu_torch.envs import KinematicNavEnv
    from dgvit_tpu_torch.envs.kinematic import default_records

    if not _FLEET_RECORDS:
        _FLEET_RECORDS.extend(default_records(seed=FLEET_RECORD_SEED))
    envs = []
    for i in range(n):
        env = KinematicNavEnv(_FLEET_RECORDS, world="rrc", image_hw=hw)
        env.indice_position = i % len(_FLEET_RECORDS)
        envs.append(env)
    return envs


def mesh_fleet(spec, rt, workdir):
    """26d on this rank: train_fleet(mesh_data=world) plain and guided PER
    (rank 0 the robots, the others followers), each rank's launches, its
    parameters saved for the parent, the files it wrote."""
    import torch

    from dgvit_tpu_torch.train import train_fleet as tf

    f = spec["fleet"]
    out = {}
    for label, guided in (("plain", False), ("guided_per", True)):
        cfg = mesh_fleet_cfg(spec, guided)
        envs = (mesh_fleet_envs(f["robots"], tuple(cfg.model.image_size))
                if rt.rank == 0 else [])
        out_dir = Path(workdir) / f"fleet_{label}_rank{rt.rank}"
        res, k = counted(lambda: tf.train_fleet(
            cfg, envs, out_dir=str(out_dir),
            max_episodes=f["robots"] * f["episodes"],
            expert_glob=f["demos"] if guided else None,
            mesh_data=rt.world, device=rt.device, log_every_updates=10))
        state = res["state"]
        torch.save({f"{kind}.{n}": p.detach().cpu() for kind in UPDATED
                    for n, p in getattr(state, kind).named_parameters()},
                   Path(workdir) / f"fleet_{label}_params{rt.rank}.pt")
        keep = ("episodes", "env_steps", "wall_s", "steps_per_s",
                "updates_per_s", "errors")
        out[label] = {"updates": res["updates"], "itera": int(state.itera),
                      "launches": k,
                      "files": sorted(str(p.relative_to(out_dir))
                                      for p in out_dir.rglob("*")
                                      if p.is_file())
                      if out_dir.exists() else [],
                      **{key: res[key] for key in keep if key in res}}
    return out


def mesh_prepare(spec, tmp):
    """In the parent, before the ranks: 26d's demos (policy-unit, recorded
    by train/demo_record) and 26c's plain round at world 1."""
    from dgvit_tpu_torch.train.demo_record import (policy_unit_pilot,
                                                   record_episodes)

    out = {}
    if spec.get("fleet"):
        cfg = mesh_fleet_cfg(spec, True)
        pilot, to_env = policy_unit_pilot(cfg)
        check(record_episodes(
            mesh_fleet_envs(1, tuple(cfg.model.image_size))[0], pilot,
            str(tmp / "demos"), episodes=spec["fleet"]["demo_episodes"],
            max_steps=200, action_to_env=to_env),
            "phase 26d recorded no demos")
        out["demos"] = str(tmp / "demos" / "RRC" / "torch" / "*.npz")
    if spec.get("round"):
        out["world1"] = round_rate_summary(spec, round_rates(
            spec, None, round_cfg(spec, False), False))
    return out


def round_verdicts(spec, name, ranks, prep, out):
    """26c's checks of one backend's ranks (see phase_mesh): the
    collection's union bit-equal to the unsharded collector's, K1 once a
    step at the rank's lanes; each flavour's held updates by MESH_K's
    rule, the ranks on one state after every round, the stats the sums
    of the ranks' own, PER's running max equal and each rank's
    priorities its rows' single-device update, the launches an update
    the single-rank update's; each wrong version failing its check by a
    printed factor; the rates at world 1 and 2."""
    import torch

    from dgvit_tpu_torch.train.fused_train import expert_rows

    r = spec["round"]
    world = len(ranks)
    rounds = [x["round"] for x in ranks]
    res = {"launches": [], "flavours": {}, "wrong": {}}
    col = [x["collect"] for x in rounds]
    unsharded = col[0]["unsharded"]
    same = {f: torch.equal(torch.cat([c["traj"][f] for c in col], dim=1), v)
            for f, v in unsharded.items()}
    same["records"] = torch.equal(torch.cat([c["rec_idx"] for c in col]),
                                  col[0]["unsharded_rec_idx"])
    k1 = [c["k1"] for c in col]
    print(f"26c {name} collection: the ranks' {r['lanes'] // world} lanes "
          f"each against the unsharded collector's {r['lanes']} "
          f"({r['chunk']} steps), bit-equal by field {same}; K1 launches "
          f"{k1} (one a step), form at the rank's lanes "
          f"{col[0]['k1_check']['forms']}; K1 against its plain version "
          f"on rank 0's frames: mean {col[0]['k1_check']['rel']:.3e} "
          f"(limit {col[0]['k1_check']['limit']:.3e})", flush=True)
    check(all(same.values()), f"26c {name}: the sharded lanes differ from "
          f"the unsharded collector's: {same}")
    check(k1 == [r["chunk"]] * world, f"26c {name}: K1 launches {k1}")
    differ = [int((c["faults"] ^ col[0]["faults"]).sum()) for c in col[1:]]
    replicated = [int((c["faults_replicated"]
                       ^ col[0]["faults_replicated"]).sum())
                  for c in col[1:]]
    print(f"26c {name} fault streams: patch pixels that differ from rank "
          f"0's, each rank's own stream {differ} (must be > 0); one stream "
          f"on every rank {replicated} (the wrong version: 0 fails it)",
          flush=True)
    check(all(d > 0 for d in differ), f"26c {name}: the ranks drew the "
          "same fault rectangles")
    check(all(d == 0 for d in replicated), f"26c {name}: the replicated "
          "fault stream drew different rectangles")
    res["wrong"]["fault_replicated"] = {"differing_pixels": replicated}
    n_exp = expert_rows(r["expert"], r["lanes"] * r["chunk"],
                        r["batch"])
    for label, per, guided, knobs in ROUND_FLAVOURS:
        runs = [x[label] for x in rounds]
        fl = round_flavour_verdict(spec, name, label, per, guided, runs,
                                   n_exp)
        res["flavours"][label] = fl
    res["launches"] = [{k: sum(x[label]["launches"][k]
                               for label, *_ in ROUND_FLAVOURS)
                        for k in PER_UPDATE} for x in rounds]
    for wrong, label in ROUND_WRONGS:
        runs = [x[f"wrong {wrong}"] for x in rounds]
        factor = round_wrong_factor(wrong, runs, n_exp)
        print(f"26c {name} wrong version ({wrong}, on {label}): its check "
              f"reads {factor:.3e} of its limit", flush=True)
        check(factor > 1.0, f"26c {name}: the checks passed a wrong round "
              f"({wrong})")
        res["wrong"][wrong] = factor
    w1 = prep["world1"]
    w2 = round_rate_summary(spec, rounds[0]["times"])
    print(f"26c {name} rates (plain round, {r['lanes']} lanes x "
          f"{r['chunk']} steps and {r['updates']} updates of B={r['batch']}"
          f", host clock, median round after the first; {card()}): world 1 "
          f"{w1['env_steps_per_s']:.2f} env steps/s, "
          f"{w1['updates_per_s']:.3f} updates/s (rounds {w1['round_s']} "
          f"s); world {world} {w2['env_steps_per_s']:.2f} env steps/s, "
          f"{w2['updates_per_s']:.3f} updates/s (rounds {w2['round_s']} s)",
          flush=True)
    res["rates"] = {"world1": w1, f"world{world}": w2}
    out.setdefault("round", {})[name] = res


def round_flavour_verdict(spec, name, label, per, guided, runs, n_exp):
    """26c's checks of one flavour's ranks (round_verdicts)."""
    import numpy as np

    r = spec["round"]
    world = len(runs)
    lead = runs[0]
    for k, x in enumerate(runs[1:], 1):
        check(x["digests"] == lead["digests"], f"26c {name} {label}: rank "
              f"{k}'s state differs from rank 0's after a round")
        check(x["stats"] == lead["stats"], f"26c {name} {label}: rank {k}'s"
              " stats differ")
        if per:
            check(x["max_p"] == lead["max_p"], f"26c {name} {label}: max_p "
                  f"{x['max_p']} on rank {k}, {lead['max_p']} on rank 0")
    summed = np.sum([x["local"] for x in runs], axis=0)
    keys = ("reward_sum", "goals", "collisions", "episodes", "buffer")
    got = np.asarray([[st[k] for k in keys] for st in lead["stats"]])
    stats_err = float(np.max(np.abs(got - summed)
                             / (1e-6 * np.abs(summed) + 1e-6)))
    per_read = max((max(x["per_check"]) for x in runs if x["per_check"]),
                   default=0.0)
    updates = len(lead["per_update"])
    want = lead["single_per_update"][0]
    launches_ok = all(u == want for x in runs for u in x["per_update"]) \
        and all(u == want for u in lead["single_per_update"])
    k1 = [x["launches"]["K1"] for x in runs]
    read = lead["read"]
    print(f"26c {name} {label}: {updates} updates a rank over "
          f"{len(lead['stats'])} rounds; held {len(read['by_update'])} "
          f"(each round's last) against the single-rank update of the "
          f"union, each reading's largest share of its limit "
          f"{read['worst_of_limit']}; stats against the sum of the ranks' "
          f"own {stats_err:.3e} of 1e-6; PER's priorities against their "
          f"rows' single-device update {per_read:.3e} of 1e-6; max_p "
          f"{lead['max_p']}; launches an update {want} (the single-rank "
          f"update's: {launches_ok}); K1 {k1}; stats "
          f"{lead['stats'][-1]}", flush=True)
    check(not lead["bad"], f"26c {name} {label}: {lead['bad'][:6]}")
    check(stats_err <= 1.0, f"26c {name} {label}: the stats are not the "
          f"sum of the ranks' own ({stats_err:.3e})")
    check(per_read <= 1.0, f"26c {name} {label}: PER's priorities off "
          f"their rows' update ({per_read:.3e})")
    check(launches_ok, f"26c {name} {label}: launches an update "
          f"{[x['per_update'][0] for x in runs]}, the single-rank "
          f"update's {want}")
    check(k1 == [len(lead["stats"]) * r["chunk"]] * world,
          f"26c {name} {label}: K1 launches {k1}")
    if guided:
        check(lead["stats"][0]["n_expert"] == n_exp,
              f"26c {name} {label}: n_expert {lead['stats'][0]['n_expert']}"
              f", expected {n_exp} at global scale")
    return {"read": read["worst_of_limit"], "stats_err": stats_err,
            "per_read": per_read, "max_p": lead["max_p"],
            "per_update": want, "k1": k1, "stats": lead["stats"]}


def round_wrong_factor(wrong, runs, n_exp):
    """A wrong round's reading of the check it breaks, as a share of the
    check's limit."""
    import numpy as np

    lead = runs[0]
    if wrong.startswith("per_"):
        return max(max(x["per_check"]) for x in runs)
    if wrong == "stats_local":
        summed = np.sum([x["local"] for x in runs], axis=0)
        keys = ("reward_sum", "goals", "collisions", "episodes", "buffer")
        got = np.asarray([[st[k] for k in keys] for st in lead["stats"]])
        return float(np.max(np.abs(got - summed)
                            / (1e-6 * np.abs(summed) + 1e-6)))
    return max(abs(lead["stats"][0]["n_expert"] - n_exp) / 0.5,
               max(lead["read"]["worst_of_limit"].values()))


def fleet_verdicts(spec, name, ranks, workdir, prep, out):
    """26d's checks of one backend's ranks (see phase_mesh): errors none,
    updates > 0 and itera == updates on rank 0, as many on every rank;
    the ranks' parameters bit-equal; K1 on rank 0 only; each rank's
    launches an update the single-rank update's (phase 6's plain, phase
    18's guided counts); the final actor and the checkpoints written by
    rank 0 alone."""
    import torch

    res = {}
    for label, per_update in (("plain", PER_UPDATE),
                              ("guided_per", PER_GUIDED)):
        runs = [x["fleet"][label] for x in ranks]
        lead = runs[0]
        params = [torch.load(Path(workdir) / f"fleet_{label}_params{k}.pt",
                             weights_only=False) for k in range(len(ranks))]
        equal = all(torch.equal(v, p[n]) for p in params[1:]
                    for n, v in params[0].items())
        trained = {k: v for k, v in per_update.items() if k != "K1"}
        launches_ok = all(
            {k: x["launches"][k] for k in trained}
            == {k: n * x["updates"] for k, n in trained.items()}
            for x in runs)
        k1 = [x["launches"]["K1"] for x in runs]
        actors = [[f for f in x["files"] if f.startswith("models/")]
                  for x in runs]
        ckpts = [[f for f in x["files"] if f.startswith("checkpoints/")]
                 for x in runs]
        print(f"26d {name} train_fleet --mesh-data {len(ranks)} ({label}, "
              f"{spec['fleet']['robots']} robots): {lead['episodes']} "
              f"episodes, {lead['env_steps']} env steps, updates "
              f"{[x['updates'] for x in runs]} (itera "
              f"{[x['itera'] for x in runs]}) in {lead['wall_s']:.2f} s = "
              f"{lead['steps_per_s']:.2f} env steps/s, "
              f"{lead['updates_per_s']:.2f} updates/s (host clock, "
              f"{card()}); parameters bit-equal {equal}; launches "
              f"{[x['launches'] for x in runs]}; actors written "
              f"{actors}; checkpoints by rank {[len(c) for c in ckpts]}",
              flush=True)
        check(lead["errors"] == {}, f"26d {name} {label}: robots failed "
              f"{lead['errors']}")
        check(lead["updates"] > 0 and all(
            x["updates"] == x["itera"] == lead["updates"] for x in runs),
            f"26d {name} {label}: updates {[x['updates'] for x in runs]}, "
            f"itera {[x['itera'] for x in runs]}")
        check(equal, f"26d {name} {label}: the ranks' parameters differ")
        check(k1[0] > 0 and not any(k1[1:]), f"26d {name} {label}: K1 "
              f"launches {k1}, on rank 0 only expected")
        check(launches_ok, f"26d {name} {label}: launches "
              f"{[x['launches'] for x in runs]}, {per_update} an update "
              "expected")
        check(len(actors[0]) == 1 and not any(actors[1:])
              and ckpts[0] and not any(ckpts[1:]),
              f"26d {name} {label}: actors {actors}, checkpoints "
              f"{[len(c) for c in ckpts]}")
        res[label] = {"updates": lead["updates"],
                      "steps_per_s": lead["steps_per_s"],
                      "updates_per_s": lead["updates_per_s"],
                      "launches": [x["launches"] for x in runs]}
    out.setdefault("fleet", {})[name] = res


def mesh_launches(mesh, short, dtype):
    """A kernel's launches on phase 26's paths in `dtype`, for the kernels
    line: each rank's over 26a's four flavours (fp32: the cluster
    forms'); in bf16 also each rank's over 26c's sharded rounds ("mesh
    round") and 26d's two fleet campaigns ("fleet mesh")."""
    key = "launches" if dtype == "bfloat16" else "cluster_launches"
    out = {}
    for name, per_rank in mesh[key].items():
        backend, dt, flavour = name.split()
        if dt != dtype:
            continue
        for r, counts in enumerate(per_rank):
            k = f"mesh_26a_{backend}_rank{r}"
            out[k] = out.get(k, 0) + counts[short]
    if dtype == "bfloat16":
        for name, res in mesh.get("round", {}).items():
            for r, counts in enumerate(res["launches"]):
                out[f"mesh_round_26c_{name}_rank{r}"] = counts[short]
        for name, res in mesh.get("fleet", {}).items():
            for r in range(len(res["plain"]["launches"])):
                out[f"fleet_mesh_26d_{name}_rank{r}"] = sum(
                    v["launches"][r][short] for v in res.values())
    return out

# The times of the kernels redesigned for the tensor cores in their earlier
# FMA form (bf16; this script's phases 8 and 17 on an H100 80GB HBM3 at a
# 700 W power limit, recorded in PERF.md's kernel table): K2b and K6 at
# B=256, K4 and K2f at B=256, K3b and K3f at B=256, K7 and K8 by shape.
# Recorded, not measured in this run: they go on the printed lines only,
# never into the kernels line (K3f's and K7's FMA kernels are also timed
# in this run, `fma_ms`).
FMA_DESIGN_MS = {"K2b": 10.8233, "K6": 39.3067, "K4": 5.6300, "K2f": 1.6128,
                 "K3b": 1.9268, "K3f": 0.4135,
                 "K7": {"(256, 65, 64)": 0.6242},
                 "K8": {"(256, 4, 65, 64)": 0.2149,
                        "(64, 4, 257, 64)": 0.8475,
                        "(8, 2, 65, 160)": 0.0854}}


# The designs this script's kernels replaced most recently, as an H100
# 80GB HBM3 at a 700 W power limit timed them (chip_smoke.py run D1 of the
# tree before, PERF.md's kernel table): K6 at B=256 with its FMA forward
# chain (it recomputed K4's streams), K5 by batch in two launches (a
# min/max pass, then one block per 8 x 40 tile of the states). Recorded,
# not measured in this run: printed beside, never in the kernels line.
REPLACED_MS = {"K6": 10.3545, "K5": {1: 0.0314, 32: 0.1531, 256: 1.1291}}


def earlier(t_ms, before_ms):
    """The earlier design's recorded time and the speed-up, for a printed
    line."""
    return (f"; earlier FMA design {before_ms:.4f} ms (recorded, not this "
            f"run), now {before_ms / t_ms:.2f}x faster")


KERNELS = {   # short name -> (wrapper, source, TPU kernel it replaces)
    "K1": ("got_forward_fused", "got_megakernel.cu",
           "dgvit_tpu/ops/got_megakernel.py:289"),
    "K4": ("blocks_cls_forward_fused", "got_megakernel.cu",
           "dgvit_tpu/ops/got_megakernel.py:208"),
    "K2f": ("block_fwd_fused", "block_grad.cu",
            "dgvit_tpu/ops/fused_transformer.py:297"),
    "K2b": ("block_bwd_fused", "block_grad.cu",
            "dgvit_tpu/ops/fused_transformer.py:568"),
    "K3f": ("cls_fwd_fused", "block_grad.cu",
            "dgvit_tpu/ops/cls_block.py:281"),
    "K3b": ("cls_bwd_fused", "block_grad.cu",
            "dgvit_tpu/ops/cls_block.py:320"),
    "K5": ("preprocess_depth_fused", "depth_preprocess.cu",
           "dgvit_tpu/ops/pallas_preprocess.py:205"),
    "K6": ("trunk_bwd_fused", "block_grad.cu",
           "dgvit_tpu/ops/trunk_train.py:150"),
    "K7": ("fused_attention_section", "attention.cu",
           "dgvit_tpu/ops/fused_block.py:79"),
    "K8": ("attention_fused", "attention.cu",
           "dgvit_tpu/ops/attention.py:80"),
}


# The CUDA kernels of K3f's and K3b's fp32 cluster forms (block_grad.cu;
# K3b's weight products are wgrad_kernel's, as every fp32 backward's)
K3_FP32_KERNELS = {
    "K3f": ["cls_attend_cluster_fp32_kernel", "cls_mlp_fp32_kernel"],
    "K3b": ["cls_mlp_bwd_fp32_kernel", "cls_bwd_cluster_fp32_kernel",
            "wgrad_kernel<float>", "wgrad_finish<float>",
            "vec_finish<float>"]}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (ROOT / "dgvit_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from dgvit_tpu_torch.config import Config
    from dgvit_tpu_torch.core.checkpoint import load_params_npz
    from dgvit_tpu_torch.models import build_actor, params_from_jax
    from dgvit_tpu_torch.ops import _build
    from dgvit_tpu_torch.ops.attention import _attention_lib
    from dgvit_tpu_torch.ops.fused_preprocess import \
        _kernel_lib as _preprocess_lib
    from dgvit_tpu_torch.ops.fused_transformer import _block_lib
    from dgvit_tpu_torch.ops.got_megakernel import _kernel_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off (torch.backends.cuda.matmul and cudnn)")

    print(card())
    print(sys.version.split()[0], "torch", torch.__version__, "cuda",
          torch.version.cuda, flush=True)

    # the kernel libraries, and beside them (all eight nvcc at once) cubins
    # of the same sources whose ptxas reports give registers and spills
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = ("got_megakernel", "block_grad", "depth_preprocess",
               "attention")
    reports = [subprocess.Popen(
        [_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v", "-o",
         str(_build.BUILD_DIR / f"{src}.cubin"),
         str(_build.CSRC / f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in sources]
    try:
        _build.build(*sources)
        _kernel_lib()
        _block_lib()
        _preprocess_lib()
        _attention_lib()
    finally:
        outs = [p.communicate()[0] for p in reports]
    print(f"built {', '.join(sources)} in {time.perf_counter() - t0:.1f} s")
    for proc, report in zip(reports, outs):
        check(proc.returncode == 0, f"ptxas report failed:\n{report}")
        for line in report.splitlines():
            if "Compiling entry" in line:
                print(f"  ptxas: {line.split()[-3][:100]}")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    sys.stdout.flush()

    k5_per_call = k5_cuda_kernels()
    cfg = Config()
    flat = load_params_npz(str(ACTOR))
    sd = params_from_jax(flat)
    policies = {}
    for dtype in ("bfloat16", "float32"):
        p = build_actor(cfg, dtype=getattr(torch, dtype))
        p.load_state_dict(sd)
        policies[dtype] = p.to(DEVICE).eval()
    rng = np.random.default_rng(SEED)

    worst = phase_kernel_vs_plain(cfg, policies, rng)
    act = phase_policy(cfg, flat)
    launches = phase_serving(act, rng)

    actor_flat, critic_flat = golden_params()
    nets = build_nets(actor_flat, critic_flat)
    train_worst = phase_train_kernels(nets, rng)
    phase_bwd_widths(nets, rng)
    wgrad_times = phase_weight_products()
    sac_launches, update_s, one_update = phase_sac(actor_flat, critic_flat)
    sac_fp32, default_fp32 = phase_sac_fp32()
    check_profile(one_update, DEFAULT_CUDA_LAUNCHES, "default")

    k5_worst = phase_k5(rng)
    camera_launches = phase_camera(cfg, flat, k5_per_call)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        loop_launches, loop_rates, guided_loop = phase_train(out_dir)

    k6_worst = phase_k6(nets, rng)
    with trunk_grad_switch():
        trunk_launches, trunk_update_s, trunk_update = phase_sac(
            actor_flat, critic_flat, PER_UPDATE_TRUNK,
            "trunk-gradient SAC")
    trunk_fp32 = phase_trunk_grad_fp32(default_fp32)
    check_profile(trunk_update, TRUNK_CUDA_LAUNCHES, "trunk-gradient",
                  "trunk-gradient bf16")
    print(f"trunk-gradient route: {trunk_update_s * 1e3:.2f} ms an update "
          f"against {update_s * 1e3:.2f} ms on the default route (bf16, "
          f"B={SAC_BATCH}, host clock, synchronized, medians of steps 1-"
          f"{SAC_STEPS - 1} in this run)", flush=True)
    guided = phase_guided(actor_flat, critic_flat, {
        "default": (update_s, one_update),
        "trunk-gradient": (trunk_update_s, trunk_update)})
    on_device = phase_on_device()
    device_per = phase_device_per()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        recipes = phase_recipes(out_dir)
    faults = phase_faults(rng)
    imitation = phase_imitation()
    zoo = phase_zoo()
    fleet = phase_fleet(flat)
    slice25 = phase_slice(flat)
    mesh26 = phase_mesh()
    attn_worst = phase_attention(nets, rng)
    composed_launches = phase_composed(cfg, flat, policies, rng)

    times = phase_times(cfg, policies, rng)
    train_times = phase_train_times(nets, rng)
    k5_times = phase_k5_times(rng)
    attn_times = phase_attention_times(nets, rng)
    long_frames = phase_long_frames(flat, rng)
    fault_j = phase_fault_j(nets, rng)
    recompute = phase_recompute(nets, rng)

    main_b = 32  # the largest serving bucket: the serving path's biggest shape
    t = times[main_b]
    rows = [{
        "name": "got_forward_fused",
        "route": "cuda",
        "source": "dgvit_tpu_torch/ops/csrc/got_megakernel.cu",
        "replaces": KERNELS["K1"][2],
        "launches": launches,
        "max_abs_err": worst["bfloat16"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "batch": main_b,
        "dtype": "bfloat16",
        "max_abs_err_fp32": worst["float32"],
        "by_batch": {str(b): v for b, v in times.items()},
        "teacher_fp32": {str(b): v for b, v in
                         imitation["teacher"]["k1"].items()},
    }]
    rows[0]["launches_by_path"] = {
        "serving": launches, "camera_to_action": camera_launches["K1"],
        "train": loop_launches["K1"],
        **{f"train_{k}": v["K1"] for k, v in guided_loop.items()},
        "run_eval_vec": on_device["vec_eval"]["flagship"]["launches"]["K1"],
        "fused_train": on_device["fused"]["launches"]["K1"],
        "fused_train_guided": on_device["fused"]["guided_launches"]["K1"],
        "train_vec": on_device["train_vec"]["launches"]["K1"],
        **recipe_launches(recipes, "K1"),
        "aug_recipe": faults["aug_recipe"]["launches"]["K1"],
        "sweep": faults["sweep"]["launches"]["K1"],
        **imitation_launches(imitation, "K1"),
        **zoo_launches(zoo, "K1"),
        **fleet_launches(fleet, "K1"),
        **mesh_launches(mesh26, "K1", "bfloat16")}
    for short, (name, src, replaces) in KERNELS.items():
        if short in ("K4", "K2f", "K2b", "K3f", "K3b"):
            rows.append({
                "name": name, "route": "cuda",
                "source": f"dgvit_tpu_torch/ops/csrc/{src}",
                "replaces": replaces,
                "launches": sac_launches[short],
                "max_abs_err": train_worst[(short, "bfloat16")],
                **train_times[short],
                "library_ms": None,
                "batch": SAC_BATCH, "dtype": "bfloat16",
                "max_abs_err_fp32": train_worst[(short, "float32")],
                "launches_per_update": PER_UPDATE[short],
                **({"weight_products": wgrad_times} if short == "K2b"
                   else {}),
                "launches_by_path": {
                    "sac_update": sac_launches[short],
                    "train": loop_launches[short],
                    "trunk_grad_update": trunk_launches[short],
                    "guided_update": guided["default"]["launches"][short],
                    "guided_trunk_grad_update":
                        guided["trunk-gradient"]["launches"][short],
                    **{f"train_{k}": v[short]
                       for k, v in guided_loop.items()},
                    "fused_train": on_device["fused"]["launches"][short],
                    "fused_train_guided":
                        on_device["fused"]["guided_launches"][short],
                    "train_vec": on_device["train_vec"]["launches"][short],
                    **recipe_launches(recipes, short),
                    "aug_recipe": faults["aug_recipe"]["launches"][short],
                    **imitation_launches(imitation, short),
                    **zoo_launches(zoo, short),
                    **fleet_launches(fleet, short),
                    **slice_launches(slice25, short, "bfloat16"),
                    **mesh_launches(mesh26, short, "bfloat16")},
                **({"bc_fp32": {str(b): t["kernels"][short] for b, t in
                                imitation["bc_kernels"]["times"].items()}}
                   if short != "K4" else {}),
            })
    name, src, replaces = KERNELS["K5"]
    rows.append({
        "name": name, "route": "cuda",
        "source": f"dgvit_tpu_torch/ops/csrc/{src}", "replaces": replaces,
        "launches": camera_launches["K5"], "max_abs_err": k5_worst,
        **k5_times[CAMERA_FRAMES], "library_ms": None,
        "batch": CAMERA_FRAMES, "dtype": "float32", "noise_level": 50.0,
        "by_batch": {str(b): v for b, v in k5_times.items()},
        "launches_by_path": {"camera_to_action": camera_launches["K5"],
                             **fleet_launches(fleet, "K5")},
    })
    name, src, replaces = KERNELS["K6"]
    rows.append({
        "name": name, "route": "cuda",
        "source": f"dgvit_tpu_torch/ops/csrc/{src}", "replaces": replaces,
        "launches": trunk_launches["K6"],
        "max_abs_err": k6_worst["bfloat16"], **attn_times["K6"],
        "batch": SAC_BATCH, "dtype": "bfloat16",
        "max_abs_err_fp32": k6_worst["float32"],
        "launches_per_update": PER_UPDATE_TRUNK["K6"],
        "update_ms": trunk_update_s * 1e3,
        "default_update_ms": update_s * 1e3,
        "launches_by_path": {
            "trunk_grad_update": trunk_launches["K6"],
            "guided_trunk_grad_update":
                guided["trunk-gradient"]["launches"]["K6"],
            **fleet_launches(fleet, "K6")},
    })
    for short, path, shape in (
            ("K7", "dropout", f"({SAC_BATCH}, 65, 64)"),
            ("K8", "pallas", str(ATTN_SHAPES[0]))):
        name, src, replaces = KERNELS[short]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"dgvit_tpu_torch/ops/csrc/{src}",
            "replaces": replaces,
            "launches": composed_launches[path][short],
            "max_abs_err": attn_worst[(short, "bfloat16")],
            **attn_times[short][shape],
            "shape": shape, "dtype": "bfloat16",
            "max_abs_err_fp32": attn_worst[(short, "float32")],
            "launches_by_path": {
                **{k: v[short] for k, v in composed_launches.items()},
                **zoo_launches(zoo, short),
                **fleet_launches(fleet, short)},
            "by_shape": attn_times[short],
            **({"vit": zoo["vit"]["k8_times"],
                "vit_max_abs_err": zoo["vit"]["k8_worst"]}
               if short == "K8" else {}),
        })
    # the fp32 forms redesigned for the tensor cores: K1's cluster form on
    # the teacher's path (phase 22c, B=1), K8's attention_tf32_kernel on
    # the SimpleViT's updates at 256 patches (phase 23b)
    teacher = imitation["teacher"]
    name, src, replaces = KERNELS["K1"]
    t1 = teacher["k1"][1]
    rows.append({
        "name": name, "route": "cuda",
        "source": f"dgvit_tpu_torch/ops/csrc/{src}", "replaces": replaces,
        "launches": teacher["launches"]["K1"],
        "max_abs_err": worst["float32"],
        **{key: t1[key] for key in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "fma_ms")},
        "library_ms": None, "batch": 1, "dtype": "float32",
        "form": t1["form"],
        "by_batch": {str(b): v for b, v in teacher["k1"].items()},
        "launches_by_path": {
            "teacher_tool": teacher["launches"]["K1"],
            "reference_config_main":
                zoo["reference_config"]["launches"]["reference_config_main"][
                    "K1"],
            "train_env_replay":
                slice25["offline"]["launches"]["train_env_replay"]["K1"]}})
    name, src, replaces = KERNELS["K8"]
    vit = zoo["vit"]
    shape = str(VIT_ATTN_SHAPES[1])
    rows.append({
        "name": name, "route": "cuda",
        "source": f"dgvit_tpu_torch/ops/csrc/{src}", "replaces": replaces,
        "launches": vit["launches"]["vit_256_updates_fp32"]["K8"],
        "max_abs_err": max(vit["k8_worst"]["float32"],
                           attn_worst[("K8", "float32")]),
        **vit["k8_times"][f"float32 {shape}"],
        "shape": shape, "dtype": "float32",
        "by_shape": {**{k: v for k, v in vit["k8_times"].items()
                        if k.startswith("float32")},
                     **attn_times["K8 fp32"]},
        "launches_by_path": {
            k: v["K8"] for k, v in vit["launches"].items()}})
    # K2f's and K2b's fp32 cluster forms: their launches on the BC fit
    # (phase 22b, the 2d policy at B=64), timed at the BC batches (22a)
    bc = imitation["bc_kernels"]["times"]
    for short in ("K2f", "K2b"):
        name, src, replaces = KERNELS[short]
        t64 = bc[BC_BATCHES[0]]["kernels"][short]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"dgvit_tpu_torch/ops/csrc/{src}",
            "replaces": replaces,
            "launches": imitation["bc_fit"]["cluster_launches"][short],
            **{key: t64[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "fma_ms")},
            "batch": BC_BATCHES[0], "dtype": "float32",
            "form": "cluster_fp32",
            "by_batch": {str(b): t["kernels"][short] for b, t in bc.items()},
            "launches_by_path": {
                "bc_fit": imitation["bc_fit"]["cluster_launches"][short],
                **slice_launches(slice25, short, "float32"),
                **mesh_launches(mesh26, short, "float32")}})
    # K4's fp32 cluster form: its launches on the reference config's
    # `main` (phase 23a), timed there at the reference's batch
    ref_cfg = zoo["reference_config"]
    t4 = ref_cfg["k4_fp32"]
    name, src, replaces = KERNELS["K4"]
    rows.append({
        "name": name, "route": "cuda",
        "source": f"dgvit_tpu_torch/ops/csrc/{src}", "replaces": replaces,
        "launches": ref_cfg["k4_cluster_launches"],
        **{key: t4[key] for key in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "fma_ms")},
        "batch": ZOO_BATCH, "dtype": "float32", "form": t4["form"],
        "by_batch": t4["by_batch"],
        "launches_by_path": {
            "reference_config_main": ref_cfg["k4_cluster_launches"],
            **slice_launches(slice25, "K4", "float32"),
            **mesh_launches(mesh26, "K4", "float32")}})
    # K3f's and K3b's fp32 cluster forms: their launches on the reference
    # config's `main` (phase 23a), timed there at the reference's batch
    for short in ("K3f", "K3b"):
        t3 = ref_cfg["k3_fp32"][short]
        name, src, replaces = KERNELS[short]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"dgvit_tpu_torch/ops/csrc/{src}", "replaces": replaces,
            "launches": ref_cfg["k3_cluster_launches"][short],
            **{key: t3[key] for key in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms",
                                        "fma_ms")},
            "batch": ZOO_BATCH, "dtype": "float32", "form": t3["form"],
            "cuda_kernels": K3_FP32_KERNELS[short],
            "by_batch": t3["by_batch"],
            "launches_by_path": {
                "reference_config_main": ref_cfg["k3_cluster_launches"][short],
                "bc_fit": imitation["bc_fit"]["cluster_launches"][short],
                **slice_launches(slice25, short, "float32"),
                **mesh_launches(mesh26, short, "float32")}})
    print(f"fp32 trunk-gradient update, largest relative differences: "
          f"{json.dumps(trunk_fp32)}")
    print(f"long frames (phase 17b): {json.dumps(long_frames)}")
    print(f"fault j (phase 13a): {json.dumps(fault_j)}")
    print(f"K2b, K3b and K6 recomputes (phase 13b): {json.dumps(recompute)}")
    print(f"guided update (phase 18): {json.dumps(guided)}")
    print(f"on-device tier (phase 19, {card()}): {json.dumps(on_device)}")
    print(f"round-5 recipes (phase 20, {card()}): device PER "
          f"{json.dumps(device_per)}; {json.dumps(recipes)}")
    print(f"sensor faults (phase 21, {card()}): {json.dumps(faults)}")
    print(f"imitation tier (phase 22, {card()}): {json.dumps(imitation)}")
    print(f"model zoo (phase 23, {card()}): {json.dumps(zoo)}")
    print(f"fleet tier (phase 24, {card()}): {json.dumps(fleet)}")
    print(f"recorded-data slice (phase 25, {card()}): "
          f"{json.dumps(slice25)}")
    print(f"data-parallel tier (phase 26, {card()}): {json.dumps(mesh26)}")
    print(f"train loop rates (bf16, B={SAC_BATCH}, host clock): "
          f"{json.dumps(loop_rates)}")
    print(f"SAC updates/s (bf16, B={SAC_BATCH}, host clock): "
          f"{1 / update_s:.3f}; fp32 update, largest relative differences: "
          f"{json.dumps(sac_fp32)}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
