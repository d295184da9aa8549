#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero and prints no result line):

1. Card and build: the card's name and power limit, then every CUDA
   kernel of the ported paths built from the sources in this checkout,
   one ``nvcc`` per source, all started together, each build timed,
   with each kernel's registers and spilled bytes from ``-Xptxas -v``.
   The spawned ranks of ``[dist]`` load these builds; none compiles.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it.  Times are CUDA-event medians of 25
   launches after warm-up, with the 50 MB L2 flushed before each launch.
   The attention, fused DSGD, combine and quantize entries also
   carry ``device_ms`` (and, where there is a library call,
   ``library_device_ms``): the same calls replayed as CUDA graphs, so
   the host's time to prepare a launch drops out (at decode it exceeds
   the card's time).
   - Flash attention, at serving (full-width gemma3-1b: B=4, prompt
     1024, 64 new tokens) and training (B=2, Tq=S=1024) shapes, in bf16
     and f32, plus a ragged and a softcap case, element by element:
     |kernel - plain| <= 1e-4, plus 2^-7 |plain| in bf16 (one bf16
     rounding step, as each side rounds its f32 result).  Each case
     prints its grid and key-axis split.  The row contract at the
     serving shapes, bit for bit in bf16 and f32, local and global: a
     5-row verify window with per-batch q_start equals 5 one-row calls,
     and a decode row split over 2 to 17 blocks (and the wrapper's own
     choice) equals kv_splits=1.  Through ``ops.sdpa_decode`` at the
     fixed-batch verify positions (1024, 1041, 1064, 1087 in a cache of
     1092), the 5-row verify equals the direct call and 5 one-row calls
     bit for bit, and its timed entry (local and global, with NaN past
     each request's k_valid) reports ``[spec]``'s launches.
     ``library_ms`` times PyTorch's ``scaled_dot_product_attention`` on
     the same inputs as a yardstick; the port never calls it.
   - Fused DSGD-momentum, at the training path's leaf shapes (the
     node-stacked embedding, MLP gate, ``wq`` and a norm scale), in
     bf16 and f32, with per-row and scalar pre-scales, plus a ragged
     case and a bf16 case above 2^31 elements: bit for bit.  No single
     PyTorch call computes the same function (``torch._fused_sgd_`` has
     no per-row pre-scale), so its ``library_ms`` is null.  Then the
     grouped launch (``fused_dsgd_many``) over all 340 gemma3-1b leaves
     at n = 3 in bf16, per-row, scalar and unit pre-scales, and over a
     ragged list (f32 and bf16, an empty and an unaligned leaf), bit for
     bit leaf by leaf; timed at per-row and unit pre (``device_ms`` as a
     CUDA graph), with ``torch._fused_sgd_`` (dampening 0, no weight
     decay) as the unit entry's ``library_ms`` and its max abs
     difference from the kernel beside it.
   - Quantize + EF21 residual (``[quantize]``), at the compressed
     training path's chunk-row shapes (the embedding and three stacked
     reference leaves, each node's four blocks back to back, as (rows,
     256) f32), int8 and fp8, with and without err, plus rows that are
     not a multiple of a block's, C in {2, 32, 250}, all-zero rows, an
     element index across 2^31 and one across 2^32, and fp8 entries in
     e4m3's subnormal range: q, scale and the residual bit for bit.  No
     PyTorch call computes hash stochastic rounding with a residual, so
     its ``library_ms`` is null.  Then the grouped launch
     (``quantize_ef_many``) over a ragged list (C in {2, 6, 250, 256,
     1024}, unaligned buffers, row offsets whose indices pass 2^32; with
     err, without and mixed), a list longer than one table, and all 106
     gemma3-1b reference leaves as one rank's chunk rows (rank 1's row
     offsets; 1.0 B elements) and as the simulation's 3 nodes (3.0 B),
     int8 with err, bit for bit leaf by leaf, timed (``device_ms`` as a
     CUDA graph) against the plain loop.
   - The gossip combines (``[gossip-mix]``): both entry points of the
     slots combine at one rank's f32 work-buffer shapes (the embedding,
     an MLP gate, a norm scale), f32 and bf16, 1 to 3 slots with the
     last one zeros at weight 0, and the quantized combine at the same
     leaves' chunk rows, int8 and fp8, 1 to 3 payloads, plus every
     payload byte value: bit for bit.  ``library_ms`` times
     ``torch.tensordot(w, stack, dims=1)`` for the slots combine; no
     PyTorch call dequantizes and combines, so the quantized combine's
     is null.  Then the grouped combine (``gossip_mix_slots_many``) over
     one rank's 340 f32 work buffers of gemma3-1b, S = 2, with f32 and
     bf16 outputs, and over a ragged list, bit for bit tensor by tensor;
     timed (``device_ms`` as a CUDA graph) against the per-tensor
     ``tensordot`` loop.  And the grouped quantized combine
     (``quantized_gossip_mix_many``) over a ragged list (C in {2, 6, 128,
     250, 256, 384, 1024}, unaligned buffers, every payload byte, 0 to 3
     and 31 payloads), a list longer than one table, and one rank's 106
     reference leaves with one payload each (S = 1), int8 and fp8, bit for
     bit, timed against the plain loop.
   - Paged flash attention (``[paged]``), at the continuous serving
     path's shapes (8 slots with ragged positions, page size 16, 553
     pages of one kv head of 256, block table 8 x 69), decode (Tq = 1)
     and verify (Tq = 5) rows, local and global layers, plus page sizes
     8, 32 and 64, in bf16 and f32, with NaN in scratch page 0 and in
     every page no slot names: within flash attention's tolerance of the
     plain version.  The verify window equals five one-row calls bit for
     bit; at page size 16 the wrapper's split and splits 2, 9, 17 equal
     kv_splits=1, and a decode row equals the dense kernel's over the
     gathered pages, bit for bit.  ``library_ms`` times
     ``scaled_dot_product_attention`` on the already-gathered dense view
     (no PyTorch call takes a block table).
   - Both attention kernels at the dense zoo's shapes (``[zoo-kernels]``),
     each arch's head layout from its config: granite-8b (32 q / 8 kv
     heads of 128) and qwen1.5-4b (20 / 20 of 128, MHA) at B=4 prompts
     of 1024 with 32 new tokens, gemma2-2b (8 / 4 of 256, softcap 50,
     local window 4096) at 4608-token prompts and its training forward
     (B=2, Tq=S=1024): prefill and last-step decode per layer kind,
     within the tolerance above, each decode row's chosen split equal to
     kv_splits=1 bit for bit; and the paged kernel at granite-8b's
     continuous decode (8 slots, page 16).  Where the case has a
     softcap SDPA computes another function: ``library_ms`` is null and
     SDPA without the softcap stands beside it.
   - Row 1 at the MoE family's shapes (``[moe-kernels]``): grok-1-314b
     (48 q / 8 kv heads of 128, 6 per kv head, softcap 30) and
     deepseek-v3-671b (MLA's latent expanded to 128 heads of (192, 128),
     MHA, the explicit scale 192 ** -0.5) at B=4 prompts of 1024 with 32
     new tokens, prefill and last-step decode, within the tolerance
     above, each decode row's chosen split equal to kv_splits=1 bit for
     bit; the head dims the kernel is not instantiated for, (48, 32)
     (reduced MLA) and (64, 32) (the reference's MLA tests), through the
     wrapper's zero padding at B=2, Tq=S=1024, 4 heads, each reporting
     the launches the wrapper counted under its pair over every path run
     below (no ported path runs (64, 32), and its 0 is read, not set);
     row 2 at grok-1-314b's continuous decode (8 slots, page 16,
     softcap 30).
   - Row 1 at jamba-1.5-large-398b's attention layer
     (``[hybrid-kernels]``: 64 q / 8 kv heads of 128) at B=4 prompts of
     1024 with 32 new tokens, prefill and last-step decode, as above.
   - Row 1 at llava-next-34b's attention (``[vlm-kernels]``: 56 q / 8 kv
     heads of 128, 7 per kv head): B=4 prefill of the 2880 patch
     embeddings and a 1024-token prompt (3904 rows) in a cache of 3936,
     and decode at 3934; and at seamless-m4t-large-v2's
     (``[encdec-kernels]``: 16 heads of 64, MHA, B=4) without the causal
     mask: the encoder (Tq = S = 1024), the cross-attention's prefill (64
     rows against 1024) and decode (1 against 1024, split == unsplit
     bitwise), a call whose 2048 queries outnumber its 1024 keys (q0 =
     -1024, on no path: its entry reads 0 launches), and the decoder's
     causal self-attention at 64 + 32.  SDPA runs non-causal, without a
     mask, where the case is non-causal.
3. Serving: full-width gemma3-1b in bf16 (random weights from a seed),
   ``make_engine(batch=4, prompt_len=1024, max_new=64)``, one warm-up
   generation, then one timed greedy generation whose kernel launches
   are counted (26 layers x 64 model passes); then prefill and the 63
   decode steps each alone, timed, their launches counted apart.
   ``[spec]``: the same cell through the fixed-batch engine with
   ``speculate_k=4``, self-speculative (a draft of 2 of 4 pattern
   blocks, 14 layers) and with a 1-block draft model of gemma3-1b's
   widths (8 layers, random weights from seed 2), beside the plain
   engine: after a warm-up, three timed generations of each, in turn,
   the flash kernel's launches asserted in every one (26 + rounds x 82;
   26 + 8 + rounds x 66; 26 x 64) with no plain attention or SDPA call;
   acceptance, tokens per round, passes per token, peak memory, each
   round split by CUDA events (snapshot, drafts, verify, accept and
   restore), and the tokens against ``[main]``'s; then a 5-row verify
   against 5 one-row steps from the prompt's state, layer by layer, to
   tell the products' rounding from the kernel's.
   ``[continuous]``: the continuous-batching engine over a paged cache,
   the same weights: a seeded Poisson trace of 32 requests (rate 0.5,
   prompts 64-1024 tokens) through 8 slots, page size 16, 64 greedy
   tokens each; the paged kernel's launches counted (26 per decode
   step), decode and prefill timed by CUDA events.
   ``[continuous-spec]``: its first 16 requests with self-speculative
   decoding (k = 4, a draft of 2 of 4 pattern blocks, prefill batch 2).
   ``[zoo-serve]``: granite-8b (36 layers), qwen1.5-4b (40) and
   gemma2-2b (26, prompts of 4608 so that its 4096-token window binds)
   at full width and depth in bf16, random weights from a seed, each
   through ``make_engine(batch=4, max_new=32)``: a warm-up generation,
   then a timed one (layers x 32 flash launches asserted, with no plain
   attention or SDPA call), then prefill and the decode steps alone;
   prefill ms, decode ms/step, tokens/s and peak memory.  Each model is
   freed before the next.  ``[zoo-continuous]``: granite-8b through the
   continuous engine, 16 requests (prompts 64-1024), 8 slots, page 16,
   32 tokens each, 36 paged launches per decode step asserted.
   ``[moe-serve]``: the MoE family at full width, depth cut to fit the
   card (``dataclasses.replace(cfg, num_blocks=...)``): grok-1-314b with
   4 of its 64 blocks (20.49 B params, 40.97 GB) and deepseek-v3-671b
   with its 3 dense prologue layers and 2 of its 58 MoE blocks (27.20 B
   params with the MTP layer, 54.40 GB), random bf16 weights from seed
   0, the ``[zoo-serve]`` traffic at prompts of 1024: 4 x 32 = 128 and
   5 x 32 = 160 flash launches per generation asserted, no plain or SDPA
   call, the engine's tokens equal to the phases' alone, and MoE-aware
   floors (decode by the bytes a step reads, every expert at C = 1;
   prefill by the E x C expert products).  ``[moe-continuous]``:
   grok-1-314b through the continuous engine with the
   ``[zoo-continuous]`` traffic, 4 paged launches per decode step.
   ``[ssm-serve]``: mamba2-2.7b at full width and depth (2.70 B params),
   the ``[moe-serve]`` traffic, no flash launch and no plain or SDPA
   call; ``[hybrid-serve]``: jamba-1.5-large-398b at full width with its
   pattern cut to its first 5 layers as one block (4 Mamba layers, 2 of
   them with MoE, and the attention layer: 23.45 B params; one whole
   8-layer block is 88.1 GB), 32 flash launches per generation.  Their
   decode floors add each Mamba layer's state, read and written once a
   step.
   ``[vlm-serve]``: llava-next-34b at full width and depth (34.39 B
   params, 68.78 GB; the depth is cut, and the cut printed, only if the
   free memory cannot hold its weights, its cache and 5 GiB of
   transients) through ``make_engine(prefix_len=2880)``: B=4 prompts of
   1024 tokens after 2880 stub patch embeddings, 32 greedy tokens, 60 x
   32 = 1,920 flash launches per generation.  ``[encdec-serve]``:
   seamless-m4t-large-v2 at full width and depth (1.77 B) over 1024 stub
   audio frames, prompts of 64 tokens, 24 + 48 x 32 = 1,560 launches (the
   encoder once, then each decoder layer's self- and cross-attention).
   Both with no plain or SDPA call; their floors count the K/V cache a
   decode step reads, and seamless's the encoder and the cross K/V
   projections over the frames (recomputed every decode step).
4. Training: full-width gemma3-1b in bf16 as n = 3 nodes on the Base-2
   graph, DSGD-momentum (0.9, eta 0.01) through ``simulate_decentralized``,
   2 sequences of 1024 tokens per node; one warm-up step, then 6 timed
   steps (two periods of the schedule) whose launches are counted (one
   grouped fused update per step over all 340 parameter tensors and
   26 x 3 flash forwards per step) and whose steps are split by CUDA
   events into forward+backward, update and mix.
   ``[train-compress]``: the same with int8 compressed gossip (chunk
   256, error feedback, seed 0), after one warm-up step, 6 timed steps
   whose launches are counted (one grouped quantize+EF per bucket of at
   most 256 MiB of the reference leaves' f32 chunk rows, 29 over the 106
   leaves, one grouped fused update and 26 x 3 flash forwards per step),
   split into
   forward+backward, update and compressed mix, with the peak memory and
   the wire bytes per node per round against f32.
   ``[zoo-train]``: gemma2-2b (2.61 B params) at full width and depth
   in bf16 as n = 2 nodes on Base-2, the ``[train]`` method and batch,
   3 timed steps: ms/step, the split, peak memory; 26 x 2 flash launches
   and one grouped fused update per step asserted.  ``[moe-train]``:
   grok-1-314b and deepseek-v3-671b at ``reduced()`` in bf16 as n = 3
   nodes on Base-2, the ``[train]`` method and batch, 3 steps: one
   grouped fused update and (layers + MTP) x 3 flash launches per step
   asserted (deepseek's attention at (48, 32) through ``ops.sdpa``'s
   padding).  ``[ssm-train]``: mamba2-2.7b at full width in bf16 as n =
   2 nodes, each pattern block checkpointed (``remat=True``), 3 steps:
   one grouped fused update per step and no flash launch;
   ``[hybrid-train]``: jamba-1.5-large-398b at ``reduced()`` as n = 3, 3
   steps, one grouped update and 3 flash launches per step.
   ``[encdec-train]``: seamless-m4t-large-v2 at full width as n = 2
   nodes on Base-2, the ``[train]`` batch over 1024 stub frames per
   sequence, 3 steps: 2 grouped updates per step (555 tensors fill two
   tables) and 72 flash launches per node forward (the encoder's 24, the
   decoder's 24 self- and 24 cross-attention calls); ``[vlm-train]``:
   llava-next-34b ``reduced()`` with a 16-patch prefix, n = 3.
   ``[remat]``: one
   gemma2-2b node's ``loss_fn`` gradients with ``remat=True`` against
   ``remat=False`` on the card, per gradient max |diff| / max |plain|
   <= 1e-6, with both peaks and both flash counts (26, and 52 with the
   recomputed blocks).
   ``[dist]``: the same training across processes: 3 ranks of one node
   each (``launch.distributed.spawn_local``, gloo, each message staged
   through pinned host memory, all on this card), each through the
   launcher's per-rank entry ``launch.train.train_rank`` for 3 steps,
   its kernel counters set to 0 just before and read just after (13
   grouped combines, one per bucket of at most 256 MiB of f32 work
   buffers, over the 340 tensors; one grouped fused update; 50 flash
   forwards per rank per step, asserted: the step checkpoints each
   pattern block by default, so the backward runs the 24 block layers'
   forward again), and each rank's peak memory
   held under the per-tensor mixer's 18.73 GiB plus (S + 1) buckets.
   The simulation engine on the same parameters and batches, run first,
   is the oracle: step 0's per-node losses equal, later ones within
   1e-2; every parameter element within 2^-5 |sim| + 2^-1 max|sim -
   init| of its tensor; the bytes each rank sent equal
   the plan's messages times the f32 tree.  Split per step into
   forward+backward, update, exchange and combine, with each rank's
   peak memory.  ``[dist-compress]``: the same with int8 + EF (14
   grouped quantizes and 14 grouped quantized combines per rank per
   step, one per 256 MiB bucket of the 106 reference leaves' chunk
   rows), step 0's payloads equal to the simulation's rows of the node
   (sha256 of each leaf's q and scales), the EF residuals within 2^-5
   |sim| + 2^-1 max|sim| of their tensor, and each rank's peak memory
   under the leaf-by-leaf mixer's 22.49 GiB plus (3.25 + S / 4)
   buckets.  Each rank also leaves sha256 digests of its parameters and
   method state.
   ``[dist-overlap]``: the ``[dist]`` cell with ``overlap=True``
   (``dist.steps``: update and gossip group by group, 7 groups of
   gemma3-1b): losses, the digests of parameters and momentum and the
   bytes and messages sent equal ``[dist]``'s bit for bit; ms/step beside
   ``[dist]``'s, and the fused-update and combine launches per rank per
   step asserted (one grouped fused launch per group, one grouped
   combine per bucket of a group); then one more step, whose loss
   ``[ckpt]``'s fourth step must equal.
   ``[ckpt]``: the ``[dist]`` cell through ``train_rank`` for 6 steps
   with ``ckpt_dir`` and ``ckpt_every=2``: ``latest`` saved
   asynchronously after steps 2 and 4 (one shard file per rank, the
   reference's keys and shapes in 3 per-rank manifests), step 5 running
   while the last save is written, the node-mean ``ckpt`` after the run;
   its losses of steps 0-2 equal ``[dist]``'s and of step 3
   ``[dist-overlap]``'s fourth.  A second spawn of 3 ranks loads
   ``latest`` (step 4) into fresh (1, ...) templates and takes step 5:
   parameters, momentum and loss equal the saving run's bit for bit.
   The same on ``reduced()`` gemma3-1b with int8 + EF over 4 steps (a
   save after step 2; ``ct`` and the f32 residuals restored): the
   resumed step's parameters, state and payloads (sha256 of each leaf's
   q and scales) equal an uninterrupted run's.  Bytes written, the step
   thread's ms in ``save()`` (and whether the save allocated its pinned
   buffer), the writer's seconds and the load's seconds per rank; files
   under ``build/chip_smoke_ckpt/``, removed at the end; a disk without
   room for them fails the phase.
   ``[failure]``: the ``[train]`` cell through the failure engine, 3
   steps per run: ``FailureModel()`` equals ``failure=None`` bit for bit
   (losses, every parameter, clocks 3); then drop 0.25, delay 2, churn
   0.1 and Byzantine sign-flip 0.3 at once (seed 7): ms/step, each step
   split by CUDA events (forward+backward with the draws and the churn
   reset; update; the mixer's stale reads, corrupt reads and products;
   the node freeze and history write), peak memory, clocks and the
   honest losses, with one grouped fused update (unit pre-scale) and
   26 x 3 flash forwards per step asserted.
   ``[sweep]``: the reference's robustness grid (its constants copied
   from ``benchmarks/failure.py:48-62``): the paper MLP 32-64-10, n = 16,
   Dirichlet alpha 0.3, topologies base k=1 and k=4, one_peer_exp, exp
   and ring, DSGD-momentum (eta 0.05, batch 32), 60 steps (the grid's
   120 cut to half, so that the script fits its time limit), as one
   sweep synchronously and one per regime (clean, drop 0.1 and 0.3,
   delay 3, churn 0.03, Byzantine sign-flip 0.125): one grouped fused
   launch per step per sweep asserted (60, not 300); the clean cells
   equal the synchronous sweep's, the synchronous and drop0.1 cells
   equal their independent runs, bit for bit; clocks equal across
   configs; the accuracy table printed beside
   ``benchmarks/baselines/BENCH_failure.json``'s 120-step accuracies
   (no gate: other weights and half the steps, and the reference calls
   those cross-BLAS-sensitive).  Then a
   compressed sweep (int8 + EF, plain DSGD, base k=1 / exp / ring x 2
   seeds, 30 steps): one grouped quantize per step per bucket asserted,
   every cell equal to its independent run bit for bit.  The fused DSGD
   and quantize kernels at the sweeps' shapes: one launch over every
   copy equal to the plain version and to per-copy launches bit for
   bit, timed against both.
   ``[tp-serve]``: tensor-parallel serving on four gloo ranks sharing
   the card as a (data 2, model 2) mesh (``launch.mesh.make_host_mesh``):
   full-width gemma3-1b (26 layers, d 1152, vocab 262144; bf16 weights
   drawn on the CPU from seed 0), B = 4 prompts of 1024 tokens
   (``[main]``'s), 32 greedy tokens.  Each rank draws the whole model on the
   CPU, keeps its shard under the serve rules
   (``convert.shard_for_rank``: every matrix's last dim on "model", so
   half of the weights) and moves only
   that to the card; its rows of the batch (2 of 4, split over "data")
   go through ``make_engine(mesh=)``, then prefill and each decode step
   alone through ``dist.steps.make_prefill`` / ``make_decode_step``,
   timed by CUDA events (medians of 3 prefills and of the 31 steps).
   Held against a one-rank engine on the same weights and prompts in
   this process: the prefill and first decode step's logits within
   2^-5 max|one-rank| (bf16 products whose shapes differ from the
   one-rank's, and the tied head's partial logits added in f32), and the
   greedy tokens equal, except that a row may part from the one-rank
   tokens at a step whose one-rank top-2 logit margin is within twice
   that tolerance (a near-tie the tolerance allows; printed).  The flash
   kernel's counter shows 26 launches per prefill and per decode step
   on every rank, each rank's parameter bytes equal the table's share
   (``dist.tp.shard_bytes``), and the ranks' gathers and bytes per
   decode step, prefill ms, decode ms/step and peak memory are printed.
   The same for reduced grok-1-314b in f32 (the 2-D rule: contraction
   dims on "data" too, the batch whole on every rank, the experts
   gathered whole), its logits within 1e-4 and its tokens equal.  Row
   1's entries at a rank's shapes (B = 2) report ``[tp-serve]``'s
   gemma3-1b launches over the four ranks.
   ``[tp-train]``: the tensor-parallel trainer in the same spawns, after
   the serve checks, from the same shards (the train rules cut
   gemma3-1b as the serve rules do): ``dist.steps.make_train_step(
   mesh=)``, the two data coordinates as two nodes on Base-2 (k = 1),
   DSGD-momentum 0.9, eta 0.01, remat on, 1 x 1024 tokens a node
   (``token_batches``), 2 steps.  Per rank and step: ms (CUDA events,
   split by the trace marks), the launches of rows 1, 3 and 5 (each
   above 0 on every rank at every step), the gathers and bytes received
   forward and in the backward, the gossip bytes sent, peak memory.  A
   node's loss and replicated tensors (norm scales) are bit-equal on its
   two model ranks at every step.  Then the node's shards meet on its
   model-coordinate-0 rank (``convert.unshard_ranks``), which runs the
   one-model-rank trainer over ``mesh.group("data")`` from the same draw
   on the same batches: losses within 2^-7 relative, the parameters
   after step 2 elementwise within 2^-5 |p| plus half the tensor's
   largest move (``TP_*`` constants).  Reduced grok-1-314b in f32 beside
   it, under the 2-D rule (one node, its 2 rows split over "data", the
   experts routing the node's whole batch): step 0's loss and gradients
   within 1e-4 of ``models.model.loss_fn`` on the whole model and batch,
   and 2 steps within 1e-4 of the method's update with no mixing.
   ``[tp-spec]``: in the same spawns, after the gemma3-1b serve checks:
   ``make_engine(mesh=, speculate_k=4, draft_cfg=)`` with ``[spec]``'s
   1-block draft model of gemma3-1b (bf16, seed 2, drawn on the CPU and
   sharded under its own serve rules), 16 greedy tokens of each rank's
   rows.  Held against the one-rank engine with the same draft in this
   process: the tokens equal (a row may part from them only at a
   near-tie, as in ``[tp-serve]``, and then its ``SpecStats`` are not
   compared) and, where they are, the rows' ``SpecStats`` equal.  Per
   rank: flash launches, equal to 26 + 8 for the prefills and 5 x 8 +
   26 per round, the round count, ms per round (CUDA events), and the
   gathers of one draft step and of one verify (k + 1 rows) alone.
   ``[dryrun]``, on the host:
   ``launch.dryrun.dry_cell`` of gemma3-1b on each of the four ranks'
   coordinates of a dry (data 2, model 2) mesh, the meta device, at
   ``[tp-serve]``'s decode step and ``[tp-train]``'s step: its gathers
   and bytes (forward and backward), parameter bytes and gossip bytes
   equal what those phases counted on every rank; and ``python -m
   repro_torch.launch.dryrun --all --mesh single --jobs 6``, in a
   subprocess that sees no card, at the lowest CPU priority (``nice -n
   19``), started before ``[sweep]`` (whose launches take one core of
   the eight) and waited for at the end: every cell of the production
   sweep ``ok`` or ``skipped``, each printed.  ``[smoke-mp]`` and
   ``[examples]`` run after ``[sweep]``, beside the phases of items 5
   and 6 (which time nothing: their four subprocesses start first, the
   four ranks' dry cells and those phases run here meanwhile).
   ``[smoke-mp]``:
   ``scripts/launch_multiprocess_torch.sh -p 2`` (the bring-up smoke,
   each process on the card, an all_reduce over both): exit 0 and two
   ``SMOKE_OK`` lines.  ``[examples]``: the three
   ``examples/*_torch.py`` on the card at their small settings, each a
   subprocess that must exit 0 (``quickstart_torch.py --steps 60``,
   ``serve_batched_torch.py``: 8 gloo ranks as (4, 2), every row equal
   to the one-rank engine's; ``train_decentralized_torch.py --preset
   tiny --steps 20``: its loss falls).
5. The port on the card against the port on the CPU: reduced gemma3-1b
   serving in f32 (greedy tokens equal, prefill logits within 1e-4);
   ``[moe-cpu-vs-card]``: reduced grok-1-314b and deepseek-v3-671b in
   f32, prefill and 4 decode steps' logits and ``loss_fn`` with the aux
   (and MTP) terms within 1e-4; ``[ssm-cpu-vs-card]``: the same for
   reduced mamba2-2.7b and jamba-1.5-large-398b (the chunked scan in
   prefill, the recurrent step in decode); ``[encdec-cpu-vs-card]``: the
   same for reduced llava-next-34b after 16 stub prefix embeddings and
   reduced seamless-m4t-large-v2 over 16 stub frames; the
   five methods on the paper MLP (losses within 1e-5) and reduced
   gemma3-1b DSGD-momentum training (losses within 1e-4).
   ``[compress-cpu-vs-card]``: ``compressed_dense_mix`` with every codec
   on a reduced gemma3-1b tree (n = 3): payloads and residuals bit for
   bit, mixed values within 1e-5 (f32 products summed in another
   order); 20 steps of compressed DSGD on the paper MLP (n = 21, Base-3)
   with int8, fp8, int4 and top-k: losses within 1e-3, DESIGN.md Sec.
   13's compressed end-to-end tolerance.
   ``[continuous-cpu-vs-card]``: the continuous engine on reduced
   gemma3-1b in f32 over a short trace, plain and with speculate_k = 2:
   greedy tokens and statistics equal on the CPU and the card.
   ``[spec-cpu-vs-card]``: the fixed-batch engine on reduced gemma3-1b
   (2 blocks) in f32 with speculate_k = 2, self-speculative and with a
   1-block draft model: tokens and SpecStats equal on the CPU and the
   card, speculative tokens equal to plain ones on the card.
   ``[failure-cpu-vs-card]``: the paper MLP (n = 8, Base-3, dsgdm, 30
   steps) under dropout, stragglers, delay, churn, each Byzantine mode
   and all four behaviours at once, on the CPU and on the card: losses
   within 1e-5 (relative above 1), clocks and every round's draws
   equal.
6. Consensus on the card: ``optim.mix`` over one period of Base-2 at
   n = 3 and Base-3 at n = 21 reaches a relative consensus error
   <= 1e-10; the ring's after as many rounds is printed beside it.
7. ``--profile`` only: profiler traces of one decode step, one
   continuous (paged) decode step, one self-speculative generation of
   ``[spec]`` (per round) and one training step, kernel time by name
   (what bounds a step).

``[seconds]`` lines give each group of phases' seconds.  The line
before the last is a JSON object with one entry per kernel and
main-path shape; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses
import gc
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core bf16
              "float32": 67e12}     # f32 outside the tensor cores

# gemma3-1b serving path (src/repro_torch/configs/gemma3_1b.py)
BATCH, PROMPT, NEW = 4, 1024, 64
SEQ = PROMPT + NEW
# the fixed-batch speculative path on the same cell: k = 4 drafts per
# round, a self-speculative draft of 2 of the 4 pattern blocks; its cache
# holds k rows more, and its verify windows sit at per-request positions
SPEC_K, SPEC_DRAFT = 4, 2
SPEC_SEQ = SEQ + SPEC_K                                         # 1092
SPEC_STARTS = (PROMPT, PROMPT + 17, PROMPT + 40, SPEC_SEQ - SPEC_K - 1)
SPEC_REPS = 3       # timed generations per engine, taken in turn
HEADS, KV_HEADS, HEAD_DIM, LOCAL_WINDOW = 4, 1, 256, 512
# gemma3-1b training path: n nodes x B sequences of T tokens per step
TRAIN_N, TRAIN_B, TRAIN_SEQ, TRAIN_STEPS = 3, 2, 1024, 6
TRAIN_ETA, TRAIN_MOMENTUM = 0.01, 0.9
# the training path's (R, C) views of its leaves, R = nodes
# (embed 262144 x 1152, MLP gate 1152 x 6912, wq 1152 x 1024, a norm scale)
DSGD_SHAPES = (("embed", (TRAIN_N, 262144 * 1152)),
               ("mlp.gate", (TRAIN_N, 1152 * 6912)),
               ("attn.wq", (TRAIN_N, 1152 * 1024)),
               ("norm", (TRAIN_N, 1152)))
DSGD_RAGGED = (257, 513)
DSGD_ABOVE_2_31 = (2, (1 << 30) + 3)     # bf16, ~21 GB over five tensors
DSGD_SLICE = 1 << 27                     # columns per plain-version slice
# the compressed training path: int8 payloads in (rows, 256) chunk rows,
# one payload per reference leaf (the embedding, or one pattern
# position's tensor stacked over the 4 blocks), rows = nodes x
# ceil(per-node leaf size / 256)
COMPRESS_CODEC, CHUNK = "int8", 256
QUANT_SHAPES = tuple(
    (name, (-(-blocks * cols // CHUNK) * rows, CHUNK))
    for (name, (rows, cols)), blocks in zip(DSGD_SHAPES, (1, 4, 4, 4)))
# the dense zoo's serving paths: B = 4 prompts of 1024 random tokens
# (gemma2-2b: 4608, past its 4096-token window), 32 greedy tokens; the
# continuous path of granite-8b: 16 requests of 64-1024 tokens, 8 slots,
# page 16, 32 tokens each; gemma2-2b trained at full width as n = 2 nodes
# on Base-2, 3 steps of the [train] batch (2 x 1024 tokens per node)
ZOO_BATCH, ZOO_NEW = 4, 32
ZOO_PROMPTS = {"granite-8b": 1024, "qwen1.5-4b": 1024, "gemma2-2b": 4608}
ZOO_CONT_ARCH, ZOO_CONT_REQUESTS = "granite-8b", 16
ZOO_TRAIN_ARCH, ZOO_TRAIN_N, ZOO_TRAIN_STEPS = "gemma2-2b", 2, 3
REMAT_TOL = 1e-6      # max |remat - plain| / max |plain| per gradient
# the MoE family served at full width, depth cut to fit 80 GB: grok-1-314b
# 4 of its 64 blocks (20.49 B params), deepseek-v3-671b its 3 dense
# prologue layers and 2 of its 58 MoE blocks (27.20 B params with the MTP
# layer), B = 4 prompts of 1024 tokens, 32 greedy tokens; grok through
# the continuous engine with the [zoo-continuous] traffic; both trained at
# reduced() as n = 3 nodes on Base-2 (full width does not fit one card at
# any depth for n >= 2)
MOE_BLOCKS = {"grok-1-314b": 4, "deepseek-v3-671b": 2}
MOE_PROMPT, MOE_CONT_ARCH = 1024, "grok-1-314b"
MOE_TRAIN_N, MOE_TRAIN_STEPS = 3, 3
# the SSM family: mamba2-2.7b served at full width and depth (2.70 B
# params) and trained at full width as n = 2 nodes on Base-2 with each
# pattern block checkpointed (a Mamba layer keeps ~1 GB of activations
# for 2 x 1024 tokens, 64 layers); jamba-1.5-large-398b served at full
# width with its pattern cut to the first 5 layers as one block (mamba /
# dense, mamba / MoE, mamba / dense, mamba / MoE, attn / dense: 22.91 B
# params; one whole 8-layer block is 44.06 B, 88.1 GB in bf16), the
# [moe-serve] traffic, and trained at reduced() as n = 3 nodes
SSM_ARCH, HYBRID_ARCH, HYBRID_CUT = "mamba2-2.7b", "jamba-1.5-large-398b", 5
SSM_TRAIN_N, HYBRID_TRAIN_N, SSM_TRAIN_STEPS = 2, 3, 3
# the last two archs, at full width and depth: llava-next-34b (34.39 B
# params, 68.78 GB in bf16) serves B = 4 prompts of 1024 tokens after
# its 2880 stub patch embeddings (index0 3904, a cache of 3936), and
# trains at reduced() with a 16-patch prefix as n = 3 nodes;
# seamless-m4t-large-v2 (1.77 B) serves B = 4 prompts of 64 tokens over
# 1024 stub audio frames, and trains at full width as n = 2 nodes on
# Base-2 (the [train] batch: 2 x 1024 tokens per node, over 1024 frames
# each); 32 greedy tokens each; the stubs' stream starts at STUB_SEED
VLM_ARCH, ENCDEC_ARCH = "llava-next-34b", "seamless-m4t-large-v2"
VLM_PATCHES, VLM_PROMPT = 2880, 1024
ENCDEC_FRAMES, ENCDEC_PROMPT = 1024, 64
VLM_TRAIN_N, VLM_TRAIN_PATCHES, ENCDEC_TRAIN_N = 3, 16, 2
STUB_SEED = 1 << 20
FIT_MARGIN = 5 << 30      # transients of llava's prefill (~2.3 GiB), kept
# the padded head-dim pairs: reduced MLA's, and the reference's MLA tests'
# (tests/test_decode_attention.py:37), which no ported path runs; each
# entry reports the launches counted under its pair over the path runs
MOE_PADDED = ((48, 32), (64, 32))
# the continuous serving path: 8 slots, pages of 16 positions, prompts up
# to 1024 tokens, 64 new tokens, room for a 4-token speculative window
CONT_SLOTS, CONT_PAGE, CONT_NEW, CONT_K, CONT_DRAFT = 8, 16, 64, 4, 2
CONT_REQUESTS, CONT_RATE, CONT_SPEC_REQUESTS = 32, 0.5, 16
CONT_MIN_PROMPT = 64
CONT_MAXP = -(-(PROMPT + CONT_NEW + CONT_K) // CONT_PAGE)      # 69 pages
# the distributed path: the [train] cell split over TRAIN_N processes,
# one node each, sharing the card through gloo
DIST_STEPS, DIST_TIMEOUT, DIST_LOSS_TOL = 3, 600.0, 1e-2
DIST_CHECK_SLICE = 1 << 24     # elements per slice of [dist]'s check
# [ckpt]: where its files go, the room they take (3 ranks x 4.0 GB of
# params + momentum twice while a save swaps in, the 2.0 GB mean); the
# saving run's steps and save period (saves after steps 2 and 4, the last
# step resumed) and the reduced compressed run's steps (a save after step
# 2, step 3 resumed)
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
CKPT_DISK = 28 << 30
CKPT_STEPS, CKPT_EVERY, CKPT_C_STEPS = 6, 2, 4
DIST_PEAK_GIB = 18.73     # peak per rank of the per-tensor mixer, measured
# peak per rank of the leaf-by-leaf compressed mixer (int8 + EF: the 4 GB
# of f32 residuals besides), measured on the H100 before the buckets
DIST_COMPRESS_PEAK_GIB = 22.49
# one rank's (R, C) views of its f32 work buffers (ops._as_2d of the
# (1, ...) tensors) and the same reference leaves' chunk rows (one node's
# blocks back to back: the embedding, 4 MLP gates, 4 norm scales)
GOSSIP_SHAPES = (("embed", (262144, 1152)), ("mlp.gate", (1152, 6912)),
                 ("norm", (1, 1152)))
QMIX_SHAPES = tuple((name, (-(-blocks * r * c // CHUNK), CHUNK))
                    for (name, (r, c)), blocks in zip(GOSSIP_SHAPES,
                                                      (1, 4, 4)))
QUANT_EDGES = (  # (name, (R, C), row_offset, case)
    ("ragged rows", (1001, 256), 7, None),
    ("C=2", (13, 2), 0, None), ("C=32", (9, 32), 0, None),
    ("C=250", (21, 250), 3, None),
    ("zero rows", (24, 256), 0, "zero-rows"),
    ("index across 2^31", (64, 256), (1 << 23) - 32, None),
    ("index across 2^32", (64, 256), (1 << 24) - 32, None),
    ("fp8 subnormal tail", (40, 256), 0, "subnormal"))

# the failure-realistic path on the [train] cell: 3 steps per run, and the
# regime that turns on all four behaviours at once
FAIL_STEPS = 3
FAIL_REGIME = dict(drop_rate=0.25, delay=2, churn_rate=0.1,
                   byzantine_frac=0.3, byzantine_mode="sign_flip", seed=7)
# the sweep path: the grid of the reference's robustness table
# (benchmarks/failure.py:48-62, copied: the benchmark folder is not
# imported), the paper MLP 32-64-10 at n = 16 on Dirichlet(0.3) data;
# depth cut from the grid's 120 steps to 60 (each sweep's steps are
# host-bound: 80 per-copy backward passes a step)
SWEEP_N, SWEEP_STEPS, SWEEP_ETA, SWEEP_BATCH = 16, 60, 0.05, 32
SWEEP_TOPOS = (("base", 1), ("base", 4), ("one_peer_exp", None),
               ("exp", None), ("ring", None))
SWEEP_REGIMES = (
    ("clean", {}),
    ("drop0.1", dict(drop_rate=0.1, seed=11)),
    ("drop0.3", dict(drop_rate=0.3, seed=11)),
    ("delay3", dict(delay=3, seed=11)),
    ("churn0.03", dict(churn_rate=0.03, seed=11)),
    ("byz_signflip", dict(byzantine_frac=0.125, byzantine_mode="sign_flip",
                          seed=11)),
)
# the compressed sweep: int8 + EF, plain DSGD, 3 topologies x 2 seeds
CSWEEP_TOPOS = (("base", 1), ("exp", None), ("ring", None))
CSWEEP_SEEDS, CSWEEP_STEPS = (0, 1), 30


class PhaseClock:
    """Prints the seconds since its last call (and since it was made) under
    the name of the phases they covered."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def __call__(self, phases: str) -> None:
        now = time.perf_counter()
        print(f"[seconds] {phases}: {now - self.last:.1f} s (total "
              f"{now - self.start:.1f} s)")
        self.last = now


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def attention_work(*, B, Tq, H, KV, D, Dv, q0, k_valid, window, elt,
                   causal=True):
    """Bytes and FLOPs the attention call must move and do for these
    inputs: each (query, visible key) pair costs 2*(D + Dv) FLOPs; the
    bytes are q and out once plus the K/V rows any query can see."""
    lo_all, hi_all, pairs = None, None, 0
    for t in range(Tq):
        qpos = q0 + t
        hi = min(k_valid, qpos + 1) if causal else k_valid
        lo = max(0, qpos - window + 1) if window else 0
        pairs += max(0, hi - lo)
        lo_all = lo if lo_all is None else min(lo_all, lo)
        hi_all = hi if hi_all is None else max(hi_all, hi)
    flops = 2.0 * B * H * pairs * (D + Dv)
    keys = max(0, hi_all - lo_all)
    nbytes = elt * (B * Tq * H * (D + Dv) + B * KV * keys * (D + Dv))
    return nbytes, flops


def check_close(torch, got, want):
    """The kernel against its plain version, element by element: f32
    sums in another order (1e-4), plus in bf16 one rounding step of each
    element (2^-7 |want|).  Returns (max abs err, worst err / tol, ok);
    a NaN fails."""
    diff = (got.float() - want.float()).abs()
    tol = 1e-4 + (2.0 ** -7 * want.float().abs()
                  if got.dtype == torch.bfloat16 else 0.0)
    return (float(diff.max()), float((diff / tol).max()),
            bool((diff <= tol).all()))


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, flush, runs=25, warmup=3):
    """Median CUDA-event time of ``fn`` over ``runs`` launches, the L2
    cache flushed (outside the timed region) before each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fn, flush, runs=25):
    """Median device time of ``fn`` replayed as a CUDA graph, the L2
    flushed before each replay: what the launches cost the card without
    the host's time to prepare them (which ``time_ms`` includes, and
    which exceeds a decode call's device time)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return statistics.median(times)


def phase_build(torch):
    """One nvcc per source, all started together; each build timed."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    names = ("flash_attention", "fused_dsgd", "gossip_mix",
             "paged_flash_attention", "quantized_gossip")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        secs = dict(zip(names, pool.map(_build.build, names)))
    for name in names:
        print(f"[build] {name}.cu in {secs[name]:.1f}s")
        for kernel, regs, spill in _build.ptxas_report(name):
            print(f"[build]   {regs:3d} registers, {spill:4d} B spilled: "
                  f"{kernel}")
    print(f"[build] all in {time.perf_counter() - t0:.1f}s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sdpa_call(torch, q, k, v, *, q0, k_valid, window, scale, causal=True):
    """SDPA on the same inputs (boolean mask for causal, window and the
    valid prefix, keys past it zeroed; no mask at all for a non-causal
    call over every key): the yardstick.  It has no softcap, so it
    computes the function only where there is none."""
    import torch.nn.functional as F
    dev = q.device
    Tq, S = q.shape[1], k.shape[1]
    qpos = q0 + torch.arange(Tq, device=dev)[:, None]
    kpos = torch.arange(S, device=dev)[None, :]
    mask = kpos < k_valid
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (kpos > qpos - window)
    if not causal and not window and k_valid == S:
        mask = None
    kk = torch.where(kpos[0, :, None, None] < k_valid, k, 0)
    vv = torch.where(kpos[0, :, None, None] < k_valid, v, 0)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, vv))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)


def flash_case(torch, dev, gen, flush, *, name, phase, B, Tq, S, H, KV, D,
               q0, k_valid, window, softcap, poison=False, Dv=None,
               scale=None, causal=True):
    """One flash attention case, in bf16 and f32: the kernel against its
    plain version (``check_close``), its grid and split printed; with a
    ``phase``, the bf16 case timed and returned as (phase, JSON entry),
    the phase naming the path whose launches the entry reports.  Where
    the case has a softcap, SDPA does not compute the same function: its
    ``library_ms`` is null, and SDPA on the same inputs without the
    softcap is kept beside it as ``sdpa_without_softcap_ms``.  ``Dv``
    (default D) is the value head dim, ``scale`` an explicit softmax
    scale (MLA's); a pair the kernel is not instantiated for goes through
    the wrapper's zero padding, as on the model path.  ``causal=False``
    drops the causal mask (the encoder's and the cross-attention's calls;
    ``q0`` is then ``S - Tq``, the model's default, negative when the
    queries outnumber the keys)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (SUPPORTED_DIMS,
                                                     flash_attention_fwd)

    Dv = Dv or D
    padded = (D, Dv) not in SUPPORTED_DIMS
    out = None
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(B, Tq, H, D, generator=gen, device=dev)
        k = torch.randn(B, S, KV, D, generator=gen, device=dev)
        v = torch.randn(B, S, KV, Dv, generator=gen, device=dev)
        fill = float("nan") if poison else 0.0     # the cache's empty tail
        k[:, k_valid:] = fill
        v[:, k_valid:] = fill
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        kw = dict(q_start=q0, k_valid_len=k_valid, window=window,
                  softcap=softcap, scale=scale, causal=causal)
        want = ref.grouped_sdpa_ref(q, k, v, q_pos0=q0, k_valid_len=k_valid,
                                    window=window, softcap=softcap,
                                    scale=scale, causal=causal)
        got = flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        err, worst, ok = check_close(torch, got, want)
        dname = str(dtype).split(".")[1]
        print(f"[kernels] {name} {dname} {err:.3e} {worst:.3f} "
              f"({_launch_line(flash_attention_fwd)})")
        if not ok:
            raise SystemExit(f"flash attention {name} {dname}: max abs err "
                             f"{err}, {worst} x its tolerance")
        del want
        if not (phase and dtype == torch.bfloat16):
            continue
        fa = lambda: flash_attention_fwd(q, k, v, **kw)  # noqa: E731
        plain = lambda: ref.grouped_sdpa_ref(  # noqa: E731
            q, k, v, q_pos0=q0, k_valid_len=k_valid, window=window,
            softcap=softcap, scale=scale, causal=causal)
        lib = sdpa_call(torch, q, k, v, q0=q0, k_valid=k_valid,
                        window=window, scale=scale or D ** -0.5,
                        causal=causal)
        nbytes, flops = attention_work(
            B=B, Tq=Tq, H=H, KV=KV, D=D, Dv=Dv, q0=q0, k_valid=k_valid,
            window=window, elt=q.element_size(), causal=causal)
        b_ms, b_by = bound_ms(nbytes, flops, dname)
        lib_ms, lib_dev = time_ms(torch, lib, flush), graph_ms(torch, lib,
                                                               flush)
        out = {
            "name": f"flash_attention[{name},{dname}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu, "
                      "src/repro_torch/kernels/csrc/flash_core.cuh"
                      + (", src/repro_torch/kernels/flash_attention.py "
                         "(_pad_heads)"
                         if padded else ""),
            "replaces": "src/repro/kernels/flash_attention.py:310",
            "launches": None,
            "max_abs_err": err,
            "ms": time_ms(torch, fa, flush),
            "plain_ms": time_ms(torch, plain, flush),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None if softcap is not None else lib_ms,
            "device_ms": graph_ms(torch, fa, flush),
            "library_device_ms": None if softcap is not None else lib_dev,
        }
        if softcap is not None:
            out["sdpa_without_softcap_ms"] = lib_ms
            out["sdpa_without_softcap_device_ms"] = lib_dev
        print(f"[kernels] {out['name']}: {out['ms']:.4f} ms (bound "
              f"{b_ms:.5f} ms by {b_by}; plain {out['plain_ms']:.4f} ms; "
              f"sdpa{' without the softcap' if softcap else ''} "
              f"{lib_ms:.4f} ms; device, as a graph: "
              f"{out['device_ms']:.4f} ms, sdpa {lib_dev:.4f} ms)")
        if Tq == 1:     # a decode row: the chosen split == unsplit
            chosen = _bits(torch, fa())
            plan = _launch_line(flash_attention_fwd)
            one = flash_attention_fwd(q, k, v, kv_splits=1, **kw)
            if not torch.equal(chosen, _bits(torch, one)):
                raise SystemExit(f"flash attention {name}: the chosen split "
                                 f"({plan}) differs from unsplit")
            print(f"[kernels] {name}: the chosen split ({plan}) == unsplit "
                  f"bitwise")
    return None if out is None else (phase, out)


def phase_flash_kernels(torch, dev):
    """Flash attention vs plain on the card; returns (phase, JSON entry)
    for each timed bf16 main-path shape, the phase ("prefill", "decode"
    or "train-flash") whose launches the entry reports."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # (name, phase, B, Tq, S, q0, k_valid, window, softcap, poison); a
    # phase of None marks a correctness-only case
    cases = []
    for layer, window in (("local", LOCAL_WINDOW), ("global", None)):
        cases.append((f"prefill,{layer}", "prefill", BATCH, PROMPT, SEQ, 0,
                      PROMPT, window, None, False))
        for q0 in (PROMPT, SEQ - 2):
            cases.append((f"decode@{q0},{layer}", "decode", BATCH, 1, SEQ,
                          q0, q0 + 1, window, None, False))
        cases.append((f"train,{layer}", "train-flash", TRAIN_B, TRAIN_SEQ,
                      TRAIN_SEQ, 0, TRAIN_SEQ, window, None, False))
    cases.append(("ragged,local", None, BATCH, 77, SEQ, 900, 977,
                  LOCAL_WINDOW, None, True))
    cases.append(("softcap,global", None, BATCH, 77, SEQ, 900, 977, None,
                  50.0, True))

    entries = []
    print("[kernels] case dtype max_abs_err worst_err/tol")
    for (name, phase, B, Tq, S, q0, k_valid, window, softcap,
         poison) in cases:
        entry = flash_case(torch, dev, gen, flush, name=name, phase=phase,
                           B=B, Tq=Tq, S=S, H=HEADS, KV=KV_HEADS,
                           D=HEAD_DIM, q0=q0, k_valid=k_valid, window=window,
                           softcap=softcap, poison=poison)
        if entry is not None:
            entries.append(entry)
    entries += verify_entries(torch, dev, gen, flush)
    del flush
    flash_row_contract(torch, dev, gen, flash_attention_fwd)
    return entries


def phase_zoo_kernels(torch, dev):
    """Rows 1 and 2 at the dense zoo's shapes (``[zoo-*]``), each arch's
    head layout from its config: granite-8b (32 q / 8 kv heads of 128)
    and qwen1.5-4b (20 / 20 of 128, MHA) serving B=4 prompts of 1024
    with 32 new tokens; gemma2-2b (8 / 4 of 256, softcap 50, the local
    layers' window 4096) serving 4608-token prompts, where the window
    binds, and its training forward (B=2, Tq=S=1024).  Prefill, and
    decode at the last step, for each layer kind, bf16 timed, f32
    checked; each decode row's chosen split equals kv_splits=1 bit for
    bit.  Row 2 at granite-8b's continuous decode (8 slots, page 16, Tq
    1).  Returns (phase, JSON entry) per timed shape."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_flash_attention import \
        paged_flash_attention_fwd as paged

    gen = torch.Generator(device=dev).manual_seed(11)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    entries = []
    print("[zoo-kernels] case dtype max_abs_err worst_err/tol")
    for arch, prompt in ZOO_PROMPTS.items():
        cfg = get_config(arch)
        seq = prompt + ZOO_NEW
        heads = dict(H=cfg.num_heads, KV=cfg.num_kv_heads, D=cfg.head_dim,
                     softcap=cfg.attn_softcap)
        windows = sorted({s.window for s in cfg.pattern},
                         key=lambda w: w is None)
        for window in windows:
            layer = "global" if window is None else f"local {window}"
            for kind, B, Tq, q0, k_valid in (
                    ("prefill", ZOO_BATCH, prompt, 0, prompt),
                    (f"decode@{seq - 2}", ZOO_BATCH, 1, seq - 2, seq - 1)):
                entries.append(flash_case(
                    torch, dev, gen, flush, name=f"{arch} {kind},{layer}",
                    phase=f"zoo-serve-{arch}", B=B, Tq=Tq, S=seq, q0=q0,
                    k_valid=k_valid, window=window, **heads))
            if arch == ZOO_TRAIN_ARCH:
                entries.append(flash_case(
                    torch, dev, gen, flush, name=f"{arch} train,{layer}",
                    phase="zoo-train-flash", B=TRAIN_B, Tq=TRAIN_SEQ,
                    S=TRAIN_SEQ, q0=0, k_valid=TRAIN_SEQ, window=window,
                    **heads))
        torch.cuda.empty_cache()
    # row 2 at the continuous path of granite-8b: ragged slot positions
    cfg = get_config(ZOO_CONT_ARCH)
    q0 = [64, 207, 351, 512, 640, 801, 1000, PROMPT + ZOO_NEW - 2]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q, kp, vp, table, qs = paged_inputs(
            torch, dev, dtype, gen, ps=CONT_PAGE, Tq=1, q0=q0,
            heads=(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim),
            seq=PROMPT + ZOO_NEW)
        kw = dict(q_start=qs, k_valid_len=qs + 1)
        want = ref.paged_sdpa_ref(q, kp, vp, table, **kw)
        got = paged(q, kp, vp, table, **kw)
        torch.cuda.synchronize()
        err, worst, ok = check_close(torch, got, want)
        name = f"{ZOO_CONT_ARCH} decode,global,ps={CONT_PAGE}"
        print(f"[zoo-kernels] paged {name} {dname} {err:.3e} {worst:.3f} "
              f"({_launch_line(paged)})")
        if not ok or bool(got.isnan().any()):
            raise SystemExit(f"paged attention {name} {dname}: max abs err "
                             f"{err}, {worst} x its tolerance")
        if dtype == torch.bfloat16:
            entries.append(paged_entry(
                torch, dev, flush, F, ref, paged, f"{ZOO_CONT_ARCH} decode",
                "global", None, q, kp, vp, table, qs, err,
                phase="zoo-continuous-paged"))
    del flush
    torch.cuda.empty_cache()
    return entries


def phase_moe_kernels(torch, dev):
    """``[moe-kernels]``: row 1 at the MoE family's shapes, each arch's
    head layout from its config: grok-1-314b (48 q / 8 kv heads of 128, 6
    per kv head, softcap 30) and deepseek-v3-671b (MLA expanded to 128
    heads of (192, 128), MHA, the explicit scale 192 ** -0.5) serving B=4
    prompts of 1024 with 32 new tokens: prefill and last-step decode,
    bf16 timed, f32 checked, each decode row's chosen split equal to
    kv_splits=1 bit for bit.  The padded pairs through the wrapper's zero
    padding at the [moe-train] shape (B=2, Tq=S=1024, 4 heads): reduced
    MLA's (48, 32) and (64, 32), which no ported path runs, each entry
    reporting the launches counted under its pair over the path runs
    (``path-flash-<D>x<Dv>``).  Row 2 at grok-1-314b's continuous decode (8
    slots, page 16, softcap 30).  Returns (phase, JSON entry) per timed
    shape."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_flash_attention import \
        paged_flash_attention_fwd as paged

    gen = torch.Generator(device=dev).manual_seed(22)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    entries = []
    seq = MOE_PROMPT + ZOO_NEW
    print("[moe-kernels] case dtype max_abs_err worst_err/tol")
    for arch in MOE_BLOCKS:
        cfg = get_config(arch)
        if cfg.mla is not None:        # the latent expanded to MHA heads
            m = cfg.mla
            D = m.qk_nope_dim + m.qk_rope_dim
            heads = dict(H=cfg.num_heads, KV=cfg.num_heads, D=D,
                         Dv=m.v_head_dim, scale=D ** -0.5)
        else:
            heads = dict(H=cfg.num_heads, KV=cfg.num_kv_heads,
                         D=cfg.head_dim)
        for kind, Tq, q0, k_valid in (
                ("prefill", MOE_PROMPT, 0, MOE_PROMPT),
                (f"decode@{seq - 2}", 1, seq - 2, seq - 1)):
            entries.append(flash_case(
                torch, dev, gen, flush, name=f"{arch} {kind},global",
                phase=f"moe-serve-{arch}", B=ZOO_BATCH, Tq=Tq, S=seq, q0=q0,
                k_valid=k_valid, window=None, softcap=cfg.attn_softcap,
                **heads))
        torch.cuda.empty_cache()
    heads = get_config("deepseek-v3-671b").reduced().num_heads
    for D, Dv in MOE_PADDED:
        entries.append(flash_case(
            torch, dev, gen, flush, name=f"padded ({D}, {Dv}) train",
            phase=f"path-flash-{D}x{Dv}", B=TRAIN_B, Tq=TRAIN_SEQ,
            S=TRAIN_SEQ, H=heads, KV=heads, D=D, Dv=Dv, q0=0,
            k_valid=TRAIN_SEQ, window=None, softcap=None, scale=D ** -0.5))
    # row 2 at grok-1-314b's continuous decode: ragged slot positions
    cfg = get_config(MOE_CONT_ARCH)
    q0 = [64, 207, 351, 512, 640, 801, 1000, seq - 2]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q, kp, vp, table, qs = paged_inputs(
            torch, dev, dtype, gen, ps=CONT_PAGE, Tq=1, q0=q0,
            heads=(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim), seq=seq)
        kw = dict(q_start=qs, k_valid_len=qs + 1, softcap=cfg.attn_softcap)
        want = ref.paged_sdpa_ref(q, kp, vp, table, **kw)
        got = paged(q, kp, vp, table, **kw)
        torch.cuda.synchronize()
        err, worst, ok = check_close(torch, got, want)
        name = f"{MOE_CONT_ARCH} decode,global,ps={CONT_PAGE}"
        print(f"[moe-kernels] paged {name} {dname} {err:.3e} {worst:.3f} "
              f"({_launch_line(paged)})")
        if not ok or bool(got.isnan().any()):
            raise SystemExit(f"paged attention {name} {dname}: max abs err "
                             f"{err}, {worst} x its tolerance")
        if dtype == torch.bfloat16:
            entries.append(paged_entry(
                torch, dev, flush, F, ref, paged, f"{MOE_CONT_ARCH} decode",
                "global", None, q, kp, vp, table, qs, err,
                phase="moe-continuous-paged", softcap=cfg.attn_softcap))
    del flush
    torch.cuda.empty_cache()
    return entries


def phase_hybrid_kernels(torch, dev):
    """``[hybrid-kernels]``: row 1 at jamba-1.5-large-398b's attention
    layer (64 q / 8 kv heads of 128, 8 per kv head, no softcap), serving
    B=4 prompts of 1024 with 32 new tokens, as ``[hybrid-serve]`` runs it:
    prefill and last-step decode, bf16 timed, f32 checked, the decode
    row's chosen split equal to kv_splits=1 bit for bit.  Returns (phase,
    JSON entry) per timed shape."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device=dev).manual_seed(33)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cfg = get_config(HYBRID_ARCH)
    seq = MOE_PROMPT + ZOO_NEW
    entries = []
    print("[hybrid-kernels] case dtype max_abs_err worst_err/tol")
    for kind, Tq, q0, k_valid in (
            ("prefill", MOE_PROMPT, 0, MOE_PROMPT),
            (f"decode@{seq - 2}", 1, seq - 2, seq - 1)):
        entries.append(flash_case(
            torch, dev, gen, flush, name=f"{HYBRID_ARCH} {kind},global",
            phase=f"hybrid-serve-{HYBRID_ARCH}", B=ZOO_BATCH, Tq=Tq, S=seq,
            H=cfg.num_heads, KV=cfg.num_kv_heads, D=cfg.head_dim, q0=q0,
            k_valid=k_valid, window=None, softcap=cfg.attn_softcap))
    del flush
    torch.cuda.empty_cache()
    return entries


def phase_vlm_kernels(torch, dev):
    """``[vlm-kernels]``: row 1 at llava-next-34b's attention (56 q / 8 kv
    heads of 128, 7 per kv head) as ``[vlm-serve]`` runs it: B=4 prefill
    of the 2880 patch embeddings and a 1024-token prompt (Tq 3904) in a
    cache of 3936, and decode at 3934, bf16 timed, f32 checked, the
    decode row's chosen split equal to kv_splits=1 bit for bit.  Returns
    (phase, JSON entry) per timed shape."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device=dev).manual_seed(44)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cfg = get_config(VLM_ARCH)
    index0 = VLM_PATCHES + VLM_PROMPT
    seq = index0 + ZOO_NEW
    entries = []
    print("[vlm-kernels] case dtype max_abs_err worst_err/tol")
    for kind, Tq, q0, k_valid in (
            ("prefill", index0, 0, index0),
            (f"decode@{seq - 2}", 1, seq - 2, seq - 1)):
        entries.append(flash_case(
            torch, dev, gen, flush, name=f"{VLM_ARCH} {kind},global",
            phase=f"vlm-serve-{VLM_ARCH}", B=ZOO_BATCH, Tq=Tq, S=seq,
            H=cfg.num_heads, KV=cfg.num_kv_heads, D=cfg.head_dim, q0=q0,
            k_valid=k_valid, window=None, softcap=cfg.attn_softcap))
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return entries


def phase_encdec_kernels(torch, dev):
    """``[encdec-kernels]``: row 1 at seamless-m4t-large-v2's attention
    (16 q / 16 kv heads of 64, MHA, the kernel's native (64, 64)) as
    ``[encdec-serve]`` runs it, B=4: the encoder over the 1024 frames
    (non-causal, Tq = S = 1024), the decoder's cross-attention at prefill
    (the 64-token prompt against the 1024 encoder rows, non-causal, q0 =
    S - Tq = 960) and at decode (one row against 1024, the chosen split
    equal to kv_splits=1 bit for bit), and its causal self-attention
    (prefill of 64 in a cache of 96, decode at 94); then a non-causal
    call whose 2048 queries outnumber its 1024 keys (q0 = -1024; on no
    path: its entry reports the launches of no run and is exempt from the
    idle check).  bf16 timed against the plain version and SDPA
    (non-causal SDPA over every key where the case is non-causal), f32
    checked.  Returns (phase, JSON entry) per timed shape."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device=dev).manual_seed(55)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cfg = get_config(ENCDEC_ARCH)
    F_, P = ENCDEC_FRAMES, ENCDEC_PROMPT
    seq = P + ZOO_NEW
    serve = f"encdec-serve-{ENCDEC_ARCH}"
    entries = []
    print("[encdec-kernels] case dtype max_abs_err worst_err/tol")
    # (name, phase, Tq, S, q0, k_valid, causal)
    for name, phase, Tq, S, q0, k_valid, causal in (
            ("encoder", serve, F_, F_, 0, F_, False),
            ("cross prefill", serve, P, F_, F_ - P, F_, False),
            ("cross decode", serve, 1, F_, F_ - 1, F_, False),
            ("self prefill", serve, P, seq, 0, P, True),
            (f"self decode@{seq - 2}", serve, 1, seq, seq - 2, seq - 1,
             True),
            ("non-causal Tq > S", "encdec-noncausal-tq-gt-s", 2 * F_, F_,
             -F_, F_, False)):
        entries.append(flash_case(
            torch, dev, gen, flush, name=f"{ENCDEC_ARCH} {name}",
            phase=phase, B=ZOO_BATCH, Tq=Tq, S=S, H=cfg.num_heads,
            KV=cfg.num_kv_heads, D=cfg.head_dim, q0=q0, k_valid=k_valid,
            window=None, softcap=cfg.attn_softcap, causal=causal))
    del flush
    torch.cuda.empty_cache()
    return entries


def verify_entries(torch, dev, gen, flush):
    """Row 1 at the fixed-batch verify shape, through ``ops.sdpa_decode``
    as the engine calls it: B=4, k + 1 = 5 rows at per-request positions
    (``SPEC_STARTS``), a cache of 1092 positions, each request's tail past
    its k_valid NaN; local and global layers, bf16 timed, f32 checked.
    Returns ("spec", JSON entry) per layer: [spec] counts its launches.
    The plain version is ``grouped_sdpa_decode_ref``; ``library_ms`` is
    SDPA with an explicit (B, 1, 5, 1092) boolean mask on the same
    inputs, the tails zeroed (SDPA would read the NaN)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    B, Tq, S, D = BATCH, SPEC_K + 1, SPEC_SEQ, HEAD_DIM
    qs = torch.tensor(SPEC_STARTS, dtype=torch.int32, device=dev)
    kv = qs + Tq
    qpos = qs[:, None].long() + torch.arange(Tq, device=dev)    # (B, Tq)
    kpos = torch.arange(S, device=dev)
    valid = kpos[None, :] < kv[:, None]                         # (B, S)
    entries = []
    for layer, window in (("local", LOCAL_WINDOW), ("global", None)):
        mask = (kpos <= qpos[..., None]) & valid[:, None, :]
        if window:
            mask &= kpos > qpos[..., None] - window
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            q = torch.randn(B, Tq, HEADS, D, generator=gen, device=dev)
            k, v = (torch.randn(B, S, KV_HEADS, D, generator=gen,
                                device=dev) for _ in range(2))
            k, v = (torch.where(valid[..., None, None], t, float("nan"))
                    for t in (k, v))
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            kw = dict(q_start=qs, k_valid_len=kv, window=window)
            want = ref.grouped_sdpa_decode_ref(q, k, v, **kw)
            got = ops.sdpa_decode(q, k, v, **kw)
            torch.cuda.synchronize()
            err, worst, ok = check_close(torch, got, want)
            print(f"[kernels] verify@ragged,{layer} {dname} {err:.3e} "
                  f"{worst:.3f} (ops.sdpa_decode; "
                  f"{_launch_line(flash_attention_fwd)})")
            if not ok:
                raise SystemExit(f"sdpa_decode verify,{layer} {dname}: max "
                                 f"abs err {err}, {worst} x its tolerance")
            if dtype != torch.bfloat16:
                continue
            fa = lambda: ops.sdpa_decode(q, k, v, **kw)  # noqa: E731
            plain = lambda: ref.grouped_sdpa_decode_ref(  # noqa: E731
                q, k, v, **kw)
            kk, vv = (torch.where(valid[..., None, None], t, 0)
                      for t in (k, v))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, vv))
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask[:, None], scale=D ** -0.5,
                enable_gqa=True)
            nbytes = flops = 0.0
            for q0 in SPEC_STARTS:
                nb, fl = attention_work(B=1, Tq=Tq, H=HEADS, KV=KV_HEADS,
                                        D=D, Dv=D, q0=q0, k_valid=q0 + Tq,
                                        window=window, elt=q.element_size())
                nbytes, flops = nbytes + nb, flops + fl
            b_ms, b_by = bound_ms(nbytes, flops, dname)
            entry = {
                "name": f"flash_attention[verify@ragged,{layer},{dname}]",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu, "
                          "src/repro_torch/kernels/csrc/flash_core.cuh",
                "replaces": "src/repro/kernels/flash_attention.py:310",
                "launches": None,
                "max_abs_err": err,
                "ms": time_ms(torch, fa, flush),
                "plain_ms": time_ms(torch, plain, flush),
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": time_ms(torch, lib, flush),
                "device_ms": graph_ms(torch, fa, flush),
                "library_device_ms": graph_ms(torch, lib, flush),
            }
            print(f"[kernels] {entry['name']}: {entry['ms']:.4f} ms (bound "
                  f"{b_ms:.5f} ms by {b_by}; plain {entry['plain_ms']:.4f} "
                  f"ms; sdpa {entry['library_ms']:.4f} ms; device, as a "
                  f"graph: {entry['device_ms']:.4f} ms, sdpa "
                  f"{entry['library_device_ms']:.4f} ms)")
            entries.append(("spec", entry))
    return entries


def _launch_line(fn):
    ll = fn.last_launch
    return (f"grid {ll['grid']} x {ll['threads']} threads, "
            f"{ll['splits']} split{'s' if ll['splits'] > 1 else ''}")


def flash_row_contract(torch, dev, gen, flash):
    """The dense kernel's row contract at the serving path's shapes (B=4,
    4 q / 1 kv heads of 256, S=1088, local window 512 and global), bit
    for bit in bf16 and f32: a 5-row verify window with per-batch q_start
    equals 5 one-row calls, and a decode row split over 2 to 17 blocks
    equals kv_splits=1."""
    starts = [3, 401, 700, SEQ - 5]
    qs = torch.tensor(starts, dtype=torch.int32, device=dev)
    for layer, window in (("local", LOCAL_WINDOW), ("global", None)):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            q = torch.randn(BATCH, 5, HEADS, HEAD_DIM, generator=gen,
                            device=dev).to(dtype)
            k, v = (torch.randn(BATCH, SEQ, KV_HEADS, HEAD_DIM,
                                generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            verify = flash(q, k, v, q_start=qs, k_valid_len=qs + 5,
                           window=window)
            plan = _launch_line(flash)
            for i in range(5):
                one = flash(q[:, i:i + 1], k, v, q_start=qs + i,
                            k_valid_len=qs + i + 1, window=window)
                if not torch.equal(_bits(torch, one),
                                   _bits(torch, verify[:, i:i + 1])):
                    raise SystemExit(f"flash attention {layer} {dname}: "
                                     f"verify row {i} differs from its "
                                     f"one-row call")
            print(f"[kernels] verify,{layer} {dname}: 5 rows == 5 one-row "
                  f"calls bitwise ({plan}; one-row: {_launch_line(flash)})")
            kw = dict(q_start=SEQ - 2, k_valid_len=SEQ - 1, window=window)
            chosen = flash(q[:, :1], k, v, **kw)
            plan = _launch_line(flash)
            base = flash(q[:, :1], k, v, kv_splits=1, **kw)
            for splits, got in ((None, chosen), *(
                    (n, flash(q[:, :1], k, v, kv_splits=n, **kw))
                    for n in (2, 5, 17))):
                if not torch.equal(_bits(torch, got), _bits(torch, base)):
                    raise SystemExit(f"flash attention {layer} {dname}: "
                                     f"{splits} splits differ from one")
            print(f"[kernels] decode@{SEQ - 2},{layer} {dname}: the chosen "
                  f"split ({plan}) and splits 2, 5, 17 == unsplit bitwise")
            sdpa_decode_row_contract(torch, dev, gen, flash, layer, window,
                                     dtype)


def sdpa_decode_row_contract(torch, dev, gen, flash, layer, window, dtype):
    """The same contract through ``ops.sdpa_decode`` at the fixed-batch
    engine's verify positions (``SPEC_STARTS``, a cache of 1092): the
    5-row verify equals the wrapper's direct call and the 5 one-row calls
    a plain decode step makes, bit for bit."""
    from repro_torch.kernels import ops
    dname = str(dtype).split(".")[1]
    qs = torch.tensor(SPEC_STARTS, dtype=torch.int32, device=dev)
    q = torch.randn(BATCH, SPEC_K + 1, HEADS, HEAD_DIM, generator=gen,
                    device=dev).to(dtype)
    k, v = (torch.randn(BATCH, SPEC_SEQ, KV_HEADS, HEAD_DIM, generator=gen,
                        device=dev).to(dtype) for _ in range(2))
    kw = dict(q_start=qs, k_valid_len=qs + SPEC_K + 1, window=window)
    verify = ops.sdpa_decode(q, k, v, **kw)
    plan = _launch_line(flash)
    same = torch.equal(_bits(torch, verify),
                       _bits(torch, flash(q, k, v, **kw)))
    for i in range(SPEC_K + 1):
        one = ops.sdpa_decode(q[:, i:i + 1], k, v, q_start=qs + i,
                              k_valid_len=qs + i + 1, window=window)
        same &= torch.equal(_bits(torch, one),
                            _bits(torch, verify[:, i:i + 1]))
    if not same:
        raise SystemExit(f"sdpa_decode {layer} {dname}: the verify at "
                         f"{list(SPEC_STARTS)} differs from the direct call "
                         f"or from its one-row calls")
    print(f"[kernels] sdpa_decode verify@{list(SPEC_STARTS)},{layer} "
          f"{dname}: == the direct call and == 5 one-row calls bitwise "
          f"({plan})")


def _bits(torch, t):
    """The bit pattern of an f32 / bf16 tensor, for exact comparison."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def phase_dsgd_kernels(torch, dev):
    """Fused DSGD-momentum vs plain on the card, bit for bit; returns
    ("train-fused_dsgd", JSON entry) for each training-path shape in
    bf16 with per-row pre-scales (the main path's mode)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_dsgd import fused_dsgd

    gen = torch.Generator(device=dev).manual_seed(7)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    beta, eta = TRAIN_MOMENTUM, TRAIN_ETA

    def check(name, x, u, g, pre, dname, mode):
        got = fused_dsgd(x, u, g, beta, eta, pre)
        bp = pre[:, None] if isinstance(pre, torch.Tensor) else pre
        want = ref.fused_dsgd_ref(x, u, g, beta, eta, bp)
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        same = all(torch.equal(_bits(torch, a), _bits(torch, b))
                   for a, b in zip(got, want))
        print(f"[dsgd] {name} {tuple(x.shape)} {dname} pre={mode}: "
              f"bitwise {same}, max abs err {err:.3e}")
        if not same:
            raise SystemExit(f"fused DSGD {name} {dname} pre={mode} differs "
                             f"from its plain version (max abs err {err})")
        del got, want
        return err

    entries = []
    cases = DSGD_SHAPES + (("ragged", DSGD_RAGGED),)
    for name, shape in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            x, u, g = (torch.randn(shape, generator=gen, device=dev,
                                   dtype=dtype) for _ in range(3))
            row = torch.rand(shape[0], generator=gen, device=dev) + 0.2
            err = check(name, x, u, g, row, dname, "row")
            check(name, x, u, g, 0.37, dname, "scalar")
            if dtype == torch.bfloat16 and name != "ragged":
                numel = x.numel()
                b_ms, b_by = bound_ms(5 * numel * x.element_size()
                                      + 4 * shape[0], 6 * numel, "float32")
                entry = {
                    "name": f"fused_dsgd[{name},{dname}]",
                    "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/fused_dsgd.cu",
                    "replaces": "src/repro/kernels/fused_dsgd.py:50",
                    "launches": None,
                    "max_abs_err": err,
                    "ms": time_ms(torch, lambda: fused_dsgd(
                        x, u, g, beta, eta, row), flush),
                    "device_ms": graph_ms(torch, lambda: fused_dsgd(
                        x, u, g, beta, eta, row), flush),
                    "plain_ms": time_ms(torch, lambda: ref.fused_dsgd_ref(
                        x, u, g, beta, eta, row[:, None]), flush),
                    "bound_ms": b_ms,
                    "bound_by": b_by,
                    "library_ms": None,
                }
                print(f"[dsgd] {entry['name']}: {entry['ms']:.4f} ms, device "
                      f"(as a graph) {entry['device_ms']:.4f} ms (bound "
                      f"{b_ms:.4f} ms by {b_by}; plain "
                      f"{entry['plain_ms']:.4f} ms)")
                entries.append(("train-fused_dsgd", entry))
            del x, u, g
            torch.cuda.empty_cache()

    # above 2^31 elements: 64-bit indices.  The plain version's f32
    # temporaries over the whole tensor would not fit, so it is held
    # against the kernel one column slice at a time (the op is
    # elementwise, so a slice gives the same bits).
    shape = DSGD_ABOVE_2_31
    x, u, g = (torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    row = torch.rand(shape[0], generator=gen, device=dev) + 0.2
    gx, gu = fused_dsgd(x, u, g, beta, eta, row)
    torch.cuda.synchronize()
    for c0 in range(0, shape[1], DSGD_SLICE):
        s = slice(c0, c0 + DSGD_SLICE)
        wx, wu = ref.fused_dsgd_ref(x[:, s], u[:, s], g[:, s], beta, eta,
                                    row[:, None])
        if not (torch.equal(_bits(torch, gx[:, s]), _bits(torch, wx))
                and torch.equal(_bits(torch, gu[:, s]), _bits(torch, wu))):
            raise SystemExit(f"fused DSGD above 2^31 elements differs from "
                             f"its plain version in columns {c0}+")
    print(f"[dsgd] {shape} bfloat16 pre=row ({x.numel()} elements, 2^31 = "
          f"{1 << 31}): bitwise True")
    del x, u, g, gx, gu
    torch.cuda.empty_cache()
    entries += dsgd_grouped(torch, dev, gen, flush)
    del flush
    torch.cuda.empty_cache()
    return entries


def gemma_shapes(torch):
    """gemma3-1b's 340 leaf shapes, from the model on the meta device."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    return [tuple(v.shape) for v in M.Model(
        get_config("gemma3-1b"), dtype=torch.bfloat16,
        device="meta").state_dict().values()]


def dsgd_grouped(torch, dev, gen, flush):
    """The grouped launch (``fused_dsgd_many``) over every gemma3-1b leaf
    at n = TRAIN_N in bf16, per-row, scalar and unit pre-scales, and over
    a ragged list of mixed dtypes, bit for bit against the plain version
    leaf by leaf; returns the JSON entries of the per-row (``[train]``)
    and unit (``[train-compress]``, ``[dist]``) launches, timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_dsgd import fused_dsgd_many

    beta, eta = TRAIN_MOMENTUM, TRAIN_ETA

    def check(name, xs, us, gs, pre, mode):
        before = (fused_dsgd_many.launches, fused_dsgd_many.segments)
        got_x, got_u = fused_dsgd_many(xs, us, gs, beta, eta, pre)
        torch.cuda.synchronize()
        launches = fused_dsgd_many.launches - before[0]
        segments = fused_dsgd_many.segments - before[1]
        same = True
        for x, u, g, gx, gu in zip(xs, us, gs, got_x, got_u):
            bp = pre.reshape((-1,) + (1,) * (x.ndim - 1)) \
                if isinstance(pre, torch.Tensor) else pre
            wx, wu = ref.fused_dsgd_ref(x, u, g, beta, eta, bp)
            same &= torch.equal(_bits(torch, gx), _bits(torch, wx)) \
                and torch.equal(_bits(torch, gu), _bits(torch, wu))
            del wx, wu
        print(f"[dsgd] grouped {name} pre={mode}: {launches} launch(es) over "
              f"{segments} tensors, bitwise {same}")
        if not same:
            raise SystemExit(f"fused_dsgd_many {name} pre={mode} differs "
                             f"from its plain version")
        return got_x, got_u

    # a ragged list: f32 and bf16, an empty leaf, an unaligned one, rows
    # that are no multiple of a vector
    specs = [((3, 1), torch.float32), ((3, 1152), torch.bfloat16),
             ((3, 0), torch.float32), ((3, 257, 3), torch.float32),
             ((3, 70001), torch.bfloat16), ((3, 4, 65), torch.float32)]
    xs, us, gs = [], [], []
    for shape, dtype in specs:
        for lst in (xs, us, gs):
            lst.append(torch.randn(shape, generator=gen, device=dev,
                                   dtype=dtype))
    n = 1 + 3 * 1152
    off = torch.randn(n, generator=gen, device=dev, dtype=torch.bfloat16)
    xs.append(off[1:].view(3, 1152))           # 2 bytes off alignment
    us.append(torch.randn(3, 1152, generator=gen, device=dev,
                          dtype=torch.bfloat16))
    gs.append(torch.randn(3, 1152, generator=gen, device=dev,
                          dtype=torch.bfloat16))
    row = torch.rand(TRAIN_N, generator=gen, device=dev) + 0.2
    for pre, mode in ((row, "row"), (0.37, "scalar")):
        check("ragged (f32 + bf16, empty, unaligned)", xs, us, gs, pre, mode)
    del xs, us, gs, off

    shapes = gemma_shapes(torch)
    xs, us, gs = ([torch.randn((TRAIN_N,) + s, generator=gen, device=dev,
                               dtype=torch.bfloat16) for s in shapes]
                  for _ in range(3))
    numel = sum(x.numel() for x in xs)
    name = f"gemma3-1b, {len(xs)} leaves x {TRAIN_N} nodes, bfloat16"
    check(name, xs, us, gs, row, "row")
    check(name, xs, us, gs, 0.37, "scalar")
    got_x, got_u = check(name, xs, us, gs, 1.0, "1")

    # torch._fused_sgd_ at pre = 1 (dampening 0, no weight decay, no
    # Nesterov) computes the same function, in place, with its own
    # rounding: its max abs difference from the kernel beside its time
    lx, lu = [x.clone() for x in xs], [u.clone() for u in us]

    def fused_sgd():
        torch._fused_sgd_(lx, gs, lu, weight_decay=0.0, momentum=beta,
                          lr=eta, dampening=0.0, nesterov=False,
                          maximize=False, is_first_step=False)

    fused_sgd()
    torch.cuda.synchronize()
    lib_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(lx + lu, got_x + got_u))
    del got_x, got_u
    b_ms, b_by = bound_ms(5 * numel * 2 + 4 * TRAIN_N, 6 * numel, "float32")
    entries = []
    for pre, mode, phase in ((row, "row", "train-fused_dsgd"),
                             (1.0, "1", "train-compress-fused_dsgd")):
        def fn():
            return fused_dsgd_many(xs, us, gs, beta, eta, pre)

        def plain():
            bp = pre[:, None] if isinstance(pre, torch.Tensor) else pre
            return [ref.fused_dsgd_ref(x.view(TRAIN_N, -1),
                                       u.view(TRAIN_N, -1),
                                       g.view(TRAIN_N, -1), beta, eta, bp)
                    for x, u, g in zip(xs, us, gs)]

        entry = {
            "name": f"fused_dsgd_many[{len(xs)} leaves,bfloat16,pre={mode}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_dsgd.cu, "
                      "src/repro_torch/kernels/csrc/multi_tensor.cuh",
            "replaces": "src/repro/kernels/fused_dsgd.py:50",
            "launches": None,
            "max_abs_err": 0.0,
            "ms": time_ms(torch, fn, flush),
            "device_ms": graph_ms(torch, fn, flush),
            "plain_ms": time_ms(torch, plain, flush, runs=5, warmup=1),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        }
        lib = ""
        if mode == "1":
            entry["library_ms"] = time_ms(torch, fused_sgd, flush)
            entry["library_device_ms"] = graph_ms(torch, fused_sgd, flush)
            entry["library_max_abs_diff"] = lib_err
            lib = (f"; torch._fused_sgd_ {entry['library_ms']:.4f} ms, "
                   f"device {entry['library_device_ms']:.4f} ms, max abs "
                   f"diff from the kernel {lib_err:.3e}")
        print(f"[dsgd] {entry['name']}: {entry['ms']:.4f} ms, device (as a "
              f"graph) {entry['device_ms']:.4f} ms (bound {b_ms:.4f} ms by "
              f"{b_by}, {numel * 10 / 1e9:.2f} GB; plain "
              f"{entry['plain_ms']:.4f} ms{lib})")
        entries.append((phase, entry))
    del xs, us, gs, lx, lu
    torch.cuda.empty_cache()
    return entries


def phase_quantize_kernels(torch, dev):
    """Quantize+EF vs plain on the card, bit for bit on q, scale and the
    residual; returns ("train-quantize_ef", JSON entry) for each
    compressed training-path shape, int8 with err (the main path's
    mode)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantized_gossip import quantize_ef

    gen = torch.Generator(device=dev).manual_seed(11)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    key = ref.sr_key(0, 3)

    def inputs(R, C, case):
        x = torch.randn(R, C, generator=gen, device=dev)
        err = 0.1 * torch.randn(R, C, generator=gen, device=dev)
        if case == "zero-rows":
            x[::3] = 0.0
            err[::3] = 0.0
        elif case == "subnormal":
            x[:, 0] = 3.0
            x[:, 1:] *= 1e-5
            err.zero_()
        return x, err

    def check(name, x, err, off, fmt):
        got = quantize_ef(x, err, key, off, fmt=fmt)
        want = ref.quantize_ef_ref(x, err, key, off, fmt=fmt)
        torch.cuda.synchronize()
        same = all(a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.view(torch.uint8), b.view(torch.uint8)) for a, b in zip(got,
                                                                      want))
        err_abs = float((got[2] - want[2]).abs().max())
        print(f"[quantize] {name} {tuple(x.shape)} {fmt} "
              f"err={'yes' if err is not None else 'no'} offset={off}: "
              f"bitwise {same}")
        if not same:
            raise SystemExit(f"quantize+EF {name} {fmt} differs from its "
                             f"plain version (residual max abs err "
                             f"{err_abs})")
        return got, err_abs

    for name, (R, C), off, case in QUANT_EDGES:
        x, err = inputs(R, C, case)
        for fmt in ("int8", "fp8"):
            for e in (err, None):
                got, _ = check(name, x, e, off, fmt)
                if case == "subnormal" and fmt == "fp8":
                    v = (x[:, 1:] / got[1]).abs()
                    nz = int((got[0][:, 1:].float() != 0).sum())
                    if not (float(v.max()) < 2.0 ** -6 and nz > 0):
                        raise SystemExit("the fp8 subnormal case is not in "
                                         "e4m3's subnormal range")
                    print(f"[quantize]   max |s|/scale {float(v.max()):.3e} "
                          f"< 2^-6; {nz} nonzero subnormal payloads")
                if case == "zero-rows" and not bool(
                        (got[1][::3] == 1.0).all()):
                    raise SystemExit("all-zero rows must get scale 1")
        idx_max = ((off + R) * C - 1) % (1 << 32)
        if off:
            print(f"[quantize]   global indices {off * C} .. "
                  f"{(off + R) * C - 1} (mod 2^32 to {idx_max})")
        del x, err

    entries = quantize_grouped(torch, dev, gen, flush, key, inputs)
    for name, (R, C) in QUANT_SHAPES:
        x, err = inputs(R, C, None)
        for fmt in ("int8", "fp8"):
            for e in (err, None):
                got, err_abs = check(name, x, e, 0, fmt)
                if fmt == COMPRESS_CODEC and e is not None:
                    main_err = err_abs
                del got
                torch.cuda.empty_cache()
        numel = R * C
        # 13 B per element (read x and err, write q and resid) + 4 B per
        # scale; ~10 f32 and ~13 integer (hash) operations per element,
        # all counted at the f32 rate
        b_ms, b_by = bound_ms(13 * numel + 4 * R, 23 * numel, "float32")
        entry = {
            "name": f"quantize_ef[{name},{COMPRESS_CODEC},err]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quantized_gossip.cu",
            "replaces": "src/repro/kernels/quantized_gossip.py:71",
            "launches": None,
            "max_abs_err": main_err,
            "ms": time_ms(torch, lambda: quantize_ef(
                x, err, key, 0, fmt=COMPRESS_CODEC), flush),
            "device_ms": graph_ms(torch, lambda: quantize_ef(
                x, err, key, 0, fmt=COMPRESS_CODEC), flush),
            "plain_ms": time_ms(torch, lambda: ref.quantize_ef_ref(
                x, err, key, 0, fmt=COMPRESS_CODEC), flush),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        }
        print(f"[quantize] {entry['name']} ({R} x {C}): {entry['ms']:.4f} "
              f"ms, device (as a graph) {entry['device_ms']:.4f} ms (bound "
              f"{b_ms:.4f} ms by {b_by}; plain {entry['plain_ms']:.4f} ms)")
        entries.append(("train-quantize_ef", entry))
        del x, err
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return entries


def leaf_rows(torch, nodes):
    """Chunk rows of each of gemma3-1b's 106 reference leaves at ``nodes``
    nodes: the compressed paths' (rows, CHUNK) buffers, each node's
    blocks back to back, padded once."""
    from repro_torch.compress import reference_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    sd = M.Model(get_config("gemma3-1b"), dtype=torch.bfloat16,
                 device="meta").state_dict()
    return [nodes * max(1, -(-len(g) * sd[g[0]].numel() // CHUNK))
            for g in reference_leaves(sd)]


def _unaligned_like(torch, t):
    """A copy of ``t`` that starts one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 16 // t.element_size(), dtype=t.dtype,
                      device=t.device)
    return buf[1:1 + t.numel()].view(t.shape).copy_(t)


def quantize_grouped(torch, dev, gen, flush, key, inputs):
    """The grouped quantize+EF (``quantize_ef_many``) bit for bit against
    the plain version leaf by leaf: a ragged list (C in {2, 6, 250, 256,
    1024}, unaligned buffers, zero rows, fp8's subnormal tail, row offsets
    whose indices pass 2^32), with err, without and mixed, a list longer
    than one table, and all 106 gemma3-1b reference leaves as one rank's
    rows (rank 1's row offsets) and as the simulation's 3 nodes (int8
    with err, the main paths' mode).  Returns the two gemma3-1b entries,
    timed (``device_ms`` as a CUDA graph)."""
    from repro_torch.dist.gossip import BUCKET_BYTES, plan_buckets
    from repro_torch.kernels import multi_tensor as mt
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantized_gossip import quantize_ef_many

    def check(name, xs, errs, offs, fmt, want_launches):
        before = (quantize_ef_many.launches, quantize_ef_many.segments)
        got = quantize_ef_many(xs, errs, key, offs, fmt=fmt)
        torch.cuda.synchronize()
        launches = quantize_ef_many.launches - before[0]
        segments = quantize_ef_many.segments - before[1]
        same = True
        for i, x in enumerate(xs):
            e = None if errs is None else errs[i]
            # row slices of the plain version, each at its own row offset:
            # the same bits, a fraction of the plain version's memory
            step = max(1, (1 << 24) // x.shape[1])
            for a in range(0, x.shape[0], step):
                b = min(a + step, x.shape[0])
                want = ref.quantize_ef_ref(
                    x[a:b], None if e is None else e[a:b], key, offs[i] + a,
                    fmt=fmt)
                same &= all(torch.equal(g[i][a:b].view(torch.uint8),
                                        w.view(torch.uint8))
                            for g, w in zip(got, want))
                del want
        del got
        mode = "no" if errs is None else (
            "mixed" if any(e is None for e in errs) else "yes")
        print(f"[quantize] grouped {name} {fmt} err={mode}: {launches} "
              f"launch(es) over {segments} buffers, bitwise {same}")
        if not same or launches != want_launches:
            raise SystemExit(f"quantize_ef_many {name} {fmt}: bitwise {same}"
                             f", {launches} launches (expected "
                             f"{want_launches})")

    # (R, C, row_offset, case, unaligned)
    specs = [(15, 256, 0, None, False), (7, 2, 3, None, False),
             (5, 6, 0, None, True), (33, 256, 11, None, True),
             (9, 1024, 0, None, False), (21, 250, 3, None, False),
             (24, 256, 0, "zero-rows", False),
             (40, 256, 0, "subnormal", False),
             (64, 256, (1 << 24) - 32, None, False),
             (17, 256, 5 * (1 << 24) + 3, None, False),
             (3, 1024, (1 << 22) - 1, None, True)]
    xs, errs, offs = [], [], []
    for R, C, off, case, unaligned in specs:
        x, e = inputs(R, C, case)
        if unaligned:
            x, e = _unaligned_like(torch, x), _unaligned_like(torch, e)
        xs.append(x)
        errs.append(e)
        offs.append(off)
    mixed = [e if i % 2 else None for i, e in enumerate(errs)]
    name = f"ragged ({len(xs)} buffers)"
    for fmt in ("int8", "fp8"):
        check(name, xs, errs, offs, fmt, 1)
        check(name, xs, None, offs, fmt, 1)
        check(name, xs, mixed, offs, fmt, 2)
    n = 2 * mt.capacity(5, mt.ROW_META_WORDS) + 3
    xs, errs = [], []
    for i in range(n):
        x, e = inputs(1 + i % 4, 256 if i % 3 else 6, None)
        xs.append(x)
        errs.append(e)
    check(f"{n} buffers, past one table", xs, errs,
          [4 * i for i in range(n)], "fp8", 3)
    del xs, errs, mixed

    entries = []
    for nodes, label, phase in (
            (1, "one rank", "dist-compress-quantize_ef_many"),
            (TRAIN_N, f"{TRAIN_N} nodes", "train-compress-quantize_ef_many")):
        rows = leaf_rows(torch, nodes)
        # rank 1's rows at one rank; the stacked nodes from row 0
        offs = rows if nodes == 1 else [0] * len(rows)
        buckets = len(plan_buckets([4 * r * CHUNK for r in rows],
                                   BUCKET_BYTES))
        xs = [torch.randn(r, CHUNK, generator=gen, device=dev) for r in rows]
        errs = [0.1 * torch.randn(r, CHUNK, generator=gen, device=dev)
                for r in rows]
        name = f"gemma3-1b, {len(rows)} reference leaves, {label}"
        check(name, xs, errs, offs, COMPRESS_CODEC, 1)
        numel = sum(rows) * CHUNK
        b_ms, b_by = bound_ms(13 * numel + 4 * sum(rows), 23 * numel,
                              "float32")

        def fn():
            return quantize_ef_many(xs, errs, ref.sr_key(0, 3), offs,
                                    fmt=COMPRESS_CODEC)

        def plain():
            for x, e, off in zip(xs, errs, offs):
                ref.quantize_ef_ref(x, e, ref.sr_key(0, 3), off,
                                    fmt=COMPRESS_CODEC)

        entry = {
            "name": f"quantize_ef_many[{len(rows)} leaves,{label},"
                    f"{COMPRESS_CODEC},err]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quantized_gossip.cu, "
                      "src/repro_torch/kernels/csrc/multi_tensor.cuh",
            "replaces": "src/repro/kernels/quantized_gossip.py:71",
            "launches": None,
            "segments": None,
            "max_abs_err": 0.0,
            "ms": time_ms(torch, fn, flush),
            "device_ms": graph_ms(torch, fn, flush),
            "plain_ms": time_ms(torch, plain, flush, runs=3, warmup=1),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        }
        print(f"[quantize] {entry['name']} ({numel / 1e9:.3f} B elements, "
              f"{len(rows)} buffers; the compressed path makes {buckets} "
              f"calls of it at {BUCKET_BYTES >> 20} MiB buckets): "
              f"{entry['ms']:.4f} ms, device (as a graph) "
              f"{entry['device_ms']:.4f} ms (bound {b_ms:.4f} ms by {b_by}; "
              f"plain {entry['plain_ms']:.4f} ms)")
        entries.append((phase, entry))
        del xs, errs
        torch.cuda.empty_cache()
    return entries


def paged_inputs(torch, dev, dtype, gen, *, ps, Tq, q0,
                 heads=(HEADS, KV_HEADS, HEAD_DIM),
                 seq=PROMPT + CONT_NEW + CONT_K):
    """The continuous path's paged attention operands for slot positions
    ``q0`` (a list): q (B, Tq, H, hd), pools of 8 x maxp + 1 pages of KV
    heads (maxp = ceil(seq / ps)), each slot's pages distinct, and NaN in
    scratch page 0 and in every page no slot names.  ``heads`` is (H, KV,
    hd), gemma3-1b's (4, 1, 256) by default; ``seq`` a slot's positions,
    1092 by default."""
    H, KV, hd = heads
    B, maxp = len(q0), -(-seq // ps)
    P = CONT_SLOTS * maxp + 1
    q = torch.randn(B, Tq, H, hd, generator=gen, device=dev)
    kp = torch.randn(P, ps, KV, hd, generator=gen, device=dev)
    vp = torch.randn(P, ps, KV, hd, generator=gen, device=dev)
    table = torch.zeros(B, maxp, dtype=torch.int32)
    used = torch.zeros(P, dtype=torch.bool)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(ps))
    for b, start in enumerate(q0):
        n = -(-(start + Tq) // ps)           # pages the slot has written
        table[b, :n] = perm[b * maxp:b * maxp + n] + 1
        used[table[b, :n].long()] = True
    kp[~used.to(dev)] = float("nan")
    vp[~used.to(dev)] = float("nan")
    q_start = torch.tensor(q0, dtype=torch.int32, device=dev)
    return (q.to(dtype), kp.to(dtype), vp.to(dtype), table.to(dev),
            q_start)


def phase_paged_kernels(torch, dev):
    """Paged flash attention vs plain on the card (``check_close``) at the
    continuous path's shapes and page sizes 8, 16, 32, 64; the verify
    window bitwise equal to one-row calls; returns (phase, JSON entry)
    for each timed bf16 path shape (page size 16)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.paged_flash_attention import \
        paged_flash_attention_fwd as paged

    flash = flash_attention_fwd
    gen = torch.Generator(device=dev).manual_seed(21)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # ragged slot positions, as mid-trace: fresh, page-boundary, past the
    # local window, near the end of the cache
    q0 = [64, 207, 351, 512, 640, 801, 1000, PROMPT + CONT_NEW - 2]
    entries = []
    print("[paged] case dtype max_abs_err worst_err/tol")
    for ps in (CONT_PAGE, 8, 32, 64):
        for Tq in (1, CONT_K + 1):
            for layer, window in (("local", LOCAL_WINDOW), ("global", None)):
                for dtype in (torch.bfloat16, torch.float32):
                    dname = str(dtype).split(".")[1]
                    q, kp, vp, table, qs = paged_inputs(
                        torch, dev, dtype, gen, ps=ps, Tq=Tq, q0=q0)
                    kw = dict(q_start=qs, k_valid_len=qs + Tq,
                              window=window)
                    want = ref.paged_sdpa_ref(q, kp, vp, table, **kw)
                    got = paged(q, kp, vp, table, **kw)
                    torch.cuda.synchronize()
                    err, worst, ok = check_close(torch, got, want)
                    kind = "decode" if Tq == 1 else "verify"
                    name = f"{kind},{layer},ps={ps}"
                    print(f"[paged] {name} {dname} {err:.3e} {worst:.3f} "
                          f"({_launch_line(paged)})")
                    if not ok or bool(got.isnan().any()):
                        raise SystemExit(f"paged attention {name} {dname}: "
                                         f"max abs err {err}, {worst} x "
                                         f"its tolerance")
                    if Tq > 1:      # the row contract, bit for bit
                        for i in range(Tq):
                            one = paged(q[:, i:i + 1], kp, vp, table,
                                        q_start=qs + i,
                                        k_valid_len=qs + i + 1,
                                        window=window)
                            if not torch.equal(_bits(torch, one), _bits(
                                    torch, got[:, i:i + 1])):
                                raise SystemExit(
                                    f"paged attention {name} {dname}: "
                                    f"verify row {i} differs from its "
                                    f"one-row call")
                        print(f"[paged]   verify window == {Tq} one-row "
                              f"calls bitwise")
                    if ps == CONT_PAGE:
                        paged_row_contract(torch, flash, paged, name, dname,
                                           got, q, kp, vp, table, kw)
                    if not (ps == CONT_PAGE and dtype == torch.bfloat16):
                        continue
                    entries.append(paged_entry(torch, dev, flush, F, ref,
                                               paged, kind, layer, window,
                                               q, kp, vp, table, qs, err))
    del flush
    torch.cuda.empty_cache()
    return entries


def paged_row_contract(torch, flash, paged, name, dname, got, q, kp, vp,
                       table, kw):
    """At the continuous path's shapes, bit for bit: the chosen split
    (``got``) equals kv_splits=1 and splits 2, 9, 17; a decode row (Tq
    = 1) equals the dense kernel's over the gathered pages."""
    base = paged(q, kp, vp, table, kv_splits=1, **kw)
    for splits, out in ((None, got), *((n, paged(q, kp, vp, table,
                                                 kv_splits=n, **kw))
                                       for n in (2, 9, 17))):
        if not torch.equal(_bits(torch, out), _bits(torch, base)):
            raise SystemExit(f"paged attention {name} {dname}: split "
                             f"{splits} differs from unsplit")
    line = "the chosen split and splits 2, 9, 17 == unsplit"
    if q.shape[1] == 1:
        B, S = table.shape[0], table.shape[1] * kp.shape[1]
        kd = kp[table.long()].reshape(B, S, *kp.shape[2:])
        vd = vp[table.long()].reshape(B, S, *vp.shape[2:])
        dense = flash(q, kd, vd, **kw)
        if not torch.equal(_bits(torch, dense), _bits(torch, got)):
            raise SystemExit(f"paged attention {name} {dname}: the dense "
                             f"kernel over the same bits differs")
        line += f"; == the dense kernel ({_launch_line(flash)})"
    print(f"[paged]   {line}, bitwise")


def paged_entry(torch, dev, flush, F, ref, paged, kind, layer, window, q,
                kp, vp, table, qs, err, phase=None, softcap=None):
    """The timed JSON entry of one bf16 path shape; ``phase`` names the
    path whose launches it reports (by default the continuous path's
    decode or speculative verify).  With a ``softcap`` SDPA computes
    another function: ``library_ms`` is null, and SDPA without the
    softcap stands beside it."""
    B, Tq, H, D = q.shape
    KV = kp.shape[2]
    kw = dict(q_start=qs, k_valid_len=qs + Tq, window=window,
              softcap=softcap)
    # the yardstick: SDPA on the dense view gathered beforehand (no
    # PyTorch call takes a block table), keys past k_valid zeroed
    S = table.shape[1] * kp.shape[1]
    kpos = torch.arange(S, device=dev)
    valid = kpos[None, :] < (qs + Tq)[:, None].long()             # (B, S)
    kd = torch.where(valid[..., None, None],
                     kp[table.long()].reshape(B, S, KV, -1), 0)
    vd = torch.where(valid[..., None, None],
                     vp[table.long()].reshape(B, S, KV, -1), 0)
    qpos = qs[:, None].long() + torch.arange(Tq, device=dev)       # (B, Tq)
    mask = (kpos[None, None, :] <= qpos[..., None]) & valid[:, None, :]
    if window:
        mask &= kpos[None, None, :] > qpos[..., None] - window
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kd, vd))
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask[:, None], scale=D ** -0.5,
        enable_gqa=True)
    nbytes = flops = 0
    for start in qs.tolist():
        nb, fl = attention_work(B=1, Tq=Tq, H=H, KV=KV, D=D, Dv=D, q0=start,
                                k_valid=start + Tq, window=window,
                                elt=q.element_size())
        nbytes += nb + 4 * -(-(start + Tq) // kp.shape[1])   # table reads
        flops += fl
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    lib_ms, lib_dev = time_ms(torch, lib, flush), graph_ms(torch, lib, flush)
    entry = {
        "name": f"paged_flash_attention[{kind},{layer},bfloat16]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_flash_attention.cu, "
                  "src/repro_torch/kernels/csrc/flash_core.cuh",
        "replaces": "src/repro/kernels/flash_attention.py:216",
        "launches": None,
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: paged(q, kp, vp, table, **kw), flush),
        "plain_ms": time_ms(torch, lambda: ref.paged_sdpa_ref(
            q, kp, vp, table, **kw), flush),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None if softcap is not None else lib_ms,
        "device_ms": graph_ms(torch, lambda: paged(q, kp, vp, table, **kw),
                              flush),
        "library_device_ms": None if softcap is not None else lib_dev,
    }
    if softcap is not None:
        entry["sdpa_without_softcap_ms"] = lib_ms
        entry["sdpa_without_softcap_device_ms"] = lib_dev
    print(f"[paged] {entry['name']}: {entry['ms']:.4f} ms (bound "
          f"{b_ms:.5f} ms by {b_by}, {nbytes} B; plain "
          f"{entry['plain_ms']:.4f} ms; sdpa on the gathered view"
          f"{' without the softcap' if softcap else ''} {lib_ms:.4f} ms; "
          f"device, as a graph: {entry['device_ms']:.4f} ms, sdpa "
          f"{lib_dev:.4f} ms)")
    if phase is None:
        phase = "continuous-paged" if kind == "decode" else \
            "continuous-spec-paged"
    return phase, entry


def continuous_engine(torch, dev, cfg, new=CONT_NEW, **kw):
    from repro_torch.models.model import PagedCacheLayout
    from repro_torch.serve import ContinuousEngine, prompt_buckets
    maxp = -(-(PROMPT + new + CONT_K) // CONT_PAGE)
    layout = PagedCacheLayout(page_size=CONT_PAGE,
                              num_pages=CONT_SLOTS * maxp + 1,
                              max_pages_per_slot=maxp)
    return ContinuousEngine(
        cfg, slots=CONT_SLOTS, layout=layout, max_new=new,
        buckets=prompt_buckets(PROMPT, min_bucket=CONT_PAGE),
        param_dtype=torch.bfloat16, cache_dtype=torch.bfloat16, device=dev,
        **kw)


def phase_continuous(torch, dev, card, params, spec=False,
                     requests=CONT_REQUESTS, new=CONT_NEW, tag=None,
                     phase=None):
    """``[continuous]`` (or ``[continuous-spec]``): the full-width trace
    of ``requests`` requests, ``new`` tokens each, through the continuous
    engine, the paged kernel's launches counted from zero; returns its
    launches by phase (``phase``, or the path's own name)."""
    from repro_torch import trace
    from repro_torch.kernels.paged_flash_attention import \
        paged_flash_attention_fwd
    from repro_torch.models.blocks import layer_caches
    from repro_torch.serve import poisson_trace

    cfg = params.cfg
    tag = tag or ("[continuous-spec]" if spec else "[continuous]")
    reqs = poisson_trace(requests, rate=CONT_RATE, seed=0,
                         min_prompt=CONT_MIN_PROMPT, max_prompt=PROMPT,
                         vocab_size=cfg.vocab_size)
    kw = {}
    if spec:
        reqs = reqs[:CONT_SPEC_REQUESTS]
        kw = dict(speculate_k=CONT_K, draft_layers=CONT_DRAFT,
                  prefill_batch=2)
    eng = continuous_engine(torch, dev, cfg, new=new, **kw)
    pool_bytes = sum(t.numel() * t.element_size()
                     for c in layer_caches(eng.pools) for t in c.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paged_flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    with trace.cuda_marks() as marks:
        out = eng.run(params, reqs)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_flash_attention_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    st = out["stats"]
    n_tok = st["generated_tokens"]
    if st["requests"] != len(reqs) or n_tok != len(reqs) * new or any(
            len(r.tokens) != new or not all(0 <= t < cfg.vocab_size
                                            for t in r.tokens)
            for r in out["results"].values()):
        raise SystemExit(f"{tag} the trace did not drain: {st}")
    steps = st["dispatches"]["decode"]
    prologue, per_block = len(cfg.prologue), len(cfg.pattern)
    per_step = cfg.num_layers + (
        CONT_K * (prologue + CONT_DRAFT * per_block) if spec else 0)
    if launches != steps * per_step:
        raise SystemExit(f"{tag} paged attention launched {launches} times "
                         f"in {steps} decode steps, expected "
                         f"{steps * per_step}")
    spans = {}
    for (name, a), (end, b) in zip(marks[::2], marks[1::2]):
        if end != "end":
            raise SystemExit(f"{tag} unexpected marks {name}, {end}")
        spans.setdefault(name, []).append(a.elapsed_time(b))
    dec = spans.pop("decode")
    print(f"{tag} {card}: {len(reqs)} requests, {n_tok} tokens in {steps} "
          f"decode steps; wall {wall:.3f} s, {n_tok / wall:.1f} generated "
          f"tokens/s")
    print(f"{tag} decode {statistics.median(dec):.3f} ms/step (median of "
          f"{len(dec)}, CUDA events; min {min(dec):.3f}, max "
          f"{max(dec):.3f}); {launches} paged attention launches (= "
          f"{per_step} per step x {steps})")
    for name in sorted(spans, key=lambda n: int(n.split("_")[1]
                                                .split("x")[0])):
        print(f"{tag} {name}: {len(spans[name])} calls, median "
              f"{statistics.median(spans[name]):.3f} ms")
    print(f"{tag} slot utilization {st['slot_utilization']:.4f}, waits "
          f"p50 {st['wait_p50_steps']:.3f} / p99 {st['wait_p99_steps']:.3f} "
          f"steps, executables {st['executables']} (buckets "
          f"{st['buckets_used']}); pools {pool_bytes / 1e6:.1f} MB; peak "
          f"memory {peak / 2**30:.2f} GiB (max_memory_allocated)")
    if spec:
        sp = st["speculative"]
        print(f"{tag} k={CONT_K}, draft {CONT_DRAFT} of {cfg.num_blocks} "
              f"blocks: {sp['rounds']} slot rounds, acceptance "
              f"{sp['acceptance_rate']:.4f} ({sp['accepted']} of "
              f"{sp['drafted']}), {sp['tokens_per_round']:.4f} tokens per "
              f"round")
    del eng
    torch.cuda.empty_cache()
    return {phase or ("continuous-spec-paged" if spec
                      else "continuous-paged"): launches}


def phase_continuous_cpu_vs_card(torch, dev):
    """The continuous engine on the card against the CPU, plain and
    speculative; and a verify pass's logits against one-row passes' on
    the card (what the kernel's row contract does not cover)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.model import PagedCacheLayout
    from repro_torch.serve import ContinuousEngine, poisson_trace

    cfg = get_config("gemma3-1b").reduced()
    cpu = M.init(cfg, seed=3, dtype=torch.float32, device="cpu")
    card = M.Model(cfg, dtype=torch.float32, device=dev)
    card.load_state_dict(cpu.state_dict())
    reqs = poisson_trace(10, rate=0.8, seed=4, min_prompt=3, max_prompt=30,
                         vocab_size=cfg.vocab_size)
    layout = PagedCacheLayout(page_size=8, num_pages=4 * 6 + 1,
                              max_pages_per_slot=6)
    toks = {}
    for kw in ({}, dict(speculate_k=2, draft_layers=0)):
        out = {}
        for name, params, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
            eng = ContinuousEngine(cfg, slots=4, layout=layout, max_new=8,
                                   buckets=(8, 16, 32),
                                   param_dtype=torch.float32,
                                   cache_dtype=torch.float32, device=d, **kw)
            out[name] = eng.run(params, reqs)
        mode = "speculate_k=2" if kw else "plain"
        same = all(out["card"]["results"][r].tokens == res.tokens
                   for r, res in out["cpu"]["results"].items())
        stats = out["card"]["stats"] == out["cpu"]["stats"]
        print(f"[continuous-cpu-vs-card] reduced gemma3-1b f32, {mode}: "
              f"tokens equal {same}, stats equal {stats}")
        if not (same and stats):
            raise SystemExit(f"continuous engine {mode}: card and cpu differ")
        toks[mode] = out["card"]["results"]
    spec_same = all(toks["plain"][r].tokens == toks["speculate_k=2"][r]
                    .tokens for r in toks["plain"])
    # a 3-row verify pass against 3 one-row passes from the same state
    lay = PagedCacheLayout(page_size=8, num_pages=7, max_pages_per_slot=3)
    table = torch.arange(1, 7, dtype=torch.int32, device=dev).reshape(2, 3)
    tok = torch.randint(0, cfg.vocab_size, (2, 12),
                        generator=torch.Generator().manual_seed(9)).to(dev)
    logits = []
    with torch.inference_mode():
        for rows in (3, 1):
            pools = M.init_paged_cache(cfg, lay, torch.float32, dev)
            pos = torch.zeros(2, dtype=torch.int64, device=dev)
            M.decode_step(cfg, card, pools, tok[:, :9], pos,
                          decode_mode="paged", block_table=table)
            lg = [M.decode_step(cfg, card, pools, tok[:, 9 + i:9 + i + rows],
                                pos + 9 + i, decode_mode="paged",
                                block_table=table)[0]
                  for i in range(0, 3, rows)]
            logits.append(torch.cat(lg, dim=1))
    diff = float((logits[0] - logits[1]).abs().max())
    print(f"[continuous-cpu-vs-card] on the card, speculative tokens equal "
          f"plain tokens: {spec_same}; a 3-row verify pass vs 3 one-row "
          f"passes from the same state: logits max abs diff {diff:.3e} "
          f"(the paged kernel's rows are bitwise; cuBLAS rounds a 6-row "
          f"and a 2-row product differently where this is nonzero)")


def phase_main_path(torch, dev, card):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import model as M
    from repro_torch.serve import make_engine

    cfg = get_config("gemma3-1b")
    t0 = time.perf_counter()
    params = M.init(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[main] gemma3-1b full width: {cfg.num_layers} layers, "
          f"{n_params / 1e9:.3f} B params in bf16, init "
          f"{time.perf_counter() - t0:.1f}s")
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device=dev)
    engine = make_engine(cfg, batch=BATCH, prompt_len=PROMPT, max_new=NEW,
                         param_dtype=torch.bfloat16,
                         cache_dtype=torch.bfloat16, device=dev)
    engine.generate(params, {"tokens": tokens})          # warm-up
    torch.cuda.synchronize()

    flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    res = engine.generate_with_state(params, {"tokens": tokens})
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"generation": flash_attention_fwd.launches}

    # each phase alone, timed, its launches counted from zero
    with torch.inference_mode():
        flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        logits, caches = M.prefill(cfg, params, {"tokens": tokens}, SEQ,
                                   torch.bfloat16)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches["prefill"] = flash_attention_fwd.launches
        tok = logits[:, -1].argmax(-1)
        steps = [tok]
        flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        for i in range(1, NEW):                          # greedy, as above
            logits, caches = M.decode_step(cfg, params, caches, tok[:, None],
                                           PROMPT + i - 1)
            tok = logits[:, -1].argmax(-1)
            steps.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        launches["decode"] = flash_attention_fwd.launches

    L = cfg.num_layers
    for phase, want in (("generation", L * NEW), ("prefill", L),
                        ("decode", L * (NEW - 1))):
        if launches[phase] != want:
            raise SystemExit(f"flash attention launched {launches[phase]} "
                             f"times in the {phase}, expected {want}")
    toks = res.tokens
    if toks.shape != (BATCH, NEW) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise SystemExit(f"bad tokens: shape {tuple(toks.shape)}")
    print(f"[main] {card}: generation {total_s * 1e3:.2f} ms "
          f"(prefill {prefill_s * 1e3:.2f} ms, decode "
          f"{decode_s / (NEW - 1) * 1e3:.3f} ms/step alone, "
          f"{(total_s - prefill_s) / (NEW - 1) * 1e3:.3f} ms/step as "
          f"(generation - prefill) / {NEW - 1}), "
          f"{BATCH * NEW / total_s:.1f} tokens/s end to end, "
          f"{BATCH * (NEW - 1) / decode_s:.1f} decode tokens/s")
    # floors: a decode step reads every weight once (the tied table for
    # the logits included); prefill does 2 FLOPs per non-embedding weight
    # per prompt token
    n_embed = cfg.vocab_size * cfg.d_model
    decode_floor = n_params * 2 / H100_BYTES_PER_S * 1e3
    prefill_floor = (2.0 * (n_params - n_embed) * BATCH * PROMPT
                     / PEAK_FLOPS["bfloat16"] * 1e3)
    print(f"[main] floors: prefill >= {prefill_floor:.3f} ms (operations), "
          f"decode >= {decode_floor:.3f} ms/step (bytes of weights)")
    print(f"[main] flash attention launches: generation "
          f"{launches['generation']} (= {L} layers x {NEW} model passes), "
          f"prefill {launches['prefill']}, decode {launches['decode']}")
    print(f"[main] first tokens: {toks[:, :8].tolist()}; the phases alone "
          f"give the engine's tokens: "
          f"{torch.equal(torch.stack(steps, 1), toks)}")
    return launches, params, engine, tokens, res.tokens


class plain_attention_calls:
    """Counts, inside the block, every call of the plain attention
    versions and of PyTorch's SDPA: a path that runs the kernels makes
    none."""

    def __enter__(self):
        import torch.nn.functional as F

        from repro_torch.kernels import ref
        self.calls = 0
        self.saved = [(ref, n, getattr(ref, n)) for n in (
            "grouped_sdpa_ref", "grouped_sdpa_decode_ref", "paged_sdpa_ref")]
        self.saved.append((F, "scaled_dot_product_attention",
                           F.scaled_dot_product_attention))
        for mod, name, fn in self.saved:
            setattr(mod, name, self._counted(fn))
        return self

    def _counted(self, fn):
        def call(*a, **k):
            self.calls += 1
            return fn(*a, **k)
        return call

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def serve_floors(cfg, params, batch, prompt, prefix=0, frames=0,
                 cache_len=0):
    """The least time of one prefill and of one decode step on the card,
    from the weights: a decode step reads every weight it uses once (the
    tied table for the logits; an untied model's input table, of which it
    reads B rows, and its MTP layer are left out); prefill does 2 FLOPs
    per weight per position (the ``prefix`` embeddings and the prompt),
    an MoE layer's experts only on the E x C slots its capacity gives
    the tokens (attention, the SSD scan and the output head, at the last
    position only, not counted).  With C = 1 at decode every expert is
    read.  A decode step also reads and writes each Mamba layer's state
    once: the f32 SSM state (B, h, p, n) and the bf16 conv history (B,
    K - 1, conv_dim).  An encoder-decoder's encoder runs over the
    ``frames`` in prefill only; its cross-attention K/V projections run
    over the frames in prefill and again in every decode step (the
    reference recomputes them), which a decode step's floor counts as
    operations beside the bytes.  ``cache_len`` > 0 adds the bf16 K/V
    rows a decode step reads from the cache (the earlier phases leave
    them out).  Returns (prefill ms, decode ms)."""
    from repro_torch.models.moe import capacity

    tokens = batch * (prompt + prefix)
    src = batch * frames
    read = flops = step_flops = state = 0
    if cfg.ssm is not None:
        s = cfg.ssm
        d_in, h = s.d_inner(cfg.d_model), s.nheads(cfg.d_model)
        per_layer = batch * (4 * h * s.headdim * s.d_state
                             + 2 * (s.d_conv - 1) * (d_in + 2 * s.d_state))
        state = 2 * per_layer * mamba_layers(cfg)
    for name, p in params.named_parameters():
        n = p.numel()
        if name.startswith("mtp."):
            continue
        if name in ("embed.table", "lm_head.w"):
            read += n if name == "lm_head.w" or cfg.tie_embeddings else 0
            continue
        if name.startswith("encoder."):
            flops += 2.0 * n * src
            continue
        read += n
        if ".cross.wk." in name or ".cross.wv." in name:
            flops += 2.0 * n * src
            step_flops += 2.0 * n * src
        elif ".moe.w_" in name:        # (E, D, F) or (E, F, D) experts
            flops += 2.0 * n * capacity(tokens, cfg.moe)
        else:
            flops += 2.0 * n * tokens
    kv = 2 * batch * cache_len * 2 * cfg.num_kv_heads * cfg.head_dim \
        * attention_layers(cfg)
    step_bytes = 2.0 * read + state + kv + 2 * src * cfg.d_model
    return (flops / PEAK_FLOPS["bfloat16"] * 1e3,
            max(step_bytes / H100_BYTES_PER_S,
                step_flops / PEAK_FLOPS["bfloat16"]) * 1e3)


def attention_layers(cfg) -> int:
    """The layers of ``cfg`` that attend (each launches the flash kernel
    once per model pass); the MTP layer is not counted."""
    return len(cfg.prologue) + cfg.num_blocks * len(cfg.pattern) \
        - mamba_layers(cfg)


def mamba_layers(cfg) -> int:
    return sum(s.kind == "mamba" for s in cfg.prologue) \
        + cfg.num_blocks * sum(s.kind == "mamba" for s in cfg.pattern)


def flash_calls(cfg) -> int:
    """Flash launches of one decoder pass: each attention layer's, and
    each cross-attention layer's second one."""
    return attention_layers(cfg) + cfg.num_blocks * sum(
        s.cross_attn for s in cfg.pattern)


def encoder_layers(cfg) -> int:
    """Flash launches of one encoder pass (0 without an encoder)."""
    return 0 if cfg.encoder is None else cfg.encoder.num_layers


def fit_blocks(torch, cfg, tag, seq):
    """The most pattern blocks of ``cfg`` whose bf16 weights and K/V cache
    (``ZOO_BATCH`` x ``seq`` positions), with ``FIT_MARGIN`` bytes of
    transients beside them, fit the card's free memory (all of them where
    they fit).  Prints the free memory and the reckoning."""
    from repro_torch.models import model as M
    free, _ = torch.cuda.mem_get_info()
    meta = M.Model(cfg, dtype=torch.bfloat16, device="meta")
    per_block = sum(p.numel() for p in meta.stack.blocks[0].parameters())
    rest = sum(p.numel() for p in meta.parameters()) \
        - per_block * cfg.num_blocks
    one = dataclasses.replace(cfg, prologue=(), num_blocks=1)
    kv_block = 2 * 2 * ZOO_BATCH * seq * cfg.num_kv_heads * cfg.head_dim \
        * attention_layers(one)
    fit = int((free - FIT_MARGIN - 2 * rest) // (2 * per_block + kv_block))
    blocks = max(1, min(cfg.num_blocks, fit))
    need = 2 * rest + blocks * (2 * per_block + kv_block)
    print(f"{tag} free memory before init {free / 2**30:.2f} GiB; "
          f"{blocks} of {cfg.num_blocks} blocks fit: weights and K/V cache "
          f"{need / 2**30:.2f} GiB (a block {2 * per_block / 2**30:.3f} GiB "
          f"+ {kv_block / 2**30:.3f} GiB of cache), "
          f"{FIT_MARGIN / 2**30:.0f} GiB kept for transients")
    return blocks


def phase_zoo_serve(torch, dev, card, arch, blocks=None, pattern=None,
                    kind=None, prompt=None, stub_len=0):
    """``[zoo-serve]``: full-width ``arch`` in bf16 (random weights from a
    seed) through ``make_engine``, B=4 prompts of ``ZOO_PROMPTS[arch]``
    tokens, 32 greedy tokens: a warm-up generation, then a timed one
    whose flash launches are counted (layers x 32 passes) with no plain
    attention or SDPA call; then prefill and the decode steps each alone,
    timed, giving the engine's tokens.  For granite-8b, ``[zoo-continuous]``
    on the same weights.  With ``blocks`` (the MoE family) it is
    ``[moe-serve]``: the depth cut to that many pattern blocks, prompts
    of ``MOE_PROMPT``, and for grok-1-314b ``[moe-continuous]``; with
    ``pattern`` as well, only the first that many layers of the pattern
    are kept (``[hybrid-serve]``, jamba).  ``kind`` names the phase
    (``[ssm-serve]``: mamba2 at full depth).  With ``stub_len`` the batch
    carries a frontend's stub embeddings from a stream of their own:
    llava's prefix (``[vlm-serve]``, ``make_engine(prefix_len=...)``) or
    seamless's encoder frames (``[encdec-serve]``); the depth is cut to
    the most blocks whose weights, cache and transients fit the free
    memory, printed, and full where they fit.  The flash launches
    asserted are the attention layers' (none for mamba2), a
    cross-attention layer's twice, and the encoder's once a generation.
    The timed generation's caches are dropped before prefill and decode
    are timed alone.  Returns the launches by phase."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import model as M
    from repro_torch.models.frontends import stub_inputs
    from repro_torch.serve import make_engine

    cfg = get_config(arch)
    kind = kind or ("zoo" if blocks is None else "moe")
    tag = f"[{kind}-serve] {arch}"
    depth = ""
    if pattern is not None:
        depth = (f" (pattern cut: the first {pattern} of its "
                 f"{len(cfg.pattern)} layers)")
        cfg = dataclasses.replace(cfg, pattern=cfg.pattern[:pattern])
    prompt = prompt or ZOO_PROMPTS.get(arch, MOE_PROMPT)
    prefix = stub_len if cfg.frontend == "vision" else 0
    frames = stub_len if cfg.frontend == "audio" else 0
    index0 = prompt + prefix
    seq = index0 + ZOO_NEW
    if stub_len:
        blocks = fit_blocks(torch, cfg, tag, seq)
    if blocks is not None and blocks != cfg.num_blocks:
        depth += f" (depth cut: {blocks} of {cfg.num_blocks} blocks)"
        cfg = dataclasses.replace(cfg, num_blocks=blocks)
    L, E = flash_calls(cfg), encoder_layers(cfg)
    t0 = time.perf_counter()
    params = M.init(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    ssm = "" if cfg.ssm is None else (
        f", {mamba_layers(cfg)} Mamba-2 layers of "
        f"{cfg.ssm.nheads(cfg.d_model)} SSD heads of {cfg.ssm.headdim}, "
        f"state {cfg.ssm.d_state}, chunk {cfg.ssm.chunk}")
    n_cross = L - attention_layers(cfg)
    stub = "" if not stub_len else (
        f", {prefix} prefix embeddings" if prefix else
        f", an encoder of {E} layers over {frames} frames, {n_cross} "
        f"cross-attention layers")
    print(f"{tag} full width{depth}: {cfg.num_layers} layers, d "
          f"{cfg.d_model}, {attention_layers(cfg)} attention layers of "
          f"{cfg.num_heads} q / {cfg.num_kv_heads} kv heads of "
          f"{cfg.head_dim}{ssm}{stub}, {n_params / 1e9:.3f} B params in "
          f"bf16 ({2 * n_params / 1e9:.2f} GB), init "
          f"{time.perf_counter() - t0:.1f}s")
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (ZOO_BATCH, prompt),
                           generator=gen, device=dev)
    gen.manual_seed(STUB_SEED)
    inputs = {"tokens": tokens, **stub_inputs(
        cfg, gen, ZOO_BATCH, stub_len, torch.bfloat16, dev)}
    engine = make_engine(cfg, batch=ZOO_BATCH, prompt_len=prompt,
                         max_new=ZOO_NEW, prefix_len=prefix,
                         param_dtype=torch.bfloat16,
                         cache_dtype=torch.bfloat16, device=dev)
    engine.generate(params, inputs)                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    with plain_attention_calls() as plain:
        flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        res = engine.generate_with_state(params, inputs)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches["generation"] = flash_attention_fwd.launches
        peak = torch.cuda.max_memory_allocated()
        toks = res.tokens
        del res                      # its caches, before prefill alone
        with torch.inference_mode():
            flash_attention_fwd.launches = 0
            t0 = time.perf_counter()
            logits, caches = M.prefill(cfg, params, inputs, seq,
                                       torch.bfloat16)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            launches["prefill"] = flash_attention_fwd.launches
            tok = logits[:, -1].argmax(-1)
            steps = [tok]
            flash_attention_fwd.launches = 0
            t0 = time.perf_counter()
            for i in range(1, ZOO_NEW):
                logits, caches = M.decode_step(cfg, params, caches,
                                               tok[:, None], index0 + i - 1)
                tok = logits[:, -1].argmax(-1)
                steps.append(tok)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
            launches["decode"] = flash_attention_fwd.launches
        del caches, logits
    for what, want in (("generation", E + L * ZOO_NEW), ("prefill", E + L),
                       ("decode", L * (ZOO_NEW - 1))):
        if launches[what] != want or plain.calls:
            raise SystemExit(f"{tag}: flash attention launched "
                             f"{launches[what]} times in the {what}, "
                             f"expected {want}; {plain.calls} plain or SDPA "
                             f"calls")
    same = torch.equal(torch.stack(steps, 1), toks)
    if toks.shape != (ZOO_BATCH, ZOO_NEW) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()) or not same:
        raise SystemExit(f"{tag}: bad tokens, shape {tuple(toks.shape)}, "
                         f"the phases alone give the engine's: {same}")
    print(f"{tag} {card}: generation {total_s * 1e3:.2f} ms (prefill "
          f"{prefill_s * 1e3:.2f} ms, decode "
          f"{decode_s / (ZOO_NEW - 1) * 1e3:.3f} ms/step alone), "
          f"{ZOO_BATCH * ZOO_NEW / total_s:.1f} tokens/s end to end, "
          f"{ZOO_BATCH * (ZOO_NEW - 1) / decode_s:.1f} decode tokens/s; "
          f"peak memory {peak / 2**30:.2f} GiB (max_memory_allocated)")
    prefill_floor, decode_floor = serve_floors(
        cfg, params, ZOO_BATCH, prompt, prefix=prefix, frames=frames,
        cache_len=seq - 1 if stub_len else 0)
    enc = "; the encoder and the cross K/V over the frames"
    print(f"{tag} floors: prefill >= {prefill_floor:.3f} ms (operations; "
          f"{'experts on E x C slots, ' if cfg.moe else ''}attention"
          f"{' and the SSD scan' if cfg.ssm else ''} not counted"
          f"{enc * bool(frames)}), decode >= {decode_floor:.3f} ms/step "
          f"(bytes of the weights a step reads"
          f"{', and each Mamba state read and written' * bool(cfg.ssm)}"
          f"{', the K/V cache at its last step' * bool(stub_len)}"
          f"{'; the cross K/V projections as operations' * bool(frames)})")
    print(f"{tag} flash attention launches: generation "
          f"{launches['generation']} (= {E} encoder layers + {L} attention "
          f"calls x {ZOO_NEW} model passes), prefill {launches['prefill']}, "
          f"decode {launches['decode']}; plain or SDPA calls 0; first tokens "
          f"{toks[:, :6].tolist()}")
    out = {f"{kind}-serve-{arch}": launches["generation"]}
    del engine, toks, steps, tokens, inputs
    torch.cuda.empty_cache()
    if arch in (ZOO_CONT_ARCH, MOE_CONT_ARCH):
        with plain_attention_calls() as plain:
            out.update(phase_continuous(
                torch, dev, card, params, requests=ZOO_CONT_REQUESTS,
                new=ZOO_NEW, tag=f"[{kind}-continuous] {arch}",
                phase=f"{kind}-continuous-paged"))
        if plain.calls:
            raise SystemExit(f"[{kind}-continuous] {plain.calls} plain or "
                             f"SDPA calls")
    del params
    torch.cuda.empty_cache()
    return out


def phase_spec(torch, dev, card, params, tokens, plain):
    """``[spec]``: the fixed-batch engine speculating on the ``[main]``
    cell (B=4 prompts of 1024, 64 greedy tokens, k = 4), self-speculative
    through 2 of the 4 pattern blocks and through a 1-block draft model
    of gemma3-1b's widths (random weights, seed 2), beside the plain
    engine.  After a warm-up of each, ``SPEC_REPS`` rounds of one timed
    generation per engine, in turn; in each, the flash kernel's launches
    counted from zero and every plain attention or SDPA call counted
    (there must be none), the speculative rounds split by CUDA events.
    Tokens against ``[main]``'s plain greedy ``plain``.  Returns the
    launches of the two speculative engines' first timed runs."""
    import dataclasses

    from repro_torch import trace
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import model as M
    from repro_torch.serve import make_engine

    cfg = params.cfg
    dcfg = dataclasses.replace(cfg, num_blocks=1)
    dparams = M.init(dcfg, seed=2, dtype=torch.bfloat16, device=dev)
    L, pro, blk = cfg.num_layers, len(cfg.prologue), len(cfg.pattern)
    batch = {"tokens": tokens}
    kw = dict(batch=BATCH, prompt_len=PROMPT, max_new=NEW,
              param_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
              device=dev)
    engines = {
        "plain": (make_engine(cfg, **kw), None),
        "self": (make_engine(cfg, speculate_k=SPEC_K,
                             draft_layers=SPEC_DRAFT, **kw), None),
        "draft_cfg": (make_engine(cfg, speculate_k=SPEC_K, draft_cfg=dcfg,
                                  **kw), dparams)}
    for eng, dp in engines.values():
        eng.generate(params, batch, draft_params=dp)          # warm-up
    torch.cuda.synchronize()

    def want_launches(name, rounds):
        if name == "plain":
            return L * NEW, L
        if name == "self":
            # prefill: every layer; a round: k draft steps through the
            # prologue and SPEC_DRAFT blocks, one verify through all
            return L, SPEC_K * (pro + SPEC_DRAFT * blk) + L
        # prefill: the target's layers and the draft's; a round: k
        # draft steps and the write-only step through the draft's
        # layers, one verify through the target's
        return L + dcfg.num_layers, (SPEC_K + 1) * dcfg.num_layers + L

    runs = {name: [] for name in engines}
    with plain_attention_calls() as counted:
        for _ in range(SPEC_REPS):
            for name, (eng, dp) in engines.items():
                torch.cuda.reset_peak_memory_stats()
                flash_attention_fwd.launches = 0
                t0 = time.perf_counter()
                with trace.cuda_marks() as marks:
                    res = eng.generate_with_state(params, batch,
                                                  draft_params=dp)
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                rounds = 0 if res.spec is None \
                    else int(res.spec.rounds.max())      # the loop's
                fixed, per_round = want_launches(name, rounds)
                want = fixed + rounds * per_round if rounds else fixed
                if flash_attention_fwd.launches != want or counted.calls:
                    raise SystemExit(
                        f"[spec] {name}: flash attention launched "
                        f"{flash_attention_fwd.launches} times, expected "
                        f"{want} (= {fixed} + {rounds} rounds x "
                        f"{per_round}); {counted.calls} plain or SDPA "
                        f"calls")
                runs[name].append(dict(
                    wall=wall, launches=want, res=res,
                    peak=torch.cuda.max_memory_allocated(),
                    spans=_step_spans(marks, start="round")))
                del marks
    walls = {n: sorted(r["wall"] for r in rs) for n, rs in runs.items()}
    base = statistics.median(walls["plain"])
    for name, rs in runs.items():
        res, wall = rs[0]["res"], statistics.median(walls[name])
        toks = res.tokens
        if toks.shape != (BATCH, NEW) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()) \
                or not bool((res.lengths == NEW).all()) \
                or any(not torch.equal(r["res"].tokens, toks) for r in rs):
            raise SystemExit(f"[spec] {name}: bad or unsteady tokens, shape "
                             f"{tuple(toks.shape)}")
        diff = (toks != plain).nonzero().tolist()
        head = (f"[spec] {card}, {name}: generation {wall * 1e3:.2f} ms "
                f"(median of {len(rs)}: "
                f"{', '.join(f'{w * 1e3:.2f}' for w in walls[name])}), "
                f"{BATCH * NEW / wall:.1f} tokens/s end to end, "
                f"{base / wall:.4f}x the plain engine's speed; peak memory "
                f"{max(r['peak'] for r in rs) / 2**30:.2f} GiB "
                f"(max_memory_allocated); tokens equal to [main]'s: "
                f"{BATCH * NEW - len(diff)} of {BATCH * NEW}, first "
                f"divergence (request, column): "
                f"{min(diff, key=lambda rc: rc[1]) if diff else None}")
        print(head)
        if res.spec is None:
            print(f"[spec] plain: flash attention launches {rs[0]['launches']}"
                  f" (= {L} layers x {NEW} model passes), plain or SDPA "
                  f"calls 0")
            continue
        sp = res.spec
        rounds = int(sp.rounds.max())
        fixed, per_round = want_launches(name, rounds)
        drafted, accepted = int(sp.drafted.sum()), int(sp.accepted.sum())
        n_rounds = int(sp.rounds.sum())
        later = BATCH * (NEW - 1)           # tokens after the first
        depth = dcfg.num_layers if name == "draft_cfg" \
            else pro + SPEC_DRAFT * blk
        print(f"[spec] {name} (draft {depth} layers, verify {L}): {rounds} "
              f"rounds ({n_rounds} request rounds), drafted {drafted}, "
              f"accepted {accepted}, acceptance "
              f"{accepted / max(drafted, 1):.4f}, "
              f"{later / max(n_rounds, 1):.4f} tokens per round, "
              f"{n_rounds * (SPEC_K + 1) / later:.4f} sequential passes "
              f"per token (plain: 1); flash attention launches "
              f"{rs[0]['launches']} (= {fixed} prefill + {rounds} rounds x "
              f"{per_round}), plain or SDPA calls 0")
        spans = [sp_ for r in rs for sp_ in r["spans"]]
        split = {p: statistics.median(r[p] for r in spans)
                 for p in ("round", "draft", "verify", "accept")}
        print(f"[spec] {name}: per round (median of {len(spans)}, CUDA "
              f"events) {sum(split.values()):.3f} ms: snapshot "
              f"{split['round']:.3f}, {SPEC_K} draft steps "
              f"{split['draft']:.3f}, verify {split['verify']:.3f}, accept "
              f"+ restore {split['accept']:.3f}")
    out = {"spec": sum(runs[n][0]["launches"] for n in ("self",
                                                         "draft_cfg"))}
    del runs, engines
    spec_attribution(torch, dev, params, tokens, plain)
    del dparams
    torch.cuda.empty_cache()
    return out


def spec_attribution(torch, dev, params, tokens, plain):
    """Where a verify pass and one-row passes part, from the same state:
    after the prompt, feed ``plain``'s first 5 tokens as one 5-row verify
    (a (B,) index) and as 5 one-row steps, recording each attention call's
    q, fresh K/V rows and output.  A layer whose inputs are equal bit for
    bit but whose attention rows are not would be the kernel; inputs that
    differ were made by the products (cuBLAS may round a 20-row and a
    4-row product apart)."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    cfg = params.cfg
    T = SPEC_K + 1
    real = ops.sdpa_decode
    with torch.inference_mode():
        _, base = M.prefill(cfg, params, {"tokens": tokens}, SPEC_SEQ,
                            torch.bfloat16)
        pos = torch.full((BATCH,), PROMPT, dtype=torch.int64, device=dev)
        runs = []
        for rows in (T, 1):
            caches = {"prologue": [{"attn": {n: c["attn"][n].clone()
                                             for n in ("k", "v")}}
                                   for c in base["prologue"]],
                      "blocks": [[{"attn": {n: c["attn"][n].clone()
                                            for n in ("k", "v")}}
                                  for c in blk] for blk in base["blocks"]]}
            seen = []

            def record(q, k, v, **kw):
                out = real(q, k, v, **kw)
                at = kw["q_start"][:, None] + torch.arange(q.shape[1],
                                                           device=dev)
                rows = torch.arange(BATCH, device=dev)[:, None]
                seen.append((q, k[rows, at], v[rows, at], out))
                return out
            ops.sdpa_decode = record
            try:
                lg = [M.decode_step(cfg, params, caches,
                                    plain[:, i:i + rows], pos + i)[0]
                      for i in range(0, T, rows)]
            finally:
                ops.sdpa_decode = real
            runs.append((torch.cat(lg, dim=1), seen))
    (lv, sv), (l1, s1) = runs
    L = cfg.num_layers
    in_diff = out_diff_same_in = 0
    first_in = None
    for layer in range(L):
        one = [torch.cat([s1[i * L + layer][j] for i in range(T)], dim=1)
               for j in range(4)]
        same_in = all(torch.equal(_bits(torch, a), _bits(torch, b))
                      for a, b in zip(sv[layer][:3], one[:3]))
        if same_in:
            out_diff_same_in += not torch.equal(_bits(torch, sv[layer][3]),
                                                _bits(torch, one[3]))
        else:
            in_diff += 1
            first_in = layer if first_in is None else first_in
    agree = int((lv.argmax(-1) == l1.argmax(-1)).sum())
    print(f"[spec] a 5-row verify vs 5 one-row steps from the prompt's "
          f"state: logits max abs diff {float((lv - l1).abs().max()):.3e}, "
          f"argmax equal {agree} of {BATCH * T}; the attention inputs (q "
          f"and the fresh K/V rows, made by the products) differ bitwise at "
          f"{in_diff} of {L} layers (first: {first_in}); attention rows "
          f"differ at {out_diff_same_in} layers whose inputs are equal")
    if out_diff_same_in:
        raise SystemExit("[spec] the flash kernel's verify rows differ from "
                         "its one-row calls on equal inputs")


def phase_spec_cpu_vs_card(torch, dev):
    """``[spec-cpu-vs-card]``: the fixed-batch engine on reduced gemma3-1b
    (2 pattern blocks) in f32, with speculate_k = 2, self-speculative
    and with a 1-block draft model: tokens and SpecStats equal on the
    CPU and the card, and the speculative tokens equal the plain ones on
    the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import make_engine

    cfg = get_config("gemma3-1b").reduced(num_blocks=2)
    dcfg = dataclasses.replace(cfg, num_blocks=1)
    models = {}
    for key, c, seed in (("target", cfg, 3), ("draft", dcfg, 4)):
        cpu = M.init(c, seed=seed, dtype=torch.float32, device="cpu")
        card = M.Model(c, dtype=torch.float32, device=dev)
        card.load_state_dict(cpu.state_dict())
        models[key] = {"cpu": cpu, "card": card}
    tokens = torch.randint(0, cfg.vocab_size, (3, 16),
                           generator=torch.Generator().manual_seed(6))
    res = {}
    for mode, kw in (("plain", {}),
                     ("self", dict(speculate_k=2)),
                     ("draft_cfg", dict(speculate_k=2, draft_cfg=dcfg))):
        for side, d in (("cpu", torch.device("cpu")), ("card", dev)):
            eng = make_engine(cfg, batch=3, prompt_len=16, max_new=12,
                              param_dtype=torch.float32,
                              cache_dtype=torch.float32, device=d, **kw)
            r = eng.generate_with_state(
                models["target"][side], {"tokens": tokens.to(d)},
                draft_params=models["draft"][side] if "draft_cfg" in kw
                else None)
            res[mode, side] = (r.tokens.cpu(), None if r.spec is None
                               else [t.cpu() for t in r.spec])
        if mode == "plain":
            continue
        (tc, sc), (tg, sg) = res[mode, "cpu"], res[mode, "card"]
        same = torch.equal(tc, tg) and all(torch.equal(a, b)
                                           for a, b in zip(sc, sg))
        lossless = torch.equal(tg, res["plain", "card"][0])
        rounds, drafted, accepted = (int(t.sum()) for t in sg)
        print(f"[spec-cpu-vs-card] reduced gemma3-1b f32, {mode}, k=2: "
              f"tokens and SpecStats equal on cpu and card {same} "
              f"({rounds} rounds, accepted {accepted} of {drafted}); "
              f"speculative tokens == plain tokens on the card {lossless}")
        if not (same and lossless):
            raise SystemExit(f"[spec-cpu-vs-card] {mode}: card and cpu "
                             f"differ, or speculation changed the tokens")


def phase_cpu_vs_card(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import make_engine

    cfg = get_config("gemma3-1b").reduced()
    cpu = M.init(cfg, seed=3, dtype=torch.float32, device="cpu")
    card = M.Model(cfg, dtype=torch.float32, device=dev)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(4))
    logits = {}
    out = {}
    for name, params, d in (("cpu", cpu, torch.device("cpu")),
                            ("card", card, dev)):
        t = tokens.to(d)
        with torch.inference_mode():
            logits[name], _ = M.prefill(cfg, params, {"tokens": t}, 24,
                                        torch.float32)
        eng = make_engine(cfg, batch=2, prompt_len=16, max_new=8,
                          param_dtype=torch.float32,
                          cache_dtype=torch.float32, device=d)
        out[name] = eng.generate(params, {"tokens": t})[0].cpu()
    err = float((logits["card"].cpu() - logits["cpu"]).abs().max())
    print(f"[cpu-vs-card] reduced gemma3-1b f32: prefill logits max abs "
          f"err {err:.3e} (tol 1e-4); greedy tokens equal: "
          f"{torch.equal(out['cpu'], out['card'])}")
    if not err <= 1e-4:
        raise SystemExit(f"card vs cpu prefill logits differ by {err}")
    if not torch.equal(out["cpu"], out["card"]):
        raise SystemExit(f"greedy tokens differ: cpu {out['cpu'].tolist()} "
                         f"card {out['card'].tolist()}")


def phase_moe_cpu_vs_card(torch, dev, archs=tuple(MOE_BLOCKS),
                          tag="[moe-cpu-vs-card]"):
    """``[moe-cpu-vs-card]``: reduced grok-1-314b and deepseek-v3-671b in
    f32, one model's weights on the CPU and the card: prefill logits, 4
    teacher-forced decode steps' logits and ``loss_fn`` (with the aux
    loss, and deepseek's MTP term through its untied head) within 1e-4,
    the [cpu-vs-card] tolerance (cuBLAS, the kernel at (64, 64) for
    grok and at MLA's padded (48, 32) for deepseek, and the CPU sum in
    other orders).  With ``archs=(SSM_ARCH, HYBRID_ARCH)`` it is
    ``[ssm-cpu-vs-card]``: the prefill runs the chunked scan (2 chunks of
    8), each decode step the recurrent step, on cuBLAS in f32 with TF32
    off.  With ``archs=(VLM_ARCH, ENCDEC_ARCH)`` it is
    ``[encdec-cpu-vs-card]``: llava's prefill after 16 stub prefix
    embeddings (decode at 32-35) and seamless's encoder over 16 stub
    frames with the decoder's cross-attention over it, the same stubs
    (drawn on the CPU) on both sides, the loss with 16 of them per
    sequence."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.models import model as M
    from repro_torch.models.frontends import stub_inputs

    for arch in archs:
        cfg = get_config(arch).reduced()
        cpu = M.init(cfg, seed=3, dtype=torch.float32, device="cpu")
        card = M.Model(cfg, dtype=torch.float32, device=dev)
        card.load_state_dict(cpu.state_dict())
        g = torch.Generator().manual_seed(4)
        tokens = torch.randint(0, cfg.vocab_size, (2, 20), generator=g)
        stubs = stub_inputs(cfg, g, 2, 16, torch.float32, "cpu")
        npfx = 16 if "prefix_embeds" in stubs else 0
        batch = {k: torch.from_numpy(v) for k, v in token_batches(
            0, batch=2, seq=16, vocab=cfg.vocab_size).items()}
        batch.update(stub_inputs(cfg, g, 2, 16, torch.float32, "cpu"))
        out = {}
        for name, params, d in (("cpu", cpu, torch.device("cpu")),
                                ("card", card, dev)):
            t = tokens.to(d)
            with torch.inference_mode():
                lg, caches = M.prefill(cfg, params, {
                    "tokens": t[:, :16],
                    **{k: v.to(d) for k, v in stubs.items()}},
                    24 + npfx, torch.float32)
                logits = [lg]
                for i in range(16, 20):
                    lg, caches = M.decode_step(cfg, params, caches,
                                               t[:, i:i + 1], npfx + i)
                    logits.append(lg)
            loss, aux = M.loss_fn(cfg, dict(params.state_dict()),
                                  {k: v.to(d) for k, v in batch.items()})
            out[name] = (torch.cat(logits, dim=1).cpu(),
                         torch.stack([loss, aux["aux"]]).detach().cpu())
        errs = [float((out["card"][i] - out["cpu"][i]).abs().max())
                for i in range(2)]
        print(f"{tag} reduced {arch} f32"
              f"{' (16 stub embeddings)' if stubs else ''}: prefill + 4 "
              f"decode logits max abs err {errs[0]:.3e}, loss and aux "
              f"{errs[1]:.3e} (tol 1e-4; loss {float(out['card'][1][0]):.6f}"
              f", aux {float(out['card'][1][1]):.6f})")
        if not max(errs) <= 1e-4:
            raise SystemExit(f"{tag} {arch}: card vs cpu differ by {errs}")


def phase_train(torch, dev, card, profile=False, compression=None,
                arch="gemma3-1b", nodes=TRAIN_N, steps=TRAIN_STEPS,
                tag=None, pre=None, reduced=False, remat=False,
                stub_len=0):
    """Full-width (or, with ``reduced``, ``reduced()``) DSGD-momentum
    training of ``arch`` in bf16 on the card as ``nodes`` nodes, through
    ``simulate_decentralized``, uncompressed (``[train]``) or with
    ``compression`` (``[train-compress]``), or under ``tag`` with
    launches keyed by ``pre`` (``[zoo-train]``, ``[moe-train]``,
    ``[ssm-train]``, ``[hybrid-train]``, ``[encdec-train]``,
    ``[vlm-train]``), each pattern block checkpointed with ``remat``; a
    frontend model's batch carries ``stub_len`` stub frames or prefix
    embeddings per sequence, drawn per step from a stream of their own;
    returns the launch counts of the timed run by phase.
    With ``profile``, one more step runs under the profiler (kernel time
    by name)."""
    from repro_torch import trace
    from repro_torch.compress import reference_leaves
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.fused_dsgd import fused_dsgd, fused_dsgd_many
    from repro_torch.kernels.multi_tensor import capacity
    from repro_torch.dist.gossip import BUCKET_BYTES, plan_buckets
    from repro_torch.kernels.quantized_gossip import (quantize_ef,
                                                      quantize_ef_many)
    from repro_torch.models import model as M
    from repro_torch.models.frontends import stub_inputs
    from repro_torch.optim.decentralized import make_method
    from repro_torch.sim.engine import (_consensus_error,
                                        simulate_decentralized)
    from repro_torch.topology import TopologySpec, build_schedule

    tag = tag or ("[train-compress]" if compression else "[train]")
    pre = pre or ("train-compress-" if compression else "train-")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    params = M.init(cfg, seed=0, dtype=torch.bfloat16,
                    device=dev).state_dict()
    n_params = sum(p.numel() for p in params.values())
    tokens = nodes * TRAIN_B * TRAIN_SEQ
    # flash launches a forward runs: the encoder's, the decoder's (a
    # cross-attention layer's twice) and the MTP layer's; with remat the
    # backward runs the decoder's pattern blocks' again
    n_attn = encoder_layers(cfg) + flash_calls(cfg) + (1 if cfg.mtp else 0)
    if remat:
        n_attn += flash_calls(dataclasses.replace(cfg, prologue=()))
    spec = TopologySpec(name="base", n=nodes, k=1)

    def batches(step):
        b = token_batches(step, batch=nodes * TRAIN_B, seq=TRAIN_SEQ,
                          vocab=cfg.vocab_size)
        b = {k: v.reshape(nodes, TRAIN_B, TRAIN_SEQ) for k, v in b.items()}
        gen = torch.Generator(device=dev).manual_seed(STUB_SEED + step)
        for k, v in stub_inputs(cfg, gen, nodes * TRAIN_B, stub_len,
                                torch.bfloat16, dev).items():
            b[k] = v.reshape((nodes, TRAIN_B) + v.shape[1:])
        return b

    kw = dict(loss_fn=lambda p, b: M.loss_fn(cfg, p, b, remat=remat)[0],
              params=params,
              method=make_method("dsgdm", momentum=TRAIN_MOMENTUM,
                                 compression=compression),
              schedule=spec, batches=batches, eta=TRAIN_ETA, device=dev)
    print(f"{tag} {arch} {'reduced' if reduced else 'full width'}: "
          f"{cfg.num_layers} layers, {n_attn} attention layer runs a "
          f"forward{' and backward (remat)' if remat else ''}, "
          f"{len(params)} parameter tensors, {n_params / 1e9:.3f} B params "
          f"in bf16; n={nodes} nodes on base k=1, dsgdm "
          f"{TRAIN_MOMENTUM}, eta {TRAIN_ETA}, {TRAIN_B} x {TRAIN_SEQ} "
          f"tokens per node"
          + (f", each sequence with {stub_len} stub "
             f"{'frames' if cfg.encoder else 'prefix embeddings'}"
             if stub_len else "")
          + (f"; compression {compression.to_json()}" if compression
             else ""))
    t0 = time.perf_counter()
    simulate_decentralized(steps=1, **kw)                # warm-up
    torch.cuda.synchronize()
    print(f"{tag} warm-up step (with node_stack): "
          f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    fused_dsgd.launches = 0
    fused_dsgd_many.launches = fused_dsgd_many.segments = 0
    flash_attention_fwd.launches = 0
    quantize_ef.launches = 0
    quantize_ef_many.launches = quantize_ef_many.segments = 0
    # host seconds inside the grouped update's entry point per step, and
    # the part of them Python's garbage collector took
    host, gc_in, gc_open, inside = [], [], [], [False]
    real = ops.fused_dsgd_steps

    def timed(*args, **kw):
        t = time.perf_counter()
        inside[0] = True
        gc_in.append(0.0)
        try:
            return real(*args, **kw)
        finally:
            inside[0] = False
            host.append(time.perf_counter() - t)

    def gc_clock(phase, info):
        if phase == "start":
            gc_open[:] = [time.perf_counter()]
        elif gc_open and inside[0]:
            gc_in[-1] += time.perf_counter() - gc_open[0]

    ops.fused_dsgd_steps = timed
    gc.callbacks.append(gc_clock)
    t0 = time.perf_counter()
    try:
        with trace.cuda_marks() as marks:
            res = simulate_decentralized(steps=steps, **kw)
            torch.cuda.synchronize()
    finally:
        ops.fused_dsgd_steps = real
        gc.callbacks.remove(gc_clock)
    wall = time.perf_counter() - t0
    launches = {pre + "fused_dsgd": fused_dsgd_many.launches,
                pre + "fused_dsgd-tensors": fused_dsgd_many.segments,
                pre + "fused_dsgd-single": fused_dsgd.launches,
                pre + "flash": flash_attention_fwd.launches}
    if arch == "gemma3-1b":     # the [quantize] entries report these
        launches.update({
            # the grouped kernel, which the per-shape rows of [quantize]
            # call one buffer at a time
            "train-quantize_ef": quantize_ef_many.launches,
            "train-compress-quantize_ef_many": quantize_ef_many.launches,
            "train-compress-quantize_ef_many-segments":
                quantize_ef_many.segments,
            "train-quantize_ef-single": quantize_ef.launches})
    peak = torch.cuda.max_memory_allocated()

    leaves = reference_leaves(params)
    # one grouped update per table of segments (``multi_tensor.capacity``
    # of its 5 pointers: 440 tensors) per dtype per step
    per_dtype = {}
    for v in params.values():
        per_dtype[v.dtype] = per_dtype.get(v.dtype, 0) + 1
    tables = sum(-(-n // capacity(5)) for n in per_dtype.values())
    # one grouped quantize per bucket of reference leaves (f32 chunk rows
    # of all nodes) per step
    buckets = len(plan_buckets(
        [4 * nodes * CHUNK * max(1, -(-len(g) * params[g[0]].numel()
                                      // CHUNK)) for g in leaves],
        BUCKET_BYTES))
    n_quant = steps * buckets if compression else 0
    want = {pre + "fused_dsgd": steps * tables,
            pre + "fused_dsgd-tensors": steps * len(params),
            pre + "fused_dsgd-single": 0,
            pre + "flash": steps * n_attn * nodes,
            "train-quantize_ef": n_quant,
            "train-compress-quantize_ef_many": n_quant,
            "train-compress-quantize_ef_many-segments":
                steps * len(leaves) if compression else 0,
            "train-quantize_ef-single": 0}
    for phase, n in want.items():
        if phase in launches and launches[phase] != n:
            raise SystemExit(f"{phase} launched {launches[phase]} times in "
                             f"{steps} training steps, expected {n}")
    if arch != "gemma3-1b" and quantize_ef_many.launches + \
            quantize_ef.launches:
        raise SystemExit(f"{tag} launched a quantize kernel uncompressed")
    if compression and res.state["ct"] != steps:
        raise SystemExit(f"compressed state ct = {res.state['ct']} after "
                         f"{steps} steps")
    losses = res.losses
    if losses.shape != (steps,) or not bool(
            torch.isfinite(torch.from_numpy(losses)).all()):
        raise SystemExit(f"training losses not finite: {losses}")

    names = [name for name, _ in marks]
    if names != ["step", "update", "mix", "end"] * steps:
        raise SystemExit(f"unexpected training step marks: {names[:8]}")
    split = {"forward+backward": [], "update": [], "mix": [], "step": []}
    for i in range(steps):
        ev = [e for _, e in marks[4 * i:4 * i + 4]]
        split["forward+backward"].append(ev[0].elapsed_time(ev[1]))
        split["update"].append(ev[1].elapsed_time(ev[2]))
        split["mix"].append(ev[2].elapsed_time(ev[3]))
        split["step"].append(ev[0].elapsed_time(ev[3]))
    med = {k: statistics.median(v) for k, v in split.items()}
    cons = float(_consensus_error(res.params))
    mix_name = "compressed mix" if compression else "mix"
    print(f"{tag} {card}: {med['step']:.2f} ms/step (median of "
          f"{steps}, CUDA events; min {min(split['step']):.2f}, max "
          f"{max(split['step']):.2f}), {tokens / med['step'] * 1e3:.1f} "
          f"tokens/s ({tokens} tokens per step); host clock "
          f"{wall / steps * 1e3:.2f} ms/step over the whole run")
    print(f"{tag} split per step (medians): forward+backward "
          f"{med['forward+backward']:.2f} ms, update (grouped kernel) "
          f"{med['update']:.2f} ms, {mix_name} {med['mix']:.2f} ms; host "
          f"time in ops.fused_dsgd_steps {statistics.median(host) * 1e3:.2f} "
          f"ms/step (median of {len(host)}; per step "
          f"{[round(t * 1e3, 2) for t in host]} ms, of which the garbage "
          f"collector {[round(t * 1e3, 2) for t in gc_in]} ms)")
    print(f"{tag} losses {[round(float(x), 4) for x in losses]}; "
          f"consensus error after {steps} steps {cons:.3e}; peak "
          f"memory {peak / 2**30:.2f} GiB (max_memory_allocated)")
    compute_floor = 6.0 * n_params * tokens / PEAK_FLOPS["bfloat16"] * 1e3
    update_bytes = 5 * nodes * n_params * 2
    update_floor = update_bytes / H100_BYTES_PER_S * 1e3
    print(f"{tag} floors: compute >= {compute_floor:.2f} ms/step (6 x "
          f"{n_params / 1e9:.3f} B params x {tokens} tokens at 989 TFLOP/s "
          f"bf16); update >= {update_floor:.2f} ms/step "
          f"({update_bytes / 1e9:.1f} GB at 3.35 TB/s)")
    print(f"{tag} launches in {steps} steps: fused_dsgd "
          f"{launches[pre + 'fused_dsgd']} (= {tables} table(s) of at "
          f"most {capacity(5)} tensors x "
          f"{steps} steps) over "
          f"{launches[pre + 'fused_dsgd-tensors']} tensors (= "
          f"{len(params)} x {steps}), flash "
          f"{launches[pre + 'flash']} (= "
          f"{n_attn} attention layer runs x {nodes} nodes x {steps})"
          + (f", quantize_ef_many {launches['train-quantize_ef']} (= "
             f"{buckets} buckets of at most {BUCKET_BYTES >> 20} MiB x "
             f"{steps} steps) over "
             f"{launches['train-compress-quantize_ef_many-segments']} "
             f"buffers (= {len(leaves)} reference leaves x {steps})"
             if compression else ""))
    if compression:
        # each reference leaf is one chunk-row payload, padded once
        sizes = [sum(params[k].numel() for k in g) for g in leaves]
        wire = sum(compression.wire_bytes(n) for n in sizes)
        f32 = 4 * n_params
        sched = build_schedule(spec)
        quant_floor = (13 * nodes * sum(compression.rows(n) for n in sizes)
                       * CHUNK / H100_BYTES_PER_S * 1e3)
        print(f"{tag} wire bytes per node per round: "
              f"{sched.bytes_per_node_per_round(wire):.0f} "
              f"{compression.codec} against "
              f"{sched.bytes_per_node_per_round(f32):.0f} f32 "
              f"({f32 / wire:.3f}x fewer; one message of {wire} bytes, "
              f"{sched.bytes_per_node_per_round(1):.4f} messages per node "
              f"per round); quantize floor {quant_floor:.2f} ms/step (13 B "
              f"per chunk-row element at 3.35 TB/s)")
    del res
    if profile:
        from torch.profiler import ProfilerActivity, profile as trace_run
        with trace_run(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            simulate_decentralized(steps=1, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print_kernel_times(prof, f"{tag[1:-1]} step (with node_stack)", wall,
                           1)
    del params, kw
    torch.cuda.empty_cache()
    return launches


def phase_remat(torch, dev, card):
    """``[remat]``: one gemma2-2b node's ``loss_fn`` gradients at full width
    (bf16, the ``[zoo-train]`` batch of node 0) with ``remat=True``
    against ``remat=False`` on the card: per gradient, max |diff| / max
    |plain| <= ``REMAT_TOL``, the differing elements counted; the peak
    memory and the flash launches of both (with remat, the backward runs
    each pattern block's forward again: the launches double)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import model as M

    cfg = get_config(ZOO_TRAIN_ARCH)
    params = M.init(cfg, seed=0, dtype=torch.bfloat16,
                    device=dev).state_dict()
    raw = token_batches(0, batch=ZOO_TRAIN_N * TRAIN_B, seq=TRAIN_SEQ,
                        vocab=cfg.vocab_size)
    batch = {k: torch.as_tensor(v[:TRAIN_B]).to(dev)
             for k, v in raw.items()}
    n_bytes = sum(v.numel() * v.element_size() for v in params.values())

    def run(remat):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        loss = M.loss_fn(cfg, p, batch, remat=remat)[0]
        forward = flash_attention_fwd.launches
        grads = torch.autograd.grad(loss, list(p.values()))
        torch.cuda.synchronize()
        # the call's own peak: above what was held when it began (the
        # parameters, and the other runs' gradients kept for the check)
        return dict(loss=float(loss.detach()), grads=grads,
                    s=[time.perf_counter() - t0],
                    peak=torch.cuda.max_memory_allocated() - held,
                    forward=forward, launches=flash_attention_fwd.launches)

    # warm-up of both modes (the first checkpoint call imports
    # torch._dynamo, seconds of host time), then each timed twice in turn
    run(False), run(True)
    runs = {}
    for remat in (False, True, True, False):
        r = run(remat)
        if remat in runs:
            runs[remat]["s"] += r["s"]
        else:
            runs[remat] = r
        del r
    blocks = cfg.num_blocks * len(cfg.pattern)
    worst, differing, total = 0.0, 0, 0
    for a, b in zip(runs[True]["grads"], runs[False]["grads"]):
        diff = (a.float() - b.float()).abs()
        worst = max(worst, float(diff.max()) / max(float(b.float().abs()
                                                         .max()), 1e-30))
        differing += int((diff > 0).sum())
        total += diff.numel()
        del diff
    for remat, r in runs.items():
        print(f"[remat] {ZOO_TRAIN_ARCH} one node, {TRAIN_B} x {TRAIN_SEQ} "
              f"tokens, remat={remat}: loss {r['loss']:.6f}, forward + "
              f"backward {', '.join(f'{t * 1e3:.1f}' for t in r['s'])} ms "
              f"(host clock, two calls in turn with the other mode), "
              f"peak memory {r['peak'] / 2**30:.2f} GiB above what the call "
              f"found allocated (max_memory_allocated; the parameters "
              f"{n_bytes / 2**30:.2f} GiB besides), flash launches "
              f"{r['launches']} "
              f"({r['forward']} in the forward)")
    print(f"[remat] {card}: gradients remat vs not: {differing} of {total} "
          f"elements differ, worst max|diff| / max|plain| per tensor "
          f"{worst:.3e} (tol {REMAT_TOL}); losses equal: "
          f"{runs[True]['loss'] == runs[False]['loss']}")
    want = {False: cfg.num_layers, True: cfg.num_layers + blocks}
    if any(runs[r]["launches"] != want[r] or runs[r]["forward"]
           != cfg.num_layers for r in runs) or not worst <= REMAT_TOL \
            or runs[True]["loss"] != runs[False]["loss"]:
        raise SystemExit(f"[remat] failed: launches "
                         f"{[runs[r]['launches'] for r in runs]}, expected "
                         f"{list(want.values())}; worst {worst}")
    del runs, params
    torch.cuda.empty_cache()
    return {"remat-flash": want[True]}


def phase_train_cpu_vs_card(torch, dev):
    """The training path on the card against the same on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_mlp import MLPConfig
    from repro_torch.data.synthetic import (dirichlet_classification,
                                            token_batches)
    from repro_torch.models import mlp
    from repro_torch.models import model as M
    from repro_torch.optim.decentralized import METHOD_NAMES, make_method
    from repro_torch.sim.engine import simulate_decentralized
    from repro_torch.topology import TopologySpec

    n, k, steps, bs = 21, 2, 20, 32
    data = dirichlet_classification(n, steps * bs, alpha=0.1, seed=0)
    params = mlp.init(MLPConfig(), seed=0, device="cpu")

    def batches(step):
        s = slice(step * bs, (step + 1) * bs)
        return data.node_x[:, s], data.node_y[:, s]

    for name in METHOD_NAMES:
        losses = {d: simulate_decentralized(
            loss_fn=mlp.loss_fn, params=params, method=make_method(name),
            schedule=TopologySpec(name="base", n=n, k=k), batches=batches,
            steps=steps, eta=0.03, device=d).losses for d in ("cpu", dev)}
        err = float(abs(losses["cpu"] - losses[dev]).max())
        print(f"[train-cpu-vs-card] paper MLP {name}, n={n} base k={k}, "
              f"{steps} steps f32: losses max abs err {err:.3e} (tol 1e-5); "
              f"last loss {losses[dev][-1]:.4f}")
        if not err <= 1e-5:
            raise SystemExit(f"card vs cpu {name} losses differ by {err}")

    cfg = get_config("gemma3-1b").reduced()
    params = M.init(cfg, seed=3, dtype=torch.float32,
                    device="cpu").state_dict()

    def token_batch(step):
        b = token_batches(step, batch=3 * 2, seq=16, vocab=cfg.vocab_size)
        return {key: v.reshape(3, 2, 16) for key, v in b.items()}

    losses = {d: simulate_decentralized(
        loss_fn=lambda p, b: M.loss_fn(cfg, p, b)[0], params=params,
        method=make_method("dsgdm"), schedule=TopologySpec(name="base", n=3,
                                                           k=1),
        batches=token_batch, steps=3, eta=0.01, device=d).losses
        for d in ("cpu", dev)}
    err = float(abs(losses["cpu"] - losses[dev]).max())
    print(f"[train-cpu-vs-card] reduced gemma3-1b dsgdm, n=3, 3 steps f32: "
          f"losses {losses[dev].tolist()}, max abs err {err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        raise SystemExit(f"card vs cpu gemma training losses differ by {err}")


def phase_compress_cpu_vs_card(torch, dev):
    """Compressed gossip on the card against the same on the CPU."""
    from repro_torch.compress import (CODEC_NAMES, CompressionConfig,
                                      compressed_dense_mix, get_codec,
                                      leaf_to_rows)
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_mlp import MLPConfig
    from repro_torch.data.synthetic import dirichlet_classification
    from repro_torch.kernels.ref import sr_key
    from repro_torch.models import mlp
    from repro_torch.models import model as M
    from repro_torch.optim.decentralized import make_method
    from repro_torch.sim.engine import simulate_decentralized
    from repro_torch.topology import TopologySpec, build_schedule

    n = 3
    cfg = get_config("gemma3-1b").reduced()
    gen = torch.Generator().manual_seed(6)
    tree = {k: torch.stack([p + 0.01 * torch.randn(p.shape, generator=gen)
                            for _ in range(n)])
            for k, p in M.init(cfg, seed=3, dtype=torch.float32,
                               device="cpu").state_dict().items()}
    ef0 = {k: 0.01 * torch.randn(x.shape, generator=gen)
           for k, x in tree.items()}
    W = torch.from_numpy(build_schedule(TopologySpec(
        name="base", n=n, k=1)).W(0).astype("float32"))
    for codec in CODEC_NAMES:
        ccfg = CompressionConfig(codec=codec, chunk=CHUNK)
        key = sr_key(ccfg.seed, 4)
        same = True
        for k, x in tree.items():       # the payloads, tensor by tensor
            outs = []
            for d in ("cpu", dev):
                x2d = leaf_to_rows(x.to(d), CHUNK)
                e2d = leaf_to_rows(ef0[k].to(d), CHUNK)
                outs.append(get_codec(codec).compress(ccfg, x2d, e2d, key,
                                                      0))
            (pc, rc), (pd, rd) = outs
            same &= torch.equal(rc.view(torch.int32),
                                rd.cpu().view(torch.int32))
            same &= all(torch.equal(pc[f].view(torch.uint8),
                                    pd[f].cpu().view(torch.uint8))
                        for f in pc)
        mixed, efs = {}, {}
        for d in ("cpu", dev):
            ef = {k: v.to(d, copy=True) for k, v in ef0.items()}
            out, ef = compressed_dense_mix(W.to(d), {k: x.to(d) for k, x
                                                     in tree.items()}, ef,
                                           ccfg, 4)
            mixed[d] = {k: v.cpu() for k, v in out.items()}
            efs[d] = {k: v.cpu() for k, v in ef.items()}
        same &= all(torch.equal(efs["cpu"][k].view(torch.int32),
                                efs[dev][k].view(torch.int32)) for k in tree)
        err = max(float((mixed["cpu"][k] - mixed[dev][k]).abs().max())
                  for k in tree)
        print(f"[compress-cpu-vs-card] reduced gemma3-1b, n={n}, {codec}: "
              f"{len(tree)} tensors' payloads and residuals bitwise {same}; "
              f"mixed max abs err {err:.3e} (tol 1e-5)")
        if not (same and err <= 1e-5):
            raise SystemExit(f"card vs cpu compressed mix ({codec}) differs: "
                             f"bitwise {same}, mixed max abs err {err}")

    n, k, steps, bs = 21, 2, 20, 32
    data = dirichlet_classification(n, steps * bs, alpha=0.1, seed=0)
    params = mlp.init(MLPConfig(), seed=0, device="cpu")

    def batches(step):
        s = slice(step * bs, (step + 1) * bs)
        return data.node_x[:, s], data.node_y[:, s]

    for codec in ("int8", "fp8", "int4", "topk"):
        method = make_method("dsgd", compression=codec)
        losses = {d: simulate_decentralized(
            loss_fn=mlp.loss_fn, params=params, method=method,
            schedule=TopologySpec(name="base", n=n, k=k), batches=batches,
            steps=steps, eta=0.03, device=d).losses for d in ("cpu", dev)}
        err = float(abs(losses["cpu"] - losses[dev]).max())
        print(f"[compress-cpu-vs-card] paper MLP dsgd {codec}, n={n} base "
              f"k={k}, {steps} steps: losses max abs err {err:.3e} (tol "
              f"1e-3); last loss {losses[dev][-1]:.4f}")
        if not err <= 1e-3:
            raise SystemExit(f"card vs cpu compressed {codec} losses differ "
                             f"by {err}")


def phase_failure(torch, dev, card):
    """Full-width gemma3-1b on the ``[train]`` cell through the failure
    engine: ``FailureModel()`` equals ``failure=None`` bit for bit, then
    the regime with all four behaviours, its launches counted (one
    grouped fused update per step at unit pre-scale, 26 x 3 flash
    forwards), each step split by CUDA events, its peak memory read."""
    from repro_torch import trace
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.fused_dsgd import fused_dsgd, fused_dsgd_many
    from repro_torch.models import model as M
    from repro_torch.optim.decentralized import make_method
    from repro_torch.sim import FailureModel, simulate_decentralized
    from repro_torch.topology import TopologySpec

    cfg = get_config("gemma3-1b")
    params = M.init(cfg, seed=0, dtype=torch.bfloat16,
                    device=dev).state_dict()
    tokens = TRAIN_N * TRAIN_B * TRAIN_SEQ

    def batches(step):
        b = token_batches(step, batch=TRAIN_N * TRAIN_B, seq=TRAIN_SEQ,
                          vocab=cfg.vocab_size)
        return {k: v.reshape(TRAIN_N, TRAIN_B, TRAIN_SEQ)
                for k, v in b.items()}

    kw = dict(loss_fn=lambda p, b: M.loss_fn(cfg, p, b)[0], params=params,
              method=make_method("dsgdm", momentum=TRAIN_MOMENTUM),
              schedule=TopologySpec(name="base", n=TRAIN_N, k=1),
              batches=batches, steps=FAIL_STEPS, eta=TRAIN_ETA, device=dev)
    t0 = time.perf_counter()
    sync = simulate_decentralized(**kw)
    sync.state = None
    clean = simulate_decentralized(failure=FailureModel(), **kw)
    torch.cuda.synchronize()
    same = bool((sync.losses == clean.losses).all()) and all(
        torch.equal(_bits(torch, x), _bits(torch, clean.params[k]))
        for k, x in sync.params.items())
    clocks_ok = clean.clocks.tolist() == [FAIL_STEPS] * TRAIN_N
    print(f"[failure] gemma3-1b full width, n={TRAIN_N} base k=1, dsgdm "
          f"{TRAIN_MOMENTUM}, {FAIL_STEPS} steps: FailureModel() == "
          f"failure=None bitwise {same} (losses {sync.losses.tolist()}, "
          f"{len(params)} parameter tensors), clocks "
          f"{clean.clocks.tolist()}; both runs "
          f"{time.perf_counter() - t0:.2f} s")
    if not (same and clocks_ok):
        raise SystemExit("the clean failure model differs from the "
                         "synchronous run on full-width gemma3-1b")
    del sync, clean
    torch.cuda.empty_cache()

    failure = FailureModel(**FAIL_REGIME)
    torch.cuda.reset_peak_memory_stats()
    fused_dsgd.launches = 0
    fused_dsgd_many.launches = fused_dsgd_many.segments = 0
    flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    with trace.cuda_marks() as marks:
        res = simulate_decentralized(failure=failure, **kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"failure-fused_dsgd": fused_dsgd_many.launches,
                "failure-fused_dsgd-tensors": fused_dsgd_many.segments,
                "failure-fused_dsgd-single": fused_dsgd.launches,
                "failure-flash": flash_attention_fwd.launches}
    dtypes = len({v.dtype for v in params.values()})
    want = {"failure-fused_dsgd": FAIL_STEPS * dtypes,
            "failure-fused_dsgd-tensors": FAIL_STEPS * len(params),
            "failure-fused_dsgd-single": 0,
            "failure-flash": FAIL_STEPS * cfg.num_layers * TRAIN_N}
    for phase, n in want.items():
        if launches[phase] != n:
            raise SystemExit(f"{phase} launched {launches[phase]} times in "
                             f"{FAIL_STEPS} failure steps, expected {n}")
    if res.losses.shape != (FAIL_STEPS,) or not bool(
            torch.isfinite(torch.from_numpy(res.losses)).all()):
        raise SystemExit(f"failure-model honest losses not finite: "
                         f"{res.losses}")
    spans = _step_spans(marks)
    parts = ("step", "update", "stale", "corrupt", "mix", "state")
    if len(spans) != FAIL_STEPS or any(set(s) != set(parts) for s in spans):
        raise SystemExit(f"unexpected failure step marks: "
                         f"{[sorted(s) for s in spans]}")
    totals = [sum(s.values()) for s in spans]
    med = {k: statistics.median(s[k] for s in spans) for k in parts}
    byz = failure.byzantine_mask(TRAIN_N)
    print(f"[failure] {card}: {failure}: {statistics.median(totals):.2f} "
          f"ms/step (median of {FAIL_STEPS}, CUDA events; per step "
          f"{[round(t, 2) for t in totals]}), "
          f"{tokens / statistics.median(totals) * 1e3:.1f} tokens/s; host "
          f"clock {wall / FAIL_STEPS * 1e3:.2f} ms/step over the run (with "
          f"node_stack and the history ring's set-up)")
    print(f"[failure] split per step (medians, ms): forward+backward "
          f"(with the draws and the churn reset) {med['step']:.2f}, update "
          f"(grouped kernel, gradient mask, effective W) {med['update']:.2f}"
          f", mix {med['mix']:.2f} with the stale reads {med['stale']:.2f} "
          f"and the corrupt reads {med['corrupt']:.2f} beside it, node "
          f"freeze + history write {med['state']:.2f}")
    print(f"[failure] peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated); clocks {res.clocks.tolist()}; "
          f"Byzantine nodes {byz.nonzero()[0].tolist()}; honest losses "
          f"{[round(float(x), 4) for x in res.losses]}; launches in "
          f"{FAIL_STEPS} steps: fused_dsgd {launches['failure-fused_dsgd']} "
          f"over {launches['failure-fused_dsgd-tensors']} tensors, flash "
          f"{launches['failure-flash']}")
    del res, params, kw
    torch.cuda.empty_cache()
    return launches


def phase_sweep(torch, dev, card):
    """The reference's robustness grid as sweeps on the card, then a
    compressed sweep; returns the launch counts and the JSON entries of
    the grouped kernels at the sweeps' shapes."""
    import numpy as np

    from repro_torch.compress import CompressionConfig
    from repro_torch.configs.paper_mlp import MLPConfig
    from repro_torch.data.synthetic import dirichlet_classification
    from repro_torch.kernels.fused_dsgd import fused_dsgd, fused_dsgd_many
    from repro_torch.kernels.multi_tensor import BUCKET_BYTES, plan_buckets
    from repro_torch.kernels.quantized_gossip import (quantize_ef,
                                                      quantize_ef_many)
    from repro_torch.models import mlp
    from repro_torch.optim.decentralized import make_method
    from repro_torch.sim import (FailureModel, simulate_decentralized,
                                 sweep_decentralized)
    from repro_torch.topology import TopologySpec

    cfg = MLPConfig(input_dim=32, hidden=(64,), num_classes=10)
    data = dirichlet_classification(SWEEP_N, 512, dim=32, num_classes=10,
                                    alpha=0.3, margin=0.8, seed=2)
    params = mlp.init(cfg, seed=0, device=dev)
    specs = [TopologySpec(name=nm, n=SWEEP_N, k=k) for nm, k in SWEEP_TOPOS]
    tx, ty = (torch.from_numpy(a).to(dev) for a in (data.test_x,
                                                    data.test_y))

    def batches(step, bs=SWEEP_BATCH):
        i = (step * bs) % (512 - bs)
        return data.node_x[:, i:i + bs], data.node_y[:, i:i + bs]

    kw = dict(loss_fn=mlp.loss_fn, batches=batches, steps=SWEEP_STEPS,
              eta=SWEEP_ETA, eval_fn=lambda p: mlp.accuracy(p, tx, ty),
              eval_every=SWEEP_STEPS - 1, device=dev)
    method = make_method("dsgdm")
    launches = {"sweep-fused_dsgd": 0}
    wall = {}

    def sweep(name, fkw):
        fused_dsgd.launches = 0
        fused_dsgd_many.launches = fused_dsgd_many.segments = 0
        t0 = time.perf_counter()
        sw = sweep_decentralized(
            params=params, schedules=specs, method=method,
            failure=None if fkw is None else FailureModel(**fkw), **kw)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        got = (fused_dsgd_many.launches, fused_dsgd_many.segments,
               fused_dsgd.launches)
        if got != (SWEEP_STEPS, SWEEP_STEPS * len(params), 0):
            raise SystemExit(f"sweep {name}: (grouped launches, tensors, "
                             f"one-tensor launches) = {got}, expected "
                             f"({SWEEP_STEPS}, {SWEEP_STEPS * len(params)}, "
                             f"0): one launch per step over every copy")
        launches["sweep-fused_dsgd"] += fused_dsgd_many.launches
        if fkw is not None and not (sw.clocks == sw.clocks[:1]).all():
            raise SystemExit(f"sweep {name}: clocks differ across configs")
        return sw

    def equal(a, b):
        return all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in ("losses", "test_acc", "consensus"))

    sync = sweep("sync", None)
    sweeps = {name: sweep(name, fkw) for name, fkw in SWEEP_REGIMES}
    if not all(equal(sweeps["clean"].run(c), sync.run(c))
               for c in range(len(specs))):
        raise SystemExit("the clean sweep's cells differ from the "
                         "synchronous sweep's")
    t0 = time.perf_counter()
    for name, fkw in (("sync", None), ("drop0.1", SWEEP_REGIMES[1][1])):
        sw = sync if fkw is None else sweeps[name]
        for c, spec in enumerate(specs):
            one = simulate_decentralized(
                params=params, schedule=spec, method=method,
                failure=None if fkw is None else FailureModel(**fkw), **kw)
            cell = sw.run(c)
            ok = equal(one, cell) and all(
                torch.equal(_bits(torch, x), _bits(torch, cell.params[k]))
                for k, x in one.params.items())
            if fkw is not None:
                ok &= np.array_equal(one.clocks, cell.clocks)
            if not ok:
                raise SystemExit(f"sweep {name}: cell {c} "
                                 f"({sync.names[c]}) differs from its "
                                 f"independent run")
    torch.cuda.synchronize()
    singles = (time.perf_counter() - t0) / 2
    print(f"[sweep] {card}: the paper MLP 32-64-10 at n={SWEEP_N}, "
          f"{len(specs)} topologies x 1 seed, dsgdm eta {SWEEP_ETA}, "
          f"{SWEEP_STEPS} steps: every sweep 1 grouped fused launch per "
          f"step over {len(specs) * SWEEP_N} rows x {len(params)} tensors; "
          f"clean == synchronous sweep bitwise, the synchronous and drop0.1 "
          f"sweeps' cells == their independent runs bitwise (losses, "
          f"accuracy, consensus, parameters, clocks); clocks equal across "
          f"configs in every regime")
    print(f"[sweep] host seconds per sweep: "
          f"{ {k: round(v, 2) for k, v in wall.items()} }; "
          f"{len(specs)} independent runs {singles:.2f} s per regime "
          f"({singles / wall['sync']:.2f}x the synchronous sweep)")
    base = ROOT / "benchmarks" / "baselines" / "BENCH_failure.json"
    ref_acc = json.loads(base.read_text())["metrics"] if base.exists() \
        else {}
    print(f"[sweep] final accuracy per topology x regime after "
          f"{SWEEP_STEPS} steps, port (reference baseline after 120 steps, "
          f"JAX on a CPU, other weights: not a gate)")
    print("[sweep] " + f"{'topology':<16}" + "".join(
        f"{name:>22}" for name, _ in SWEEP_REGIMES))
    for c, label in enumerate(sync.names):
        cells = []
        for name, _ in SWEEP_REGIMES:
            acc = float(sweeps[name].run(c).test_acc[-1])
            want = ref_acc.get(f"{name}/{label}")
            cells.append(f"{acc:.4f} ({want:.4f})" if want is not None
                         else f"{acc:.4f} (n/a)")
        print("[sweep] " + f"{label:<16}" + "".join(f"{x:>22}"
                                                    for x in cells))
    del sweeps, sync

    # the compressed sweep: int8 + EF over 3 topologies x 2 seeds
    ccfg = CompressionConfig(codec=COMPRESS_CODEC, chunk=CHUNK,
                             error_feedback=True, seed=0)
    cmethod = make_method("dsgd", compression=ccfg)
    cspecs = [TopologySpec(name=nm, n=SWEEP_N, k=k)
              for nm, k in CSWEEP_TOPOS]
    seeds = [mlp.init(cfg, seed=s, device=dev) for s in CSWEEP_SEEDS]
    ckw = dict(kw, steps=CSWEEP_STEPS, method=cmethod)
    copies = len(cspecs) * len(seeds)
    rows = [SWEEP_N * -(-v.numel() // CHUNK) for v in params.values()]
    sizes = [4 * r * CHUNK for r in rows] * copies
    buckets = len(plan_buckets(sizes, BUCKET_BYTES))
    quantize_ef.launches = 0
    quantize_ef_many.launches = quantize_ef_many.segments = 0
    csw = sweep_decentralized(params=seeds, schedules=cspecs, **ckw)
    torch.cuda.synchronize()
    got = (quantize_ef_many.launches, quantize_ef_many.segments,
           quantize_ef.launches)
    want = (CSWEEP_STEPS * buckets, CSWEEP_STEPS * len(sizes), 0)
    if got != want:
        raise SystemExit(f"compressed sweep: (grouped quantize launches, "
                         f"buffers, one-buffer launches) = {got}, expected "
                         f"{want}")
    launches["sweep-compress-quantize_ef_many"] = got[0]
    for c, spec in enumerate(cspecs):
        for s, p in enumerate(seeds):
            one = simulate_decentralized(params=p, schedule=spec, **ckw)
            cell = csw.run(c, s)
            if not (equal(one, cell) and all(
                    torch.equal(_bits(torch, x), _bits(torch, cell.params[k]))
                    for k, x in one.params.items())):
                raise SystemExit(f"compressed sweep cell ({c}, {s}) differs "
                                 f"from its independent run")
    print(f"[sweep] compressed ({COMPRESS_CODEC} + EF, dsgd, chunk {CHUNK}) "
          f"{len(cspecs)} topologies x {len(seeds)} seeds, {CSWEEP_STEPS} "
          f"steps: {got[0]} grouped quantize launches (= {buckets} bucket(s) "
          f"x {CSWEEP_STEPS} steps) over {got[1]} buffers (= {len(sizes)} "
          f"records, each from row offset 0, x {CSWEEP_STEPS}); every cell "
          f"== its independent run bitwise; last losses "
          f"{[round(float(x), 4) for x in csw.losses[:, :, -1].ravel()]}")
    entries = sweep_entries(torch, dev, [tuple(v.shape) for v in
                                         params.values()],
                            len(specs), rows, copies)
    del params, seeds, csw
    torch.cuda.empty_cache()
    return launches, entries


def sweep_entries(torch, dev, shapes, configs, rows, copies):
    """Rows 3 and 6 at the sweeps' shapes: one grouped launch over every
    copy against the same launch per copy (bit for bit, and timed) and
    against the plain version; returns their JSON entries."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_dsgd import fused_dsgd_many
    from repro_torch.kernels.quantized_gossip import quantize_ef_many

    gen = torch.Generator(device=dev).manual_seed(12)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    beta, eta = TRAIN_MOMENTUM, SWEEP_ETA
    R = configs * SWEEP_N
    xs, us, gs = ([torch.randn((R,) + s, generator=gen, device=dev)
                   for s in shapes] for _ in range(3))
    pre = torch.rand(R, generator=gen, device=dev) + 0.2

    def per_copy():
        out = []
        for c in range(configs):
            sl = slice(c * SWEEP_N, (c + 1) * SWEEP_N)
            out.append(fused_dsgd_many([x[sl] for x in xs],
                                       [u[sl] for u in us],
                                       [g[sl] for g in gs], beta, eta,
                                       pre[sl]))
        return out

    def plain():
        return [ref.fused_dsgd_ref(x, u, g, beta, eta,
                                   pre.reshape((-1,) + (1,) * (x.ndim - 1)))
                for x, u, g in zip(xs, us, gs)]

    gx, gu = fused_dsgd_many(xs, us, gs, beta, eta, pre)
    same = all(torch.equal(_bits(torch, a), _bits(torch, wx))
               and torch.equal(_bits(torch, b), _bits(torch, wu))
               for a, b, (wx, wu) in zip(gx, gu, plain()))
    for c, (cx, cu) in enumerate(per_copy()):
        sl = slice(c * SWEEP_N, (c + 1) * SWEEP_N)
        same &= all(torch.equal(_bits(torch, a[sl]), _bits(torch, b))
                    for a, b in zip(gx + gu, cx + cu))
    if not same:
        raise SystemExit("fused_dsgd_many over the sweep's copies differs "
                         "from the plain version or from per-copy launches")
    numel = sum(x.numel() for x in xs)
    b_ms, b_by = bound_ms(5 * numel * 4 + 4 * R, 6 * numel, "float32")
    fn = lambda: fused_dsgd_many(xs, us, gs, beta, eta, pre)  # noqa: E731
    dsgd = {
        "name": f"fused_dsgd_many[sweep,{len(xs)} leaves x {R} rows,"
                f"float32,pre=per copy]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_dsgd.cu, "
                  "src/repro_torch/kernels/csrc/multi_tensor.cuh",
        "replaces": "src/repro/kernels/fused_dsgd.py:50",
        "launches": None,
        "max_abs_err": 0.0,
        "ms": time_ms(torch, fn, flush),
        "device_ms": graph_ms(torch, fn, flush),
        "per_copy_ms": time_ms(torch, per_copy, flush),
        "plain_ms": time_ms(torch, plain, flush),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }
    print(f"[sweep] {dsgd['name']}: bitwise == plain and == {configs} "
          f"per-copy launches; {dsgd['ms']:.4f} ms, device (as a graph) "
          f"{dsgd['device_ms']:.4f} ms (bound {b_ms:.5f} ms by {b_by}; per "
          f"copy {dsgd['per_copy_ms']:.4f} ms; plain {dsgd['plain_ms']:.4f}"
          f" ms)")
    del xs, us, gs, gx, gu

    qx = [torch.randn(r, CHUNK, generator=gen, device=dev)
          for _ in range(copies) for r in rows]
    qe = [0.1 * torch.randn(r, CHUNK, generator=gen, device=dev)
          for _ in range(copies) for r in rows]
    offs, key = [0] * len(qx), ref.sr_key(0, 3)
    got = quantize_ef_many(qx, qe, key, offs, fmt=COMPRESS_CODEC)
    same = True
    for i, (x, e) in enumerate(zip(qx, qe)):
        want = ref.quantize_ef_ref(x, e, key, 0, fmt=COMPRESS_CODEC)
        same &= all(torch.equal(a[i].view(torch.uint8), w.view(torch.uint8))
                    for a, w in zip(got, want))
    per = len(rows)
    for c in range(copies):
        mine = quantize_ef_many(qx[c * per:(c + 1) * per],
                                qe[c * per:(c + 1) * per], key, [0] * per,
                                fmt=COMPRESS_CODEC)
        for outs, wants in zip(got, mine):
            same &= all(torch.equal(outs[c * per + i].view(torch.uint8),
                                    w.view(torch.uint8))
                        for i, w in enumerate(wants))
    if not same:
        raise SystemExit("quantize_ef_many over the compressed sweep's "
                         "records differs from the plain version or from "
                         "per-copy launches")
    numel = sum(x.numel() for x in qx)
    nrows = sum(x.shape[0] for x in qx)
    b_ms, b_by = bound_ms(13 * numel + 4 * nrows, 23 * numel, "float32")

    def qfn():
        return quantize_ef_many(qx, qe, key, offs, fmt=COMPRESS_CODEC)

    def qper_copy():
        for c in range(copies):
            quantize_ef_many(qx[c * per:(c + 1) * per],
                             qe[c * per:(c + 1) * per], key, [0] * per,
                             fmt=COMPRESS_CODEC)

    def qplain():
        for x, e in zip(qx, qe):
            ref.quantize_ef_ref(x, e, key, 0, fmt=COMPRESS_CODEC)

    quant = {
        "name": f"quantize_ef_many[compressed sweep,{len(qx)} records,"
                f"{COMPRESS_CODEC},err]",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantized_gossip.cu, "
                  "src/repro_torch/kernels/csrc/multi_tensor.cuh",
        "replaces": "src/repro/kernels/quantized_gossip.py:71",
        "launches": None,
        "max_abs_err": 0.0,
        "ms": time_ms(torch, qfn, flush),
        "device_ms": graph_ms(torch, qfn, flush),
        "per_copy_ms": time_ms(torch, qper_copy, flush),
        "plain_ms": time_ms(torch, qplain, flush),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }
    print(f"[sweep] {quant['name']}: bitwise == plain and == {copies} "
          f"per-copy launches; {quant['ms']:.4f} ms, device (as a graph) "
          f"{quant['device_ms']:.4f} ms (bound {b_ms:.5f} ms by {b_by}; per "
          f"copy {quant['per_copy_ms']:.4f} ms; plain "
          f"{quant['plain_ms']:.4f} ms)")
    del qx, qe, got, flush
    torch.cuda.empty_cache()
    return [("sweep-fused_dsgd", dsgd),
            ("sweep-compress-quantize_ef_many", quant)]


def phase_failure_cpu_vs_card(torch, dev):
    """The failure engine on the card against the same on the CPU, every
    regime: losses within 1e-5 (relative above 1), clocks and every
    round's draws equal."""
    import numpy as np

    from repro_torch.configs.paper_mlp import MLPConfig
    from repro_torch.data.synthetic import dirichlet_classification
    from repro_torch.models import mlp
    from repro_torch.optim.decentralized import make_method
    from repro_torch.sim import (FailureModel, failure as fm,
                                 simulate_decentralized)
    from repro_torch.topology import TopologySpec

    n, steps, bs = 8, 30, 32
    data = dirichlet_classification(n, 256, dim=32, alpha=0.3, seed=4)
    params = mlp.init(MLPConfig(input_dim=32, hidden=(64,), num_classes=10),
                      seed=0, device="cpu")

    def batches(step):
        i = (step * bs) % (256 - bs)
        return data.node_x[:, i:i + bs], data.node_y[:, i:i + bs]

    regimes = (("drop", dict(drop_rate=0.3, seed=1)),
               ("stragglers", dict(straggler_rate=0.5, straggler_period=3,
                                   seed=2)),
               ("delay", dict(delay=2, seed=3)),
               ("churn", dict(churn_rate=0.1, seed=4)),
               ("sign_flip", dict(byzantine_frac=0.25,
                                  byzantine_mode="sign_flip", seed=5)),
               ("random", dict(byzantine_frac=0.25, byzantine_mode="random",
                               seed=6)),
               ("all_same", dict(byzantine_frac=0.25,
                                 byzantine_mode="all_same", seed=7)),
               ("all four", FAIL_REGIME))
    real = fm.draws
    for name, fkw in regimes:
        runs = {}
        for d in ("cpu", dev):
            seen = []

            def recording(*args):
                seen.append(real(*args))
                return seen[-1]

            fm.draws = recording
            try:
                res = simulate_decentralized(
                    loss_fn=mlp.loss_fn, params=params,
                    method=make_method("dsgdm"),
                    schedule=TopologySpec(name="base", n=n, k=2),
                    batches=batches, steps=steps, eta=0.05,
                    failure=FailureModel(**fkw), device=d)
            finally:
                fm.draws = real
            runs[d] = (res, seen)
        (rc, dc), (rd, dd) = runs["cpu"], runs[dev]
        # 1e-5, relative where a loss exceeds 1 (a random attack drives
        # the honest losses past 10, where f32 steps are 1e-6)
        err = float((abs(rc.losses - rd.losses)
                     / np.maximum(1.0, abs(rc.losses))).max())
        clocks = rc.clocks.tolist() == rd.clocks.tolist()
        draws = len(dc) == len(dd) == steps and all(
            (getattr(a, f) is None and getattr(b, f) is None)
            or torch.equal(getattr(a, f), getattr(b, f))
            for a, b in zip(dc, dd) for f in ("churn", "keep", "tau")) \
            and all((a.noise is None and b.noise is None)
                    or all(torch.equal(x, y) for x, y in zip(a.noise,
                                                             b.noise))
                    for a, b in zip(dc, dd))
        print(f"[failure-cpu-vs-card] paper MLP dsgdm, n={n} base k=2, "
              f"{steps} steps, {name}: losses max err {err:.3e} (tol 1e-5, "
              f"relative above 1), clocks equal {clocks} {rd.clocks.tolist()}, draws "
              f"equal {draws}; last loss {rd.losses[-1]:.4f}")
        if not (err <= 1e-5 and clocks and draws):
            raise SystemExit(f"card vs cpu failure run ({name}) differs: "
                             f"losses {err}, clocks {clocks}, draws {draws}")


def phase_gossip_kernels(torch, dev):
    """The gossip combines vs their plain versions on the card, bit for
    bit: both entry points of the slots combine (f32 and bf16, S = 1, 2,
    3, the last slot zeros at weight 0, as a rank that receives nothing
    takes them) at one rank's work-buffer shapes, and the quantized
    combine (int8 and fp8, S = 1, 2, 3) at the same leaves' chunk rows,
    plus every payload byte value.  Returns (phase, JSON entry) for each
    shape at the main path's S (own + one received) in f32 / int8."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gossip_mix import (gossip_mix_slots,
                                                gossip_mix_stacked)
    from repro_torch.kernels.quantized_gossip import (quantize_ef,
                                                      quantized_gossip_mix)

    gen = torch.Generator(device=dev).manual_seed(13)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def weights(S, zero_last):
        w = (torch.rand(S, generator=gen, device=dev) + 0.1).tolist()
        if zero_last:
            w[-1] = 0.0
        return w

    def same_bits(got, want):
        nan = torch.isnan(want)      # fp8's NaN codes decode to NaN
        return (got.dtype == want.dtype and got.shape == want.shape
                and torch.equal(torch.isnan(got), nan)
                and torch.equal(_bits(torch, got)[~nan],
                                _bits(torch, want)[~nan]))

    entries = []
    for name, (R, C) in GOSSIP_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            for S in (1, 2, 3):
                stack = torch.randn(S, R, C, generator=gen,
                                    device=dev).to(dtype)
                if S > 1:
                    stack[-1].zero_()
                bufs = list(stack.unbind(0))
                w = weights(S, S > 1)
                want = ref.gossip_mix_ref(bufs, w)
                got = {"slots": gossip_mix_slots(bufs, w),
                       "stacked": gossip_mix_stacked(stack, w)}
                torch.cuda.synchronize()
                for entry_point, g in got.items():
                    ok = same_bits(g, want)
                    print(f"[gossip-mix] {entry_point} {name} ({R}, {C}) "
                          f"{dname} S={S}: bitwise {ok}")
                    if not ok:
                        raise SystemExit(f"gossip_mix_{entry_point} {name} "
                                         f"{dname} S={S} differs from its "
                                         f"plain version")
                del got, want
                if S == 2 and dtype == torch.float32:
                    numel = R * C
                    b_ms, b_by = bound_ms((S + 1) * numel * 4,
                                          (2 * S - 1) * numel, "float32")
                    wt = torch.tensor(w, device=dev)
                    lib_ms = time_ms(torch, lambda: torch.tensordot(
                        wt, stack, dims=1), flush)
                    lib_dev = graph_ms(torch, lambda: torch.tensordot(
                        wt, stack, dims=1), flush)
                    for row, fn, plain, line, phase in (
                            ("slots", lambda: gossip_mix_slots(bufs, w),
                             lambda: ref.gossip_mix_ref(bufs, w), 92,
                             "dist-gossip_mix"),
                            ("stacked", lambda: gossip_mix_stacked(stack, w),
                             lambda: ref.gossip_mix_ref(stack, w), 69,
                             "dist-gossip_mix_stacked")):
                        entry = {
                            "name": f"gossip_mix_{row}[{name},float32,S=2]",
                            "route": "cuda",
                            "source":
                                "src/repro_torch/kernels/csrc/gossip_mix.cu",
                            "replaces":
                                f"src/repro/kernels/gossip_mix.py:{line}",
                            "launches": None,
                            "max_abs_err": 0.0,
                            "ms": time_ms(torch, fn, flush),
                            "device_ms": graph_ms(torch, fn, flush),
                            "plain_ms": time_ms(torch, plain, flush),
                            "bound_ms": b_ms,
                            "bound_by": b_by,
                            "library_ms": lib_ms,
                            "library_device_ms": lib_dev,
                        }
                        print(f"[gossip-mix] {entry['name']}: "
                              f"{entry['ms']:.4f} ms, device (as a graph) "
                              f"{entry['device_ms']:.4f} ms (bound "
                              f"{b_ms:.4f} ms by {b_by}; plain "
                              f"{entry['plain_ms']:.4f} ms; tensordot "
                              f"{lib_ms:.4f} ms, device {lib_dev:.4f} ms)")
                        entries.append((phase, entry))
                del stack, bufs
                torch.cuda.empty_cache()

    # every payload byte value through both formats, 0 to 3 slots
    own = torch.randn(4, 256, generator=gen, device=dev)
    codes = torch.arange(256, device=dev, dtype=torch.uint8).repeat(4, 1)
    for fmt, pdt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        q = codes.view(pdt)
        sc = torch.rand(4, 1, generator=gen, device=dev)
        for S in (0, 1, 2, 3):
            w = weights(S + 1, False)
            ok = same_bits(quantized_gossip_mix(own, [q] * S, [sc] * S, w),
                           ref.quantized_gossip_mix_ref(own, [q] * S,
                                                        [sc] * S, w))
            print(f"[gossip-mix] quantized {fmt}, all 256 byte values, "
                  f"S={S}: bitwise {ok} (NaN codes decode to NaN)")
            if not ok:
                raise SystemExit(f"quantized_gossip_mix {fmt} S={S} differs "
                                 f"from its plain version on the byte "
                                 f"sweep")
    for name, (R, C) in QMIX_SHAPES:
        own = torch.randn(R, C, generator=gen, device=dev)
        for fmt in ("int8", "fp8"):
            for S in (1, 2, 3):
                qs, scales = [], []
                for s in range(S):
                    x = torch.randn(R, C, generator=gen, device=dev)
                    q, sc, _ = quantize_ef(x, None, s + 1, 0, fmt=fmt)
                    del x
                    if S > 1 and s == S - 1:
                        q.zero_()
                        sc.zero_()
                    qs.append(q)
                    scales.append(sc)
                w = weights(S + 1, S > 1)
                want = ref.quantized_gossip_mix_ref(own, qs, scales, w)
                got = quantized_gossip_mix(own, qs, scales, w)
                torch.cuda.synchronize()
                ok = same_bits(got, want)
                print(f"[gossip-mix] quantized {name} ({R}, {C}) {fmt} "
                      f"S={S}: bitwise {ok}")
                if not ok:
                    raise SystemExit(f"quantized_gossip_mix {name} {fmt} "
                                     f"S={S} differs from its plain version")
                del got, want
                if S == 1 and fmt == COMPRESS_CODEC:
                    numel = R * C
                    # own and out f32, one payload byte, one scale per row;
                    # 4 f32 operations per element
                    b_ms, b_by = bound_ms(9 * numel + 4 * R, 4 * numel,
                                          "float32")
                    entry = {
                        "name": f"quantized_gossip_mix[{name},{fmt},S=1]",
                        "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/"
                                  "quantized_gossip.cu",
                        "replaces":
                            "src/repro/kernels/quantized_gossip.py:115",
                        "launches": None,
                        "max_abs_err": 0.0,
                        "ms": time_ms(torch, lambda: quantized_gossip_mix(
                            own, qs, scales, w), flush),
                        "device_ms": graph_ms(
                            torch, lambda: quantized_gossip_mix(
                                own, qs, scales, w), flush),
                        "plain_ms": time_ms(
                            torch, lambda: ref.quantized_gossip_mix_ref(
                                own, qs, scales, w), flush),
                        "bound_ms": b_ms,
                        "bound_by": b_by,
                        "library_ms": None,
                    }
                    print(f"[gossip-mix] {entry['name']} ({R} x {C}): "
                          f"{entry['ms']:.4f} ms, device (as a graph) "
                          f"{entry['device_ms']:.4f} ms (bound {b_ms:.4f} "
                          f"ms by {b_by}; plain {entry['plain_ms']:.4f} ms)")
                    entries.append(("dist-compress-quantized_gossip_mix",
                                    entry))
                del qs, scales
                torch.cuda.empty_cache()
        del own
    entries += gossip_grouped(torch, dev, gen, flush)
    entries += qmix_grouped(torch, dev, gen, flush)
    del flush
    torch.cuda.empty_cache()
    return entries


def qmix_grouped(torch, dev, gen, flush):
    """The grouped quantized combine (``quantized_gossip_mix_many``) bit
    for bit against the plain version buffer by buffer: a ragged list (C
    in {2, 6, 128, 250, 256, 384, 1024}, unaligned buffers, every payload
    byte value) with 0 to 3 payloads and the most a table takes, int8 and
    fp8, a list longer than one table, and one rank's 106 gemma3-1b
    reference leaves with one received payload each (S = 1, the main
    path's), int8 and fp8, timed (``device_ms`` as a CUDA graph) against
    the plain loop.  Returns the two gemma3-1b entries."""
    from repro_torch.kernels import multi_tensor as mt
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantized_gossip import (
        MAX_MIX_SLOTS, quantize_ef_many, quantized_gossip_mix_many)

    def nan_equal(got, want):
        nan = torch.isnan(want)      # fp8's NaN codes decode to NaN
        return (got.dtype == want.dtype and got.shape == want.shape
                and torch.equal(torch.isnan(got), nan)
                and torch.equal(_bits(torch, got)[~nan],
                                _bits(torch, want)[~nan]))

    def check(name, owns, q_lists, s_lists, w, want_launches):
        before = (quantized_gossip_mix_many.launches,
                  quantized_gossip_mix_many.segments)
        got = quantized_gossip_mix_many(owns, q_lists, s_lists, w)
        torch.cuda.synchronize()
        launches = quantized_gossip_mix_many.launches - before[0]
        segments = quantized_gossip_mix_many.segments - before[1]
        same = all(nan_equal(g, ref.quantized_gossip_mix_ref(o, qs, ss, w))
                   for g, o, qs, ss in zip(got, owns, q_lists, s_lists))
        del got
        print(f"[gossip-mix] grouped quantized {name}, S={len(w) - 1}: "
              f"{launches} launch(es) over {segments} buffers, bitwise "
              f"{same}")
        if not same or launches != want_launches:
            raise SystemExit(f"quantized_gossip_mix_many {name} S="
                             f"{len(w) - 1}: bitwise {same}, {launches} "
                             f"launches (expected {want_launches})")

    def payloads(rows_cols, fmt, S, key0):
        """S payloads per (R, C), as the quantizer makes them; the last
        slot zeros (a slot this rank receives nothing in)."""
        q_lists, s_lists = [[] for _ in rows_cols], [[] for _ in rows_cols]
        for s in range(S):
            xs = [torch.randn(R, C, generator=gen, device=dev)
                  for R, C in rows_cols]
            qs, scs, _ = quantize_ef_many(xs, None, key0 + s,
                                          [0] * len(xs), fmt=fmt)
            del xs, _
            for i, (q, sc) in enumerate(zip(qs, scs)):
                if S > 1 and s == S - 1:
                    q.zero_()
                    sc.zero_()
                q_lists[i].append(q)
                s_lists[i].append(sc)
        return q_lists, s_lists

    def weights(S):
        w = (torch.rand(S + 1, generator=gen, device=dev) + 0.1).tolist()
        if S > 1:
            w[-1] = 0.0
        return w

    # ragged: (R, C, unaligned); every byte value in the first payload
    specs = [(37, 256, False), (5, 2, False), (4, 6, True), (9, 128, False),
             (11, 384, False), (6, 1024, False), (3, 250, False),
             (13, 256, True), (1, 256, False)]
    name = f"ragged ({len(specs)} buffers)"
    for fmt in ("int8", "fp8"):
        for S in (0, 1, 2, 3, MAX_MIX_SLOTS):
            q_lists, s_lists = payloads([(R, C) for R, C, _ in specs], fmt,
                                        S, 100 * S)
            owns = [torch.randn(R, C, generator=gen, device=dev)
                    for R, C, _ in specs]
            if S:
                q_lists[0][0].view(torch.uint8).view(-1)[:256] = \
                    torch.arange(256, device=dev, dtype=torch.uint8)
            for i, (_, _, unaligned) in enumerate(specs):
                if unaligned:
                    owns[i] = _unaligned_like(torch, owns[i])
                    q_lists[i] = [_unaligned_like(torch, q)
                                  for q in q_lists[i]]
            check(f"{name} {fmt}", owns, q_lists, s_lists, weights(S), 1)
            del owns, q_lists, s_lists
    n = 2 * mt.capacity(4, mt.ROW_META_WORDS) + 1
    shapes = [(1 + i % 3, 256 if i % 2 else 6) for i in range(n)]
    q_lists, s_lists = payloads(shapes, "int8", 1, 7)
    check(f"{n} buffers, past one table, int8",
          [torch.randn(sh, generator=gen, device=dev) for sh in shapes],
          q_lists, s_lists, weights(1), 3)
    del q_lists, s_lists

    rows = leaf_rows(torch, 1)
    shapes = [(r, CHUNK) for r in rows]
    owns = [torch.randn(sh, generator=gen, device=dev) for sh in shapes]
    numel = sum(rows) * CHUNK
    # own and out f32, one payload byte, one scale per row; 4 f32
    # operations per element
    b_ms, b_by = bound_ms(9 * numel + 4 * sum(rows), 4 * numel, "float32")
    entries = []
    for fmt in ("int8", "fp8"):
        q_lists, s_lists = payloads(shapes, fmt, 1, 1)
        w = weights(1)
        name = f"gemma3-1b, one rank's {len(rows)} reference leaves {fmt}"
        check(name, owns, q_lists, s_lists, w, 1)

        def fn():
            return quantized_gossip_mix_many(owns, q_lists, s_lists, w)

        def plain():
            for o, qs, ss in zip(owns, q_lists, s_lists):
                ref.quantized_gossip_mix_ref(o, qs, ss, w)

        entry = {
            "name": f"quantized_gossip_mix_many[{len(rows)} leaves,one rank,"
                    f"{fmt},S=1]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quantized_gossip.cu, "
                      "src/repro_torch/kernels/csrc/multi_tensor.cuh",
            "replaces": "src/repro/kernels/quantized_gossip.py:115",
            "launches": None,
            "segments": None,
            "max_abs_err": 0.0,
            "ms": time_ms(torch, fn, flush),
            "device_ms": graph_ms(torch, fn, flush),
            "plain_ms": time_ms(torch, plain, flush, runs=5, warmup=1),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        }
        print(f"[gossip-mix] {entry['name']} ({numel / 1e9:.3f} B "
              f"elements): {entry['ms']:.4f} ms, device (as a graph) "
              f"{entry['device_ms']:.4f} ms (bound {b_ms:.4f} ms by {b_by}; "
              f"plain {entry['plain_ms']:.4f} ms)")
        entries.append(("dist-compress-quantized_gossip_mix_many", entry))
        del q_lists, s_lists
        torch.cuda.empty_cache()
    del owns
    torch.cuda.empty_cache()
    return entries


def gossip_grouped(torch, dev, gen, flush):
    """The grouped combine (``gossip_mix_slots_many``) over one rank's f32
    work buffers of every gemma3-1b tensor, own + one received (S = 2),
    f32 and bf16 outputs, and over a ragged list of mixed dtypes, bit for
    bit against the plain version tensor by tensor; returns the JSON
    entries of the two timed outputs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gossip_mix import gossip_mix_slots_many

    def check(name, lists, w, out_dtype):
        before = (gossip_mix_slots_many.launches,
                  gossip_mix_slots_many.segments)
        got = gossip_mix_slots_many(lists, w, out_dtype)
        torch.cuda.synchronize()
        launches = gossip_mix_slots_many.launches - before[0]
        segments = gossip_mix_slots_many.segments - before[1]
        outs = out_dtype if isinstance(out_dtype, list) else \
            [out_dtype] * len(lists)
        same = all(torch.equal(_bits(torch, g), _bits(
            torch, ref.gossip_mix_ref(bufs, w, out_dtype=d)))
            for g, bufs, d in zip(got, lists, outs))
        print(f"[gossip-mix] grouped {name} -> {out_dtype}: {launches} "
              f"launch(es) over {segments} tensors, bitwise {same}")
        if not same:
            raise SystemExit(f"gossip_mix_slots_many {name} differs from "
                             f"its plain version")
        del got

    # ragged: f32 and bf16 buffers, an empty tensor, an unaligned one,
    # outputs of either type
    lists = []
    for shape, dtype in (((1, 1), torch.float32), ((1, 1152), torch.bfloat16),
                         ((1, 0), torch.float32), ((7, 5), torch.bfloat16),
                         ((1, 70001), torch.float32)):
        lists.append([torch.randn(shape, generator=gen, device=dev,
                                  dtype=dtype) for _ in range(3)])
    lists.append([torch.randn(1 + 1152, generator=gen, device=dev)[1:]
                  for _ in range(3)])            # 4 bytes off alignment
    w3 = (torch.rand(3, generator=gen, device=dev) + 0.1).tolist()
    for out in (None, torch.float32, torch.bfloat16,
                [torch.bfloat16, torch.float32] * 3):
        check("ragged (f32 + bf16, empty, unaligned), S=3", lists, w3, out)

    S = 2
    lists = [[torch.randn((1,) + shape, generator=gen, device=dev)
              for _ in range(S)] for shape in gemma_shapes(torch)]
    w = (torch.rand(S, generator=gen, device=dev) + 0.1).tolist()
    numel = sum(b[0].numel() for b in lists)
    name = f"gemma3-1b, one rank's {len(lists)} f32 work buffers, S={S}"
    wt = torch.tensor(w, device=dev)
    stacks = [torch.stack(b) for b in lists]
    entries = []
    for out in (torch.float32, torch.bfloat16):
        check(name, lists, w, out)
        dname = str(out).split(".")[1]
        b_ms, b_by = bound_ms((4 * S + out.itemsize) * numel,
                              (2 * S - 1) * numel, "float32")

        def fn():
            return gossip_mix_slots_many(lists, w, out)

        def plain():
            return [ref.gossip_mix_ref(b, w, out_dtype=out) for b in lists]

        def library():
            return [torch.tensordot(wt, st, dims=1).to(out) for st in stacks]

        entry = {
            "name": f"gossip_mix_slots_many[{len(lists)} tensors,"
                    f"float32->{dname},S={S}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gossip_mix.cu, "
                      "src/repro_torch/kernels/csrc/multi_tensor.cuh",
            "replaces": "src/repro/kernels/gossip_mix.py:92",
            "launches": None,
            "max_abs_err": 0.0,
            "ms": time_ms(torch, fn, flush),
            "device_ms": graph_ms(torch, fn, flush),
            "plain_ms": time_ms(torch, plain, flush, runs=5, warmup=1),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": time_ms(torch, library, flush, runs=5, warmup=1),
            "library_device_ms": graph_ms(torch, library, flush, runs=5),
        }
        print(f"[gossip-mix] {entry['name']}: {entry['ms']:.4f} ms, device "
              f"(as a graph) {entry['device_ms']:.4f} ms (bound {b_ms:.4f} "
              f"ms by {b_by}; plain {entry['plain_ms']:.4f} ms; per-tensor "
              f"tensordot {entry['library_ms']:.4f} ms, device "
              f"{entry['library_device_ms']:.4f} ms)")
        entries.append(("dist-gossip_mix", entry))
    del lists, stacks
    torch.cuda.empty_cache()
    return entries


def _payload_digest(q, scale):
    """sha256 of a payload's bytes (q, then the scales), on the host."""
    import hashlib

    import torch
    h = hashlib.sha256(q.contiguous().view(torch.uint8).cpu().numpy())
    h.update(scale.contiguous().cpu().numpy())
    return h.hexdigest()


def _record_payloads(ops, digests, count, nodes):
    """Wrap ``ops.quantize_payload_many`` so that the first ``count``
    buffers it quantizes leave one digest per node's rows (``nodes`` equal
    row blocks) in ``digests``; returns the function to restore."""
    real = ops.quantize_payload_many

    def recording(xs, errs=None, *, fmt, key, row_offsets):
        xs = list(xs)
        out = real(xs, errs, fmt=fmt, key=key, row_offsets=row_offsets)
        for x, q, sc in zip(xs, out[0], out[1]):
            if len(digests) < count:
                rows = x.shape[0] // nodes
                digests.append([_payload_digest(
                    q[r * rows:(r + 1) * rows], sc[r * rows:(r + 1) * rows])
                    for r in range(nodes)])
        return out

    ops.quantize_payload_many = recording
    return real


def _step_spans(marks, start="step"):
    """Per step, the CUDA-event time (ms) of each span, keyed by the mark
    that opens it and summed over its repeats: "step" is the forward and
    backward, "update" the fused update, "quantize", "exchange" and
    "combine" the mixer's per-tensor (or per-leaf) phases.  ``start``
    names the mark that opens a step (a speculative round's "round")."""
    steps, cur = [], None
    for name, ev in marks:
        if name == start:
            cur = [(name, ev)]
        elif cur is not None:
            cur.append((name, ev))
            if name == "end":
                steps.append(cur)
                cur = None
    out = []
    for seq in steps:
        spans = {}
        for (a, ea), (_, eb) in zip(seq, seq[1:]):
            spans[a] = spans.get(a, 0.0) + ea.elapsed_time(eb)
        out.append(spans)
    return out


def _tree_digest(tree) -> str:
    """sha256 of a flat dict's (or a method state's) keys and bytes, in
    key order; an int (``ct``) by its value."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for k in sorted(tree):
        v = tree[k]
        h.update(k.encode())
        if isinstance(v, dict):
            h.update(_tree_digest(v).encode())
        elif isinstance(v, torch.Tensor):
            h.update(v.detach().reshape(-1).view(torch.uint8).cpu().numpy())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


def _dist_rank(rank, device, opts, ref_paths, disp, n_leaves, extra=0):
    """One rank of ``[dist]``: the launcher's per-rank entry
    (``train_rank``) with every kernel counter set to 0 just before and
    read just after, and digests of its parameters and state; then
    (``ref_paths``) this node's parameters (and EF residuals) against the
    simulation's, element by element, on the card; or (``extra``) that
    many more steps through the bundle, and their losses."""
    import torch
    from repro_torch import trace
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.fused_dsgd import fused_dsgd, fused_dsgd_many
    from repro_torch.kernels.gossip_mix import (gossip_mix_slots,
                                                gossip_mix_slots_many,
                                                gossip_mix_stacked)
    from repro_torch.kernels.quantized_gossip import (
        quantize_ef, quantize_ef_many, quantized_gossip_mix,
        quantized_gossip_mix_many)
    from repro_torch.launch.train import train_rank

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"gossip_mix": gossip_mix_slots,
                "gossip_mix_many": gossip_mix_slots_many,
                "gossip_mix_stacked": gossip_mix_stacked,
                "fused_dsgd": fused_dsgd, "fused_dsgd_many": fused_dsgd_many,
                "flash": flash_attention_fwd, "quantize_ef": quantize_ef,
                "quantized_gossip_mix": quantized_gossip_mix,
                "quantize_ef_many": quantize_ef_many,
                "quantized_gossip_mix_many": quantized_gossip_mix_many}
    grouped = {"gossip_mix_many-tensors": gossip_mix_slots_many,
               "fused_dsgd_many-tensors": fused_dsgd_many,
               "quantize_ef_many-segments": quantize_ef_many,
               "quantized_gossip_mix_many-segments":
                   quantized_gossip_mix_many}
    payloads = []
    real = _record_payloads(ops, payloads, n_leaves if opts.compress else 0,
                            1)
    for c in counters.values():
        c.launches = 0
    for c in grouped.values():
        c.segments = 0
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    try:
        with trace.cuda_marks() as marks:
            res = train_rank(opts, device)
            torch.cuda.synchronize()
    finally:
        ops.quantize_payload_many = real
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    launches.update({k: c.segments for k, c in grouped.items()})
    peak = torch.cuda.max_memory_allocated(device)
    reserved = torch.cuda.max_memory_reserved(device)
    spans = _step_spans(marks)
    del marks
    on_card = all(v.device == device for v in res.params.values())
    if res.state.get("ef") is not None:
        on_card &= all(v.device == device for v in res.state["ef"].values())
    params, ef, ct = res.params, res.state.get("ef"), res.state.get("ct")
    losses, sent = res.losses, dict(res.bundle.mixer.stats)
    digests = {"params": _tree_digest(params),
               "state": _tree_digest(res.state)}
    if extra:
        from repro_torch.configs import get_config
        from repro_torch.launch.train import rank_batch
        cfg = get_config(opts.arch)
        if opts.reduced:
            cfg = cfg.reduced()
        p, o, more = res.params, res.state, []
        del params, res.params, res.state
        for step in range(opts.steps, opts.steps + extra):
            p, o, loss = res.bundle.step_fn(
                p, o, rank_batch(cfg, opts, step, TRAIN_N, rank, device),
                step)
            more.append(float(loss))
        digests["extra"] = {"losses": more}
        params = p
        del p, o
    # the momentum and the mixer's buffers go before the check: the three
    # ranks share the card, and one still training needs its room
    del res
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)

    def compare(got, want, floor):
        """Elementwise |got - want| <= 2^-5 |want| + floor[k]: four bf16
        ulps of the element or more, plus a per-tensor floor; in slices
        of ``DIST_CHECK_SLICE`` elements, so that the check needs little
        memory beside the parameters."""
        worst = {"differing": 0, "violations": 0, "max_abs": 0.0,
                 "max_ratio": 0.0, "elements": 0}
        for k, g in got.items():
            for a, b in zip(g[0].reshape(-1).split(DIST_CHECK_SLICE),
                            want[k].reshape(-1).split(DIST_CHECK_SLICE)):
                s = b.to(device).float()
                diff = (a.float() - s).abs()
                tol = 2.0 ** -5 * s.abs() + floor[k]
                worst["elements"] += diff.numel()
                worst["differing"] += int((diff > 0).sum())
                worst["violations"] += int((diff > tol).sum())
                worst["max_abs"] = max(worst["max_abs"],
                                       float(diff.max()))
                pos = tol > 0
                if bool(pos.any()):
                    worst["max_ratio"] = max(worst["max_ratio"], float(
                        (diff[pos] / tol[pos]).max()))
                del s, diff, tol, pos
        return worst

    checks = {}
    if ref_paths is not None:
        ref = torch.load(ref_paths[rank], mmap=True)
        checks["params"] = compare(
            params, ref["params"], {k: 2.0 ** -1 * v for k, v in disp.items()})
        if "ef" in ref:
            checks["ef"] = compare(
                ef, ref["ef"],
                {k: 2.0 ** -1 * float(v.float().abs().max())
                 for k, v in ref["ef"].items()})
        del ref
    check_peak = torch.cuda.max_memory_allocated(device)
    return {"rank": rank, "device": str(device), "on_card": on_card,
            "losses": losses, "launches": launches, "peak": peak,
            "check_peak": check_peak, "reserved": reserved, "wall": wall,
            "spans": spans, "sent": sent, "ct": ct, "digests": digests,
            "payloads": payloads, "checks": checks}


def phase_dist(torch, dev, card, compression=None):
    """Full-width gemma3-1b training across processes (``[dist]``): the
    ``[train]`` cell split into TRAIN_N ranks of one node each, sharing
    the card through gloo with pinned host staging, through the
    launcher's per-rank entry; with ``compression``, ``[dist-compress]``.
    The simulation engine on the same parameters and batches, run here
    first, is the oracle.  Returns the gossip kernels' launch counts
    over all ranks by phase, and what the later phases hold against this
    run: its options, the tensors' sizes and each rank's results."""
    from repro_torch.compress import reference_leaves
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.compress.mixing import rows_bytes
    from repro_torch.dist.gossip import BUCKET_BYTES, plan_buckets
    from repro_torch.kernels import ops
    from repro_torch.launch.distributed import spawn_local
    from repro_torch.launch.train import TrainOptions
    from repro_torch.models import model as M
    from repro_torch.optim.decentralized import make_method
    from repro_torch.sim.engine import simulate_decentralized
    from repro_torch.topology import TopologySpec, build_schedule

    tag = "[dist-compress]" if compression else "[dist]"
    pre = "dist-compress-" if compression else "dist-"
    cfg = get_config("gemma3-1b")
    spec = TopologySpec(name="base", n=TRAIN_N, k=1)
    opts = TrainOptions(arch="gemma3-1b", topology="base", k=1,
                        method="dsgdm", eta=TRAIN_ETA, steps=DIST_STEPS,
                        batch=TRAIN_N * TRAIN_B, seq=TRAIN_SEQ,
                        compress=compression and compression.to_json(),
                        log_every=1)

    # the oracle, on the same parameters and batches, its per-node losses
    # and (compressed) step 0's payload digests recorded on the way
    init = M.init(cfg, seed=0, dtype=torch.bfloat16, device=dev).state_dict()
    leaves = reference_leaves(init)
    # a rank's buckets of reference leaves (its own f32 chunk rows)
    leaf_buckets = len(plan_buckets(
        [rows_bytes([init[k][None] for k in g], CHUNK) for g in leaves],
        BUCKET_BYTES))
    numel = {k: v.numel() for k, v in init.items() if v.is_floating_point()}
    shapes = {k: list(v.shape) for k, v in init.items()}
    per_node, sim_digests = [], []

    def loss_fn(p, b):
        loss = M.loss_fn(cfg, p, b)[0]
        per_node.append(loss.detach())
        return loss

    def batches(step):
        raw = token_batches(step, batch=TRAIN_N * TRAIN_B, seq=TRAIN_SEQ,
                            vocab=cfg.vocab_size)
        return {k: v.reshape(TRAIN_N, TRAIN_B, TRAIN_SEQ)
                for k, v in raw.items()}

    t0 = time.perf_counter()
    real = _record_payloads(ops, sim_digests,
                            len(leaves) if compression else 0, TRAIN_N)
    try:
        res = simulate_decentralized(
            loss_fn=loss_fn, params=init,
            method=make_method("dsgdm", TRAIN_MOMENTUM,
                               compression=compression),
            schedule=spec, batches=batches, steps=DIST_STEPS, eta=TRAIN_ETA,
            device=dev)
        torch.cuda.synchronize()
    finally:
        ops.quantize_payload_many = real
    sim_s = time.perf_counter() - t0
    sim_losses = torch.stack(per_node).reshape(DIST_STEPS,
                                               TRAIN_N).T.cpu().tolist()
    disp = {k: float((res.params[k].float() - v.float()).abs().max())
            for k, v in init.items()}
    del init, per_node
    ref_dir = ROOT / "build" / "chip_smoke_dist"
    ref_dir.mkdir(parents=True, exist_ok=True)
    paths = [ref_dir / f"{pre}node{r}.pt" for r in range(TRAIN_N)]
    t0 = time.perf_counter()
    for r, path in enumerate(paths):
        node = {"params": {k: v[r].cpu() for k, v in res.params.items()}}
        if compression:
            node["ef"] = {k: v[r].cpu() for k, v in res.state["ef"].items()}
        torch.save(node, path)
        del node
    print(f"{tag} oracle: simulate_decentralized, {DIST_STEPS} steps in "
          f"{sim_s:.1f}s; per-node results written in "
          f"{time.perf_counter() - t0:.1f}s")
    del res
    # the ranks share the card with this process: what it still holds,
    # cycles of earlier phases included, goes back to the card first
    before = torch.cuda.memory_allocated(dev)
    gc.collect()
    torch.cuda.empty_cache()
    free, total_mem = torch.cuda.mem_get_info(dev)
    print(f"{tag} before the spawn this process holds "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated "
          f"({before / 2**30:.2f} before gc.collect()), "
          f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved; "
          f"{free / 2**30:.2f} of {total_mem / 2**30:.2f} GiB free on the "
          f"card")

    t0 = time.perf_counter()
    try:
        results = spawn_local(
            _dist_rank, TRAIN_N, backend="gloo", device=dev,
            timeout=DIST_TIMEOUT,
            args=(opts, [str(p) for p in paths], disp, len(leaves)))
    finally:
        for path in paths:
            path.unlink(missing_ok=True)
    total_s = time.perf_counter() - t0

    plan = build_schedule(spec).as_ppermute_plan()
    f32_bytes = 4 * sum(numel.values())
    wire = f32_bytes
    if compression:
        wire = sum(compression.wire_bytes(sum(numel[k] for k in g))
                   for g in leaves)
    n_comp = leaf_buckets * DIST_STEPS if compression else 0
    buckets = len(plan_buckets([4 * n for n in numel.values()],
                               BUCKET_BYTES))
    # the step checkpoints each pattern block (opts.remat, the step's
    # default): the backward runs their forward, and flash, again
    flash = cfg.num_layers + (cfg.num_blocks * len(cfg.pattern)
                              if opts.remat else 0)
    want = {"gossip_mix": 0,
            "gossip_mix_many": 0 if compression else buckets * DIST_STEPS,
            "gossip_mix_many-tensors": 0 if compression
            else len(numel) * DIST_STEPS,
            "gossip_mix_stacked": 0, "fused_dsgd": 0,
            "fused_dsgd_many": DIST_STEPS,
            "fused_dsgd_many-tensors": len(numel) * DIST_STEPS,
            "flash": flash * DIST_STEPS,
            "quantize_ef": 0, "quantized_gossip_mix": 0,
            "quantize_ef_many": n_comp, "quantized_gossip_mix_many": n_comp,
            "quantize_ef_many-segments":
                len(leaves) * DIST_STEPS if compression else 0,
            "quantized_gossip_mix_many-segments":
                len(leaves) * DIST_STEPS if compression else 0}
    # a bucket holds S buffers per tensor until its combine, and its
    # outputs: at most (S + 1) x the cap over the per-tensor mixer's peak;
    # compressed, its chunk rows, err rows and residuals (f32) and its
    # payloads: at most (3.25 + S / 4) x the cap over the leaf-by-leaf
    # mixer's
    slots = 1 + max(len(rp.slots) for rp in plan.rounds)
    if compression:
        peak_bound = (DIST_COMPRESS_PEAK_GIB * 2**30
                      + (3.25 + (slots - 1) / 4) * BUCKET_BYTES)
    else:
        peak_bound = DIST_PEAK_GIB * 2**30 + (slots + 1) * BUCKET_BYTES
    print(f"{tag} gemma3-1b full width in bf16, {TRAIN_N} ranks on "
          f"{dev} (gloo, each message staged through pinned host memory: "
          f"not NCCL's times), base k=1, dsgdm {TRAIN_MOMENTUM}, eta "
          f"{TRAIN_ETA}, {TRAIN_B} x {TRAIN_SEQ} tokens per rank, "
          f"{DIST_STEPS} steps, remat={opts.remat} ({flash} flash "
          f"launches per rank per step); spawn to join {total_s:.1f}s")
    fails = []
    for res in results:
        r = res["rank"]
        sends = sum(1 for s in range(DIST_STEPS)
                    for sp in plan.rounds[s % len(plan)].slots
                    for src, _ in sp.perm if src == r)
        per_send = 2 * len(leaves) if compression else len(numel)
        want_sent = {"messages": sends * per_send, "bytes": sends * wire}
        if res["launches"] != want:
            fails.append(f"rank {r} launches {res['launches']}, expected "
                         f"{want}")
        if res["peak"] > peak_bound:
            fails.append(f"rank {r} peak memory {res['peak'] / 2**30:.2f} "
                         f"GiB over {peak_bound / 2**30:.2f} GiB")
        if not (res["on_card"] and res["device"].startswith("cuda")):
            fails.append(f"rank {r} ran on {res['device']}, or its tensors "
                         f"left the card")
        if res["sent"] != want_sent:
            fails.append(f"rank {r} sent {res['sent']}, the plan asks "
                         f"{want_sent}")
        got_l, sim_l = res["losses"], sim_losses[r]
        loss_err = [abs(a - b) for a, b in zip(got_l, sim_l)]
        if not (len(got_l) == DIST_STEPS and got_l[0] == sim_l[0]
                and max(loss_err) <= DIST_LOSS_TOL):
            fails.append(f"rank {r} losses {got_l}, simulation {sim_l}")
        for what, c in res["checks"].items():
            print(f"{tag} rank {r} {what} vs the simulation: "
                  f"{c['differing']} of {c['elements']} elements differ, "
                  f"max abs {c['max_abs']:.3e}, worst |diff|/tol "
                  f"{c['max_ratio']:.3f}, {c['violations']} over tol")
            if c["violations"]:
                fails.append(f"rank {r} {what}: {c['violations']} elements "
                             f"over tolerance")
        if compression:
            same = [d[0] for d in res["payloads"]] \
                == [d[r] for d in sim_digests]
            print(f"{tag} rank {r} step 0 payloads (q, scale) of "
                  f"{len(res['payloads'])} reference leaves equal the "
                  f"simulation's rows of node {r} bit for bit: {same}")
            if not same or len(res["payloads"]) != len(leaves):
                fails.append(f"rank {r} step 0 payloads differ from the "
                             f"simulation's")
            if res["ct"] != DIST_STEPS:
                fails.append(f"rank {r} ct = {res['ct']}")
        spans = res["spans"][1:]
        med = {k: statistics.median(s.get(k, 0.0) for s in spans)
               for k in ("step", "update", "quantize", "exchange",
                         "combine")}
        step_ms = statistics.median(sum(s.values()) for s in spans)
        print(f"{tag} rank {r} {card}: {step_ms:.1f} ms/step (median of "
              f"steps 1-{DIST_STEPS - 1}, CUDA events): forward+backward "
              f"{med['step']:.1f}, update {med['update']:.1f}"
              + (f", quantize {med['quantize']:.1f}" if compression else "")
              + f", exchange {med['exchange']:.1f}, combine "
              f"{med['combine']:.1f} ms; wall {res['wall']:.1f}s; peak "
              f"memory {res['peak'] / 2**30:.2f} GiB (the check after it "
              f"{res['check_peak'] / 2**30:.2f} GiB; training reserved at "
              f"most {res['reserved'] / 2**30:.2f} GiB); losses "
              f"{[round(x, 4) for x in got_l]} (simulation "
              f"{[round(x, 4) for x in sim_l]}, equal per step: "
              f"{[a == b for a, b in zip(got_l, sim_l)]}, max diff "
              f"{max(loss_err):.3e})")
        print(f"{tag} rank {r} sent {res['sent']['bytes'] / DIST_STEPS:.0f} "
              f"bytes per step in {res['sent']['messages']} messages over "
              f"{DIST_STEPS} steps: {sends} plan sends x {wire} bytes"
              + (f" ({f32_bytes / wire:.3f}x fewer than f32's {f32_bytes})"
                 if compression else " (the f32 tree)"))
        print(f"{tag} rank {r} launches over {DIST_STEPS} steps: "
              f"{res['launches']}")
    if fails:
        raise SystemExit(f"{tag} failed:\n" + "\n".join(fails))
    total = {k: sum(res["launches"][k] for res in results)
             for k in ("gossip_mix", "gossip_mix_many", "gossip_mix_stacked",
                       "quantize_ef_many", "quantized_gossip_mix_many",
                       "quantize_ef_many-segments",
                       "quantized_gossip_mix_many-segments")}
    peak = max(res["peak"] for res in results)
    if compression:
        print(f"{tag} quantize and quantized-combine launches "
              f"{total['quantize_ef_many']} and "
              f"{total['quantized_gossip_mix_many']} = {leaf_buckets} "
              f"buckets of at most {BUCKET_BYTES >> 20} MiB x {DIST_STEPS} "
              f"steps x {TRAIN_N} ranks, over {len(leaves)} reference "
              f"leaves per step; peak memory per rank at most "
              f"{peak / 2**30:.2f} GiB, bound {peak_bound / 2**30:.2f} GiB "
              f"= {DIST_COMPRESS_PEAK_GIB} GiB (the leaf-by-leaf mixer's) + "
              f"(3.25 + {slots - 1} / 4) x the cap")
        qmix = total["quantized_gossip_mix_many"]
        return {pre + "quantized_gossip_mix": qmix,
                pre + "quantized_gossip_mix_many": qmix,
                pre + "quantized_gossip_mix_many-segments":
                    total["quantized_gossip_mix_many-segments"],
                pre + "quantize_ef_many": total["quantize_ef_many"],
                pre + "quantize_ef_many-segments":
                    total["quantize_ef_many-segments"]}, None
    print(f"{tag} combine launches {total['gossip_mix_many']} = {buckets} "
          f"buckets of at most {BUCKET_BYTES >> 20} MiB x {DIST_STEPS} steps "
          f"x {TRAIN_N} ranks, over {len(numel)} tensors per round; peak "
          f"memory per rank at most {peak / 2**30:.2f} GiB with remat="
          f"{opts.remat} ({DIST_PEAK_GIB} GiB measured without remat), "
          f"bound "
          f"{peak_bound / 2**30:.2f} GiB = {DIST_PEAK_GIB} GiB (the "
          f"per-tensor mixer's) + (S + 1 = {slots + 1}) x the cap")
    return ({pre + "gossip_mix": total["gossip_mix_many"]
             + total["gossip_mix"],
             pre + "gossip_mix_stacked": total["gossip_mix_stacked"]},
            {"opts": opts, "numel": numel, "shapes": shapes,
             "results": results})


def phase_dist_overlap(torch, dev, card, seq):
    """``[dist-overlap]``: the ``[dist]`` cell with ``overlap=True``
    through the launcher's per-rank entry, held bit for bit against
    ``[dist]``'s run (``seq``, from :func:`phase_dist`); then one more
    overlapped step per rank.  Returns each rank's results."""
    from repro_torch.dist.gossip import BUCKET_BYTES, plan_buckets
    from repro_torch.dist.steps import overlap_groups
    from repro_torch.launch.distributed import spawn_local

    tag = "[dist-overlap]"
    opts = dataclasses.replace(seq["opts"], overlap=True)
    numel = seq["numel"]
    groups = overlap_groups(list(numel))
    buckets = sum(len(plan_buckets([4 * numel[k] for k in g], BUCKET_BYTES))
                  for g in groups)
    t0 = time.perf_counter()
    results = spawn_local(_dist_rank, TRAIN_N, backend="gloo", device=dev,
                          timeout=DIST_TIMEOUT,
                          args=(opts, None, None, 0, 1))
    total_s = time.perf_counter() - t0
    per_step = {"fused_dsgd_many": len(groups),
                "fused_dsgd_many-tensors": len(numel),
                "gossip_mix_many": buckets,
                "gossip_mix_many-tensors": len(numel)}
    names = [".".join(g[0].split(".")[:3]) if ".blocks." in g[0]
             else g[0].split(".")[0] for g in groups]
    print(f"{tag} gemma3-1b full width, {TRAIN_N} gloo ranks on {dev}, "
          f"overlap=True: {len(groups)} groups (output end first: "
          f"{', '.join(names)}), {buckets} buckets; {DIST_STEPS} + 1 steps; "
          f"spawn to join {total_s:.1f}s")
    fails = []
    for res, base in zip(results, seq["results"]):
        r = res["rank"]
        want = {k: v * DIST_STEPS for k, v in per_step.items()}
        got = {k: res["launches"][k] for k in want}
        same = {"losses": res["losses"] == base["losses"],
                "params": res["digests"]["params"]
                == base["digests"]["params"],
                "state": res["digests"]["state"] == base["digests"]["state"],
                "sent": res["sent"] == base["sent"],
                "flash": res["launches"]["flash"] == base["launches"]["flash"]}
        if not all(same.values()):
            fails.append(f"rank {r} differs from [dist]: {same}")
        if got != want:
            fails.append(f"rank {r} launches {got}, expected {want}")
        ms = statistics.median(sum(s.values()) for s in res["spans"][1:])
        base_ms = statistics.median(sum(s.values())
                                    for s in base["spans"][1:])
        print(f"{tag} rank {r} {card}: {ms:.1f} ms/step overlapped, "
              f"[dist] {base_ms:.1f} in this run (medians of steps "
              f"1-{DIST_STEPS - 1}, CUDA events), x{ms / base_ms:.3f}; "
              f"equal to [dist] bit for bit: {same}; per step: row 3 "
              f"{got['fused_dsgd_many'] // DIST_STEPS} grouped fused "
              f"launches, row 5 {got['gossip_mix_many'] // DIST_STEPS} "
              f"grouped combines ([dist]: "
              f"{base['launches']['fused_dsgd_many'] // DIST_STEPS} and "
              f"{base['launches']['gossip_mix_many'] // DIST_STEPS}); peak "
              f"{res['peak'] / 2**30:.2f} GiB ([dist] "
              f"{base['peak'] / 2**30:.2f}); step {DIST_STEPS} loss "
              f"{res['digests']['extra']['losses'][0]:.4f}")
    if fails:
        raise SystemExit(f"{tag} failed:\n" + "\n".join(fails))
    return results


def _record_all_payloads(ops, digests):
    """Wrap ``ops.quantize_payload_many`` so that every payload it makes
    leaves its digest in ``digests``; returns the function to restore."""
    real = ops.quantize_payload_many

    def recording(xs, errs=None, *, fmt, key, row_offsets):
        out = real(list(xs), errs, fmt=fmt, key=key, row_offsets=row_offsets)
        digests.extend(_payload_digest(q, sc) for q, sc in zip(*out[:2]))
        return out

    ops.quantize_payload_many = recording
    return real


def _kernel_launches() -> dict:
    """The launch counters of the kernels on ``[ckpt]``'s paths."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.fused_dsgd import fused_dsgd_many
    from repro_torch.kernels.gossip_mix import gossip_mix_slots_many
    from repro_torch.kernels.quantized_gossip import (
        quantize_ef_many, quantized_gossip_mix_many)
    return {"flash": flash_attention_fwd.launches,
            "fused_dsgd_many": fused_dsgd_many.launches,
            "gossip_mix_many": gossip_mix_slots_many.launches,
            "quantize_ef_many": quantize_ef_many.launches,
            "quantized_gossip_mix_many": quantized_gossip_mix_many.launches}


def _launched(before: dict) -> dict:
    return {k: v - before[k] for k, v in _kernel_launches().items()}


def _ckpt_rank(rank, device, full, comp, resume):
    """One rank of ``[ckpt]``.  First spawn (``resume=False``): the
    ``[dist]`` cell through ``train_rank`` saving "latest" (``full``),
    its losses, digests, save records and step spans; then reduced
    gemma3-1b with int8 + EF, recording every payload, without saves and
    as ``comp`` saving "latest".  Second spawn: each "latest" loaded into
    fresh templates at this rank's rows, and the steps after it through
    a new bundle."""
    import torch
    from repro_torch import trace
    from repro_torch.checkpoint import load_pytree
    from repro_torch.configs import get_config
    from repro_torch.dist.steps import make_train_step
    from repro_torch.kernels import ops
    from repro_torch.launch.train import rank_batch, train_rank
    from repro_torch.models import model as M
    from repro_torch.sim.engine import node_stack

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank}
    if not resume:
        t0 = time.perf_counter()
        before = _kernel_launches()
        with trace.cuda_marks() as marks:
            res = train_rank(full, device)
            torch.cuda.synchronize()
        out["full"] = {"losses": res.losses, "saves": res.checkpoints,
                       "launches": _launched(before),
                       "wall": time.perf_counter() - t0,
                       "spans": _step_spans(marks),
                       "params": _tree_digest(res.params),
                       "state": _tree_digest(res.state)}
        del res, marks
        gc.collect()
        torch.cuda.empty_cache()
        for name, opts in (("uninterrupted", dataclasses.replace(
                comp, ckpt_dir=None, ckpt_every=0)), ("saved", comp)):
            payloads = []
            real = _record_all_payloads(ops, payloads)
            before = _kernel_launches()
            try:
                res = train_rank(opts, device)
                torch.cuda.synchronize()
            finally:
                ops.quantize_payload_many = real
            out[name] = {"losses": res.losses, "payloads": payloads,
                         "launches": _launched(before),
                         "params": _tree_digest(res.params),
                         "state": _tree_digest(res.state),
                         "ct": res.state["ct"]}
            del res
        return out
    n = TRAIN_N
    for name, opts in (("full", full), ("comp", comp)):
        cfg = get_config(opts.arch)
        dtype = torch.bfloat16
        if opts.reduced:
            cfg, dtype = cfg.reduced(), torch.float32
        bundle = make_train_step(cfg, None, topology=opts.topology, k=opts.k,
                                 method_name=opts.method, eta=opts.eta,
                                 param_dtype=dtype, remat=opts.remat,
                                 compression=opts.compress)
        fresh = node_stack(M.init(cfg, seed=1, dtype=dtype,
                                  device=device).state_dict(), 1, device)
        template = {"params": fresh, "opt": bundle.method.init(fresh),
                    "step": 0}
        del fresh
        t0 = time.perf_counter()
        got = load_pytree(template, opts.ckpt_dir, "latest", rank=rank)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        del template
        params, opt = got["params"], got["opt"]
        ct = opt.get("ct")
        payloads, losses = [], []
        real = _record_all_payloads(ops, payloads)
        before = _kernel_launches()
        try:
            for step in range(got["step"] + 1, opts.steps):
                params, opt, loss = bundle.step_fn(
                    params, opt, rank_batch(cfg, opts, step, n, rank,
                                            device), step)
                losses.append(float(loss))
            torch.cuda.synchronize()
        finally:
            ops.quantize_payload_many = real
        out[name] = {"step": got["step"], "loaded_ct": ct, "load_s": load_s,
                     "launches": _launched(before),
                     "losses": losses, "payloads": payloads,
                     "params": _tree_digest(params),
                     "state": _tree_digest(opt), "ct": opt.get("ct")}
        del got, params, opt, bundle
        gc.collect()
        torch.cuda.empty_cache()
    return out


# [tp-serve]: four gloo ranks as a (data 2, model 2) mesh; gemma3-1b at
# full width with [main]'s prompts and TP_NEW greedy tokens, then grok
# reduced() in f32 (the 2-D rule); (arch, reduced, prompt, new, tolerance
# on the logits relative to max |one-rank logit|)
TP_RANKS, TP_MODEL, TP_NEW, TP_PREFILLS, TP_TIMEOUT = 4, 2, 32, 3, 900.0
TP_CASES = (("gemma3-1b", False, PROMPT, TP_NEW, 2.0 ** -5),
            ("grok-1-314b", True, 64, 8, 1e-4))
# [tp-train], in the same spawns after the serve checks: DSGD-momentum
# 0.9 on Base-2 (k = 1) over the mesh's nodes, TP_TRAIN_STEPS steps at
# eta TP_TRAIN_ETA; per arch (rows per node, tokens per row, remat)
TP_TRAIN_STEPS, TP_TRAIN_ETA = 2, 0.01
TP_TRAIN = {"gemma3-1b": (1, PROMPT, True), "grok-1-314b": (2, 64, False)}
# the tolerances against the one-model-rank trainer: bf16 losses within
# 2^-7 |loss| (one bf16 ulp of it); parameters elementwise within 2^-5
# |p| (four bf16 ulps: two updates and two mixes may each round to the
# neighbour) plus half the tensor's largest move over the run (an
# element near 0 moves by the update alone, whose products differ in
# bf16: the rank's column blocks, finding BC); f32 (reduced) within 1e-4
TP_LOSS_REL, TP_PARAM_REL, TP_PARAM_MOVE, TP_F32_TOL = \
    2.0 ** -7, 2.0 ** -5, 2.0 ** -1, 1e-4


# [tp-spec], in the gemma3-1b spawns after the serve checks: k drafts a
# round through [spec]'s 1-block draft model (seed 2), TP_SPEC_NEW tokens
TP_SPEC_K, TP_SPEC_SEED, TP_SPEC_NEW = 4, 2, 16


@dataclasses.dataclass(frozen=True)
class TPServeCase:
    arch: str
    reduced: bool
    tokens: list            # the whole batch's prompts, B lists of ints
    new: int
    spec: bool = False      # [tp-spec] after the serve checks


def _tp_rank(rank, device, case):
    """One rank of ``[tp-serve]``: the whole model drawn on the CPU, this
    rank's shard moved to the card, its rows served through the engine,
    then prefill and each decode step alone, counted and timed; then
    ``[tp-train]`` from the same shards (:func:`_tp_train`)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import shard_for_rank
    from repro_torch.dist.sharding import (batch_partition_specs,
                                           make_rules,
                                           param_partition_specs)
    from repro_torch.dist.tp import bind, shard_bytes
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.serve import make_engine

    mesh = make_host_mesh(model=TP_MODEL)
    cfg = get_config(case.arch)
    cfg = cfg.reduced() if case.reduced else cfg
    dtype = torch.float32 if case.reduced else torch.bfloat16
    rules = make_rules(mesh, arch_name=cfg.name, context="serve")
    t0 = time.perf_counter()
    full = M.init(cfg, seed=0, dtype=dtype, device="cpu").state_dict()
    # [tp-train]'s one-model-rank trainer runs on the model-coordinate-0
    # ranks (the whole reduced model on every rank): they keep the draw
    keep = case.reduced or mesh.coords["model"] == 0
    shards = shard_for_rank(dict(full) if keep else full,
                            param_partition_specs(full, rules), mesh,
                            mesh.coords)
    model = bind(cfg, {k: v.to(device) for k, v in shards.items()}, mesh)
    if not keep:
        full = None
    del shards
    init_s = time.perf_counter() - t0
    resident = sum(p.numel() * p.element_size() for p in model.parameters())
    tokens = torch.tensor(case.tokens, device=device)
    B, P = tokens.shape
    engine = make_engine(cfg, batch=B, prompt_len=P, max_new=case.new,
                         param_dtype=dtype, cache_dtype=dtype, device=device,
                         mesh=mesh)
    mine = shard_for_rank({"tokens": tokens}, batch_partition_specs(
        {"tokens": tokens}, rules, node_stacked=False), mesh, mesh.coords)
    # no warm-up: the ranks load [build]'s libraries, and the timed
    # prefills below run after this generation
    torch.cuda.reset_peak_memory_stats(device)
    res = engine.generate_with_state(model, mine)
    torch.cuda.synchronize(device)

    def timed(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        flash_attention_fwd.launches = 0
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize(device)
        return out, a.elapsed_time(b), flash_attention_fwd.launches

    pre_ms, pre_launches, dec_ms, dec_launches = [], [], [], []
    with torch.inference_mode():
        for _ in range(TP_PREFILLS):
            (logits, caches, _), ms, n = timed(
                lambda: engine.prefill.fn(model, mine))
            pre_ms.append(ms)
            pre_launches.append(n)
        tok = logits[:, -1].argmax(-1)
        steps, step1, gathers = [tok], None, None
        for i in range(1, case.new):
            before = dict(model.tp.stats)
            (lg, caches), ms, n = timed(lambda: engine.decode.fn(
                model, caches, tok[:, None], P + i - 1))
            dec_ms.append(ms)
            dec_launches.append(n)
            if step1 is None:
                step1 = lg[:, -1].float().cpu().numpy()
                gathers = {k: model.tp.stats[k] - before[k] for k in before}
            tok = lg[:, -1].argmax(-1)
            steps.append(tok)
    out = {"coords": mesh.coords, "row0": engine.row0,
           "rows": engine.rows, "init_s": init_s,
           "tokens": res.tokens.cpu().tolist(),
            "loop_equal": bool(torch.equal(torch.stack(steps, 1),
                                           res.tokens)),
            "prefill": logits[:, -1].float().cpu().numpy(), "step1": step1,
            "prefill_ms": pre_ms, "prefill_launches": pre_launches,
            "decode_ms": dec_ms, "decode_launches": dec_launches,
           "gathers": gathers, "resident": resident,
           "share": shard_bytes(cfg, dtype, mesh),
           "peak": torch.cuda.max_memory_allocated(device)}
    del engine, res, caches, logits, lg, steps
    if case.spec:
        out["spec"] = _tp_spec_rank(device, cfg, dtype, mesh, model, mine,
                                    TP_SPEC_NEW)
    # [tp-train] on the same shards: gemma3-1b's train and serve rules
    # lay the weights out alike (the train rules cut every shard)
    shards = {k: v.detach() for k, v in model.state_dict().items()}
    del model, mine
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = _tp_train(device, cfg, dtype, mesh, shards, full)
    return out


def _spec_draft(cfg, dtype):
    """``[spec]``'s 1-block draft model of ``cfg`` and its weights, drawn
    on the CPU from TP_SPEC_SEED."""
    from repro_torch.models import model as M
    dcfg = dataclasses.replace(cfg, num_blocks=1)
    return dcfg, M.init(dcfg, seed=TP_SPEC_SEED, dtype=dtype, device="cpu")


def _tp_spec_rank(device, cfg, dtype, mesh, model, mine, new):
    """``[tp-spec]`` on this rank: the draft model sharded and bound, one
    speculative generation of its rows (flash launches counted from
    zero, CUDA events around it), then one draft step and one verify
    alone, each with its gathers counted."""
    import torch

    from repro_torch.convert import shard_for_rank
    from repro_torch.dist.sharding import make_rules, param_partition_specs
    from repro_torch.dist.tp import bind
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import model as M
    from repro_torch.serve import make_engine

    dcfg, dfull = _spec_draft(cfg, dtype)
    dfull = dfull.state_dict()
    draft = bind(dcfg, {k: v.to(device) for k, v in shard_for_rank(
        dfull, param_partition_specs(dfull, make_rules(
            mesh, arch_name=dcfg.name, context="serve")), mesh,
        mesh.coords).items()}, mesh)
    del dfull
    P = mine["tokens"].shape[1]
    engine = make_engine(cfg, batch=BATCH, prompt_len=P, max_new=new,
                         param_dtype=dtype, cache_dtype=dtype,
                         speculate_k=TP_SPEC_K, draft_cfg=dcfg,
                         device=device, mesh=mesh)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    flash_attention_fwd.launches = 0
    a.record()
    res = engine.generate_with_state(model, mine, draft_params=draft)
    b.record()
    torch.cuda.synchronize(device)
    launches = flash_attention_fwd.launches
    gen_ms = a.elapsed_time(b)
    alone = {}
    with torch.inference_mode():
        _, caches, _ = engine.prefill.fn(model, mine)
        _, dcaches = M.prefill(dcfg, draft, mine, engine.seq, dtype)
        tok = mine["tokens"][:, -1:]
        for name, comm, fn in (
                ("draft", draft.tp, lambda: M.decode_step(
                    dcfg, draft, dcaches, tok, P)),
                ("verify", model.tp, lambda: engine.decode.fn(
                    model, caches, tok.repeat(1, TP_SPEC_K + 1), P))):
            before = dict(comm.stats)
            fn()
            torch.cuda.synchronize(device)
            alone[name] = {k: comm.stats[k] - before[k] for k in before}
    out = {"tokens": res.tokens.cpu().tolist(),
           "stats": [t.cpu().tolist() for t in res.spec],
           "launches": launches, "gen_ms": gen_ms,
           "iterations": int(res.spec.rounds.max()),
           "layers": (cfg.num_layers, dcfg.num_layers), "alone": alone}
    del engine, res, caches, dcaches, draft
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _check_tp_spec(torch, tag, ranks, want, stats, margins, atol):
    """``[tp-spec]``'s checks (module docstring) and lines; returns the
    ranks' flash launches in their generations."""
    fails = []
    for r in ranks:
        sp, c = r["spec"], r["coords"]
        rows = slice(r["row0"], r["row0"] + r["rows"])
        L, Ld = sp["layers"]
        per_round = (TP_SPEC_K + 1) * Ld + L
        expect = L + Ld + sp["iterations"] * per_round
        if sp["launches"] != expect:
            fails.append(f"rank {c}: {sp['launches']} flash launches, "
                         f"expected {L} + {Ld} + {sp['iterations']} x "
                         f"{per_round} = {expect}")
        got = torch.tensor(sp["tokens"])
        same = torch.equal(got, want[rows])
        for b in range(r["rows"]):
            diff = (got[b] != want[rows][b]).nonzero()
            if not len(diff):
                continue
            t = int(diff[0])
            margin = float(margins[rows][b, t])
            if margin > 2 * atol:
                fails.append(f"rank {c} row {r['row0'] + b}: tokens part "
                             f"from the one-rank's at step {t}, top-2 "
                             f"margin {margin:.4g} > 2 x {atol:.4g}")
            print(f"{tag} rank {c} row {r['row0'] + b} parts from the "
                  f"one-rank tokens at step {t}: a near-tie (margin "
                  f"{margin:.4g} <= {2 * atol:.4g}); its SpecStats are not "
                  f"compared")
        if same and [s[rows].tolist() for s in stats] != sp["stats"]:
            fails.append(f"rank {c}: SpecStats {sp['stats']} differ from "
                         f"the one-rank engine's "
                         f"{[s[rows].tolist() for s in stats]}")
        al = sp["alone"]
        print(f"{tag} rank {c} rows {r['row0']}...{r['row0'] + r['rows'] - 1}"
              f": {sp['iterations']} rounds, {sp['gen_ms']:.1f} ms for the "
              f"generation ({sp['gen_ms'] / max(sp['iterations'], 1):.1f} "
              f"ms a round, CUDA events, both prefills included); flash "
              f"{sp['launches']} = {L} + {Ld} + {sp['iterations']} x "
              f"{per_round}; rounds/drafted/accepted per row "
              f"{sp['stats']}; gathers per draft step "
              f"{al['draft']['collectives']} ({al['draft']['bytes']} "
              f"bytes), per verify of {TP_SPEC_K + 1} rows "
              f"{al['verify']['collectives']} ({al['verify']['bytes']} "
              f"bytes); tokens {'equal' if same else 'differ from'} the "
              f"one-rank engine's")
    if fails:
        raise SystemExit(f"{tag} failed:\n" + "\n".join(fails))
    return [r["spec"]["launches"] for r in ranks]


def _tp_train(device, cfg, dtype, mesh, shards, full):
    """``[tp-train]`` on this rank of ``mesh``: the tensor-parallel
    trainer (``dist.steps.make_train_step(mesh=)``) from this rank's
    ``shards`` of the seed-0 draw, TP_TRAIN_STEPS steps of its node's
    rows of ``token_batches``, each counted (the kernels' launch
    counters, the gathers forward and backward, the gossip bytes, the
    trace marks' spans) with the replicated tensors' digest after it.
    Then the node's shards meet on its model-coordinate-0 rank
    (``convert.unshard_ranks``, which raises if the replicated tensors
    differ), and that rank runs the one-model-rank trainer
    (``make_train_step(cfg, mesh.group("data"))``) from ``full`` on the
    same batches; a one-node mesh (the 2-D rule) holds step 0's
    gradients against ``models.model.loss_fn`` on ``full`` and the steps
    against the method's update with no mixing, on every rank."""
    import hashlib

    import torch
    from repro_torch import trace
    from repro_torch.convert import shard_for_rank, unshard_ranks
    from repro_torch.data.synthetic import token_batches
    from repro_torch.dist.sharding import param_partition_specs
    from repro_torch.dist.steps import make_train_step
    from repro_torch.dist.tp import Collectives
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as M
    from repro_torch.sim.engine import node_stack

    rows, seq, remat = TP_TRAIN[cfg.name]
    kw = dict(topology="base", k=1, method_name="dsgdm", eta=TP_TRAIN_ETA,
              param_dtype=dtype, remat=remat, momentum=0.9)
    bundle = make_train_step(cfg, mesh=mesh, **kw)
    n, node = bundle.n_nodes, bundle.node

    def batch(step):
        raw = token_batches(step, batch=n * rows, seq=seq,
                            vocab=cfg.vocab_size)
        return {k: torch.from_numpy(v.reshape(n, rows, seq)[node:node + 1])
                .to(device) for k, v in raw.items()}

    specs = param_partition_specs(shards, bundle.rules)
    replicated = sorted(k for k, sp in specs.items()
                        if all(a is None for a in sp))
    params = node_stack(shards, 1, device)
    del shards
    param_bytes = sum(v.numel() * v.element_size() for v in params.values())
    opt = bundle.method.init(params)
    out = {"node": node, "n_nodes": n, "param_bytes": param_bytes,
           "steps": []}
    if n == 1:      # the step's gradients against the whole model's
        loss, grads = bundle.grad_fn(params, batch(0))
        p = {k: v.to(device).requires_grad_() for k, v in full.items()}
        whole = {k: v.detach()[None] for k, v in full.items()}
        b0 = {k: v[0] for k, v in batch(0).items()}
        want = M.loss_fn(cfg, p, b0, remat=remat)[0]
        wgrads = dict(zip(p, torch.autograd.grad(want, list(p.values()))))
        want = want.detach()
        mine = shard_for_rank(dict(wgrads), specs, mesh, mesh.coords)
        out["grads_err"] = max(float((grads[k][0] - g).abs().max())
                               for k, g in mine.items())
        out["loss_err"] = abs(float(loss) - float(want))
        del p, grads, mine
    comm = bundle.model.tp
    counters = _kernel_launches
    for step in range(TP_TRAIN_STEPS):
        before = counters()
        stats, bwd = dict(comm.stats), dict(comm.backward_stats)
        sent = dict(bundle.mixer.stats)
        torch.cuda.reset_peak_memory_stats(device)
        b = batch(step)
        with trace.cuda_marks() as marks:
            params, opt, loss = bundle.step_fn(params, opt, b, step)
            torch.cuda.synchronize(device)
        spans = _step_spans(marks)[0]
        del marks
        h = hashlib.sha256()
        for k in replicated:
            h.update(params[k].reshape(-1).view(torch.uint8).cpu().numpy())
        out["steps"].append({
            "loss": float(loss), "spans": spans,
            "launches": _launched(before),
            "gathers": comm.stats["collectives"] - stats["collectives"],
            "gather_bytes": comm.stats["bytes"] - stats["bytes"],
            "bwd_gathers": comm.backward_stats["collectives"]
            - bwd["collectives"],
            "bwd_bytes": comm.backward_stats["bytes"] - bwd["bytes"],
            "sent": bundle.mixer.stats["bytes"] - sent["bytes"],
            "peak": torch.cuda.max_memory_allocated(device),
            "replicated": h.hexdigest()})
    final = {k: v[0] for k, v in params.items()}
    del opt, params, bundle
    gc.collect()
    torch.cuda.empty_cache()
    if n == 1:      # the method's update with no mixing, on full
        from repro_torch.optim.decentralized import make_method
        method = make_method("dsgdm", 0.9)
        p1 = {k: v.to(device) for k, v in whole.items()}
        o1 = method.init(p1)
        for step in range(TP_TRAIN_STEPS):
            g = {}
            pp = {k: v[0].detach().requires_grad_() for k, v in p1.items()}
            lo = M.loss_fn(cfg, pp, {k: v[0] for k, v in
                                     batch(step).items()}, remat=remat)[0]
            for k, gk in zip(pp, torch.autograd.grad(lo, list(pp.values()))):
                g[k] = gk[None]
            with torch.no_grad():
                p1, o1 = method.step(p1, g, o1, lambda t: t, TP_TRAIN_ETA)
        mine = shard_for_rank({k: v[0] for k, v in p1.items()}, specs, mesh,
                              mesh.coords)
        out["params_err"] = max(float((final[k] - v).abs().max())
                                for k, v in mine.items())
        return out
    # the node's shards meet on its model-coordinate-0 rank
    gather = Collectives(mesh)
    pieces = {k: [t.cpu() for t in gather.gather(v, "model")]
              for k, v in final.items()}
    del final
    if mesh.coords["model"]:
        return out
    node_mesh = Mesh({"data": 1, "model": mesh.shape["model"]})
    try:
        got = unshard_ranks([{k: v[i] for k, v in pieces.items()}
                             for i in range(mesh.shape["model"])], specs,
                            node_mesh)
        out["unshard"] = "ok"
    except ValueError as e:
        out["unshard"] = str(e)
        return out
    del pieces
    one = make_train_step(cfg, mesh.group("data"), **kw)
    p1 = node_stack(full, 1, device)
    move = {k: v.float() for k, v in p1.items()}
    o1 = one.method.init(p1)
    losses = []
    t0 = time.perf_counter()
    for step in range(TP_TRAIN_STEPS):
        p1, o1, lo = one.step_fn(p1, o1, batch(step), step)
        losses.append(float(lo))
    torch.cuda.synchronize(device)
    out["one_s"] = time.perf_counter() - t0
    out["one_losses"] = losses
    worst = {"violations": 0, "differing": 0, "elements": 0,
             "max_abs": 0.0, "max_ratio": 0.0}
    for k, want in p1.items():
        w = want[0].float()
        floor = TP_PARAM_MOVE * float((w - move[k][0]).abs().max())
        diff = (got[k].to(device).float() - w).abs()
        tol = TP_PARAM_REL * w.abs() + floor
        worst["elements"] += diff.numel()
        worst["differing"] += int((diff > 0).sum())
        worst["violations"] += int((diff > tol).sum())
        worst["max_abs"] = max(worst["max_abs"], float(diff.max()))
        pos = tol > 0
        if bool(pos.any()):
            worst["max_ratio"] = max(worst["max_ratio"], float(
                (diff[pos] / tol[pos]).max()))
    out["params_check"] = worst
    return out


def _one_rank_reference(torch, dev, cfg, dtype, tokens, new, spec=False):
    """The one-rank engine on the ranks' weights (drawn on the CPU from
    seed 0): its tokens, the prefill and first decode step's logits (f32
    copies of them), each step's top-2 logit margin (B, new), and with
    ``spec`` the tokens and ``SpecStats`` of the engine with
    ``[tp-spec]``'s draft (else None)."""
    from repro_torch.models import model as M
    from repro_torch.serve import make_engine

    params = M.init(cfg, seed=0, dtype=dtype, device="cpu").to(dev)
    B, P = tokens.shape
    engine = make_engine(cfg, batch=B, prompt_len=P, max_new=new,
                         param_dtype=dtype, cache_dtype=dtype, device=dev)
    want = engine.generate_with_state(params, {"tokens": tokens}).tokens
    with_draft = None
    if spec:
        dcfg, dparams = _spec_draft(cfg, dtype)
        res = make_engine(
            cfg, batch=B, prompt_len=P, max_new=TP_SPEC_NEW,
            param_dtype=dtype, cache_dtype=dtype, speculate_k=TP_SPEC_K,
            draft_cfg=dcfg,
            device=dev).generate_with_state(
                params, {"tokens": tokens}, draft_params=dparams.to(dev))
        with_draft = (res.tokens.cpu(), [t.cpu() for t in res.spec])
        del dparams, res
    margins = []

    def pick(lg):
        top = lg[:, -1].float().topk(2, dim=-1).values
        margins.append(top[:, 0] - top[:, 1])
        return lg[:, -1].argmax(-1)

    with torch.inference_mode():
        lg, caches = M.prefill(cfg, params, {"tokens": tokens}, engine.seq,
                               dtype)
        prefill = lg[:, -1].float()
        steps = [pick(lg)]
        for i in range(1, new):
            lg, caches = M.decode_step(cfg, params, caches,
                                       steps[-1][:, None], P + i - 1)
            if i == 1:
                step1 = lg[:, -1].float()
            steps.append(pick(lg))
    if not torch.equal(torch.stack(steps, 1), want):
        raise SystemExit("[tp-serve] the one-rank steps alone differ from "
                         "its engine's tokens")
    out = (want.cpu(), prefill.cpu(), step1.cpu(),
           torch.stack(margins, 1).cpu(), with_draft)
    del params, caches, engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_tp_serve(torch, dev, card):
    """``[tp-serve]`` and, in the same spawns, ``[tp-train]`` and
    ``[tp-spec]`` (module docstring): returns the gemma3-1b serving
    launches over the four ranks by phase, row 1's entries at a rank's
    shapes, and what the gemma3-1b ranks counted (per rank: its
    coordinates, gathers and bytes per decode step, parameter bytes, and
    its last train step's record) for ``[dryrun]``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch.distributed import spawn_local

    launches, counted = {}, None
    for arch, reduced, prompt, new, tol in TP_CASES:
        tag = f"[tp-serve] {arch}{' reduced' if reduced else ''}"
        cfg = get_config(arch)
        cfg = cfg.reduced() if reduced else cfg
        dtype = torch.float32 if reduced else torch.bfloat16
        gen = torch.Generator(device=dev).manual_seed(1)   # [main]'s
        tokens = torch.randint(0, cfg.vocab_size, (BATCH, prompt),
                               generator=gen, device=dev)
        t0 = time.perf_counter()
        spec = not reduced
        want, pre, step1, margins, with_draft = _one_rank_reference(
            torch, dev, cfg, dtype, tokens, new, spec)
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn_local(_tp_rank, TP_RANKS, args=(TPServeCase(
            arch, reduced, tokens.cpu().tolist(), new, spec),),
            backend="gloo", device="cuda", timeout=TP_TIMEOUT)
        spawn_s = time.perf_counter() - t0
        L = attention_layers(cfg)
        scale = float(pre.abs().max())
        atol = tol * scale
        print(f"{tag} {card}: one-rank reference {one_s:.1f} s; 4 ranks "
              f"{spawn_s:.1f} s (spawn, CPU draw and shard, the runs)")
        for r in ranks:
            rows = slice(r["row0"], r["row0"] + r["rows"])
            errs = [float((torch.from_numpy(r[k]) - ref[rows]).abs().max())
                    for k, ref in (("prefill", pre), ("step1", step1))]
            want_launch = [L] * TP_PREFILLS, [L] * (new - 1)
            if (r["prefill_launches"], r["decode_launches"]) != want_launch:
                raise SystemExit(
                    f"{tag} rank {r['coords']}: flash launches per prefill "
                    f"{r['prefill_launches']}, per decode step "
                    f"{r['decode_launches']}; expected {L} each")
            if r["resident"] != r["share"]:
                raise SystemExit(f"{tag} rank {r['coords']}: {r['resident']} "
                                 f"parameter bytes, the table's share is "
                                 f"{r['share']}")
            if max(errs) > atol or not r["loop_equal"]:
                raise SystemExit(
                    f"{tag} rank {r['coords']}: logits off the one-rank's by "
                    f"{errs} (tolerance {atol:.4g}), or the steps alone "
                    f"gave other tokens than its engine "
                    f"({r['loop_equal']})")
            got = torch.tensor(r["tokens"])
            for b in range(r["rows"]):
                diff = (got[b] != want[rows][b]).nonzero()
                if not len(diff):
                    continue
                t = int(diff[0])
                margin = float(margins[rows][b, t])
                if margin > 2 * atol:
                    raise SystemExit(
                        f"{tag} rank {r['coords']} row {r['row0'] + b}: "
                        f"tokens part from the one-rank's at step {t}, "
                        f"where its top-2 margin {margin:.4g} exceeds "
                        f"2 x {atol:.4g}")
                print(f"{tag} rank {r['coords']} row {r['row0'] + b} parts "
                      f"from the one-rank tokens at step {t}: a near-tie "
                      f"(one-rank top-2 margin {margin:.4g} <= "
                      f"{2 * atol:.4g})")
            g = r["gathers"]
            print(f"{tag} rank {r['coords']} rows {r['row0']}..."
                  f"{r['row0'] + r['rows'] - 1}: prefill "
                  f"{statistics.median(r['prefill_ms']):.2f} ms, decode "
                  f"{statistics.median(r['decode_ms']):.3f} ms/step "
                  f"(CUDA-event medians); {g['collectives']} gathers and "
                  f"{g['bytes']} bytes received per decode step; peak "
                  f"{r['peak'] / 2**30:.2f} GiB; parameters "
                  f"{r['resident'] / 2**30:.3f} GiB (the table's share); "
                  f"CPU draw + shard {r['init_s']:.1f} s; logits err "
                  f"prefill {errs[0]:.3g}, step 1 {errs[1]:.3g} (tol "
                  f"{atol:.3g}); flash {L} per prefill and per step")
        same = sum(torch.equal(torch.tensor(r["tokens"]),
                               want[r["row0"]:r["row0"] + r["rows"]])
                   for r in ranks)
        print(f"{tag}: tokens equal the one-rank engine's on {same} of "
              f"{len(ranks)} ranks")
        _check_tp_train(f"[tp-train] {arch}{' reduced' if reduced else ''}",
                        [r["train"] for r in ranks],
                        [r["coords"] for r in ranks], card)
        if spec:
            swant, sstats = with_draft
            same = "the same" if torch.equal(
                swant, want[:, :TP_SPEC_NEW]) else "other"
            print(f"[tp-spec] {arch} {card}: the one-rank engine with the "
                  f"draft gives {same} tokens as the plain one-rank engine;"
                  f" rounds/drafted/accepted per row "
                  f"{[t.tolist() for t in sstats]}")
            launches["tp-spec"] = _check_tp_spec(
                torch, f"[tp-spec] {arch}", ranks, swant, sstats, margins,
                atol)
            counted = [{"coords": r["coords"], "decode": r["gathers"],
                        "share": r["share"], "train": r["train"]}
                       for r in ranks]
        if reduced:
            if same != len(ranks):
                raise SystemExit(f"{tag}: f32 tokens differ from the "
                                 f"one-rank engine's")
        else:
            launches["tp-serve-prefill"] = sum(r["prefill_launches"][0]
                                               for r in ranks)
            launches["tp-serve-decode"] = sum(sum(r["decode_launches"])
                                              for r in ranks)
    # row 1 at a rank's shapes: its 2 rows, prefill and decode
    gen = torch.Generator(device=dev).manual_seed(26)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows, seq = BATCH // 2, PROMPT + TP_NEW
    entries = []
    for layer, window in (("local", LOCAL_WINDOW), ("global", None)):
        for name, phase, Tq, q0, k_valid in (
                (f"tp-serve prefill,{layer}", "tp-serve-prefill", PROMPT, 0,
                 PROMPT),
                (f"tp-serve decode@{PROMPT},{layer}", "tp-serve-decode", 1,
                 PROMPT, PROMPT + 1)):
            entries.append(flash_case(
                torch, dev, gen, flush, name=name, phase=phase, B=rows,
                Tq=Tq, S=seq, H=HEADS, KV=KV_HEADS, D=HEAD_DIM, q0=q0,
                k_valid=k_valid, window=window, softcap=None))
    del flush
    flash_attention_fwd.launches = 0
    return launches, entries, counted


DRYRUN_OUT = ROOT / "build" / "chip_smoke_dryrun"


def start_dry_sweep():
    """Start ``[dryrun]``'s production sweep (module docstring): a
    subprocess that sees no card, at the lowest CPU priority, so that it
    takes the cycles the phases beside it leave; :func:`phase_tools`
    waits for it and checks its cells."""
    if DRYRUN_OUT.exists():
        for f in DRYRUN_OUT.iterdir():
            f.unlink()
    return _start({"[dryrun] sweep": (
        ["nice", "-n", "19", sys.executable, "-m",
         "repro_torch.launch.dryrun", "--all", "--mesh", "single",
         "--jobs", "6", "--out", str(DRYRUN_OUT)],
        dict(os.environ, PYTHONPATH=str(ROOT / "src"),
             CUDA_VISIBLE_DEVICES=""))})


def phase_tools(card, counted, dry, meanwhile=None):
    """``[dryrun]``, ``[smoke-mp]`` and ``[examples]`` (module docstring)
    side by side: the four card subprocesses start beside ``dry`` (the
    production sweep's, from :func:`start_dry_sweep`), the four ranks'
    dry cells (against what the ranks counted, ``counted`` from
    :func:`phase_tp_serve`) and then ``meanwhile`` run here; each
    subprocess is waited for and checked."""
    src = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def here():
        _dry_rank_cells(card, counted)
        if meanwhile is not None:
            meanwhile()

    _run_side_by_side(card, {
        "[smoke-mp]": (["scripts/launch_multiprocess_torch.sh", "-p", "2"],
                       src),
        "[examples] quickstart_torch.py": (
            [sys.executable, "examples/quickstart_torch.py", "--steps",
             "60"], src),
        "[examples] serve_batched_torch.py": (
            [sys.executable, "examples/serve_batched_torch.py"], src),
        "[examples] train_decentralized_torch.py": (
            [sys.executable, "examples/train_decentralized_torch.py",
             "--preset", "tiny", "--steps", "20"], src)},
        here, started=dry)
    _check_sweep(DRYRUN_OUT)


def _start(runs):
    """Start every ``runs[tag] = (cmd, env)`` subprocess from the
    checkout's root, each in a process group of its own, its output to a
    file (nothing reads a pipe while they run); returns ``{tag: (process,
    file, start time)}``.  Each group is killed when this process exits,
    if it is still running then."""
    started = {}
    for tag, (cmd, env) in runs.items():
        log = tempfile.TemporaryFile("w+")
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        atexit.register(_kill_group, proc)
        started[tag] = (proc, log, time.perf_counter())
    return started


def _kill_group(proc) -> None:
    """Kill ``proc``'s process group (its children too) unless it has
    ended, and reap it."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def _run_side_by_side(card, runs, meanwhile=None, timeout=600.0,
                      started=None):
    """Start every ``runs[tag] = (cmd, env)`` subprocess (:func:`_start`)
    beside those already ``started``, call ``meanwhile``, wait for each
    (its seconds from its own start taken when it exits), and raise
    unless each exited 0; prints the tail of each one's output."""
    t0 = time.perf_counter()
    procs = dict(started or {})
    procs.update(_start(runs))
    ended = {}

    def watch(tag, p, t):
        p.wait()
        ended[tag] = time.perf_counter() - t

    for tag, (p, _, t) in procs.items():    # exit times while meanwhile runs
        threading.Thread(target=watch, args=(tag, p, t), daemon=True).start()
    try:
        if meanwhile is not None:
            meanwhile()
        while len(ended) < len(procs):
            if time.perf_counter() - t0 > timeout:
                raise SystemExit(f"{sorted(set(procs) - set(ended))} still "
                                 f"running after {timeout} s")
            time.sleep(0.2)
        done = {}
        for tag, (p, log, _) in procs.items():
            log.seek(0)
            done[tag] = (p.returncode, log.read())
    finally:
        for p, log, _ in procs.values():
            _kill_group(p)
            log.close()
    for tag, (rc, o) in done.items():
        lines = [ln for ln in o.splitlines() if ln.strip()]
        if rc:
            raise SystemExit(f"{tag} exited {rc}:\n" + "\n".join(lines[-40:]))
        if tag == "[smoke-mp]":
            ok = sorted(ln for ln in lines if ln.startswith("SMOKE_OK"))
            if len(ok) != 2 or not all("device=cuda" in ln
                                       and "global_sum=2" in ln
                                       for ln in ok):
                raise SystemExit(f"[smoke-mp] expected two SMOKE_OK lines "
                                 f"on the card, got {ok}")
            lines = ok + lines[-1:]
        elif tag.startswith("[examples]"):
            lines = lines[-3:]
        else:
            lines = []
        for ln in lines:
            print(f"{tag} {ln}")
        print(f"{tag} {card}: exit 0 after {ended[tag]:.1f} s")


def _check_sweep(out: Path) -> None:
    """Every cell of the production sweep under ``out`` ``ok`` or
    ``skipped``; each printed."""
    statuses = {}
    for f in sorted(out.glob("*.json")):
        res = json.loads(f.read_text())
        statuses[f.stem] = res["status"]
        print(f"[dryrun] {f.stem}: {res['status']}"
              + (f", {res['memory']['total']} bytes a rank (fits "
                 f"{res['fits']}), {res['flops_per_rank']:.4g} FLOPs a "
                 f"rank, {res['gathers']} gathers, {res['run_s']} s"
                 if res["status"] == "ok" else ""))
    bad = [k for k, v in statuses.items() if v not in ("ok", "skipped")]
    if len(statuses) != 40 or bad:
        raise SystemExit(f"[dryrun] the sweep has {len(statuses)} cells of "
                         f"40; not ok: {bad}")
    print(f"[dryrun] the sweep: {sum(v == 'ok' for v in statuses.values())}"
          f" ok, {sum(v == 'skipped' for v in statuses.values())} skipped")


def _dry_rank_cells(card, counted):
    """The dry cells of gemma3-1b on each of the four ranks' coordinates
    against what the ranks counted (:func:`phase_tools`)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import dry_cell
    from repro_torch.launch.mesh import Mesh, dry_mesh

    cfg = get_config("gemma3-1b")
    mesh = Mesh({"data": TP_RANKS // TP_MODEL, "model": TP_MODEL})
    rows, seq, remat = TP_TRAIN["gemma3-1b"]
    fails = []
    t0 = time.perf_counter()
    for rank, r in enumerate(counted):
        m = dry_mesh(mesh, rank)
        dec = dry_cell(cfg, "decode", m, batch=BATCH, seq=PROMPT + TP_NEW)
        tr = dry_cell(cfg, "train", m, batch=rows * mesh.shape["data"],
                      seq=seq, remat=remat)
        live = r["train"]["steps"][-1]
        got = {"coords": m.coords,
               "decode": {"collectives": dec["gathers"],
                          "bytes": dec["gather_bytes"]},
               "share": dec["memory"]["params"],
               "train": (tr["gathers"], tr["gather_bytes"],
                         tr["bwd_gathers"], tr["bwd_bytes"],
                         tr["gossip_bytes"], tr["memory"]["params"])}
        want = {"coords": r["coords"], "decode": r["decode"],
                "share": r["share"],
                "train": (live["gathers"], live["gather_bytes"],
                          live["bwd_gathers"], live["bwd_bytes"],
                          live["sent"], r["train"]["param_bytes"])}
        print(f"[dryrun] gemma3-1b rank {m.coords} (meta device): decode "
              f"step {dec['gathers']} gathers / {dec['gather_bytes']} "
              f"bytes, parameters {dec['memory']['params']} bytes; train "
              f"step {tr['gathers']} gathers / {tr['gather_bytes']} bytes "
              f"({tr['gathers'] - tr['bwd_gathers']} forward of "
              f"{tr['gather_bytes'] - tr['bwd_bytes']}, {tr['bwd_gathers']}"
              f" backward of {tr['bwd_bytes']}), gossip "
              f"{tr['gossip_bytes']} bytes, {tr['flops_per_rank']:.4g} "
              f"FLOPs a rank (compute {tr['compute_s'] * 1e3:.3f} ms at "
              f"989 TFLOP/s); measured on {card}: decode {r['decode']}, "
              f"train {want['train']}")
        if got != want:
            fails.append(f"rank {m.coords}: dry {got} != measured {want}")
    print(f"[dryrun] the four ranks' cells {time.perf_counter() - t0:.1f} "
          f"s")
    if fails:
        raise SystemExit("[dryrun] failed:\n" + "\n".join(fails))


def _check_tp_train(tag, results, coords, card):
    """``[tp-train]``'s checks over the ranks' results (``_tp_train``):
    the launch counters of rows 1 and 3 (and 5, where there is gossip)
    above 0 on every rank at every step; a node's losses and replicated
    tensors equal across its model ranks at every step; the node's
    parameters put back together within the tolerances of the
    one-model-rank trainer's (or, on one node, the gradients and the
    parameters within TP_F32_TOL of the whole model's)."""
    fails = []
    kernels = ("flash", "fused_dsgd_many", "gossip_mix_many")
    for r, c in zip(results, coords):
        peers = [q for q, d in zip(results, coords)
                 if d.get("data") == c.get("data")]
        for i, st in enumerate(r["steps"]):
            need = kernels if r["n_nodes"] > 1 else kernels[:2]
            if not all(st["launches"][k] > 0 for k in need):
                fails.append(f"rank {c} step {i}: launches "
                             f"{st['launches']}")
            if any(q["steps"][i]["loss"] != st["loss"]
                   or q["steps"][i]["replicated"] != st["replicated"]
                   for q in peers):
                fails.append(f"rank {c} step {i}: its node's ranks differ "
                             f"in the loss or the replicated tensors")
            sp = st["spans"]
            mix = sp.get("exchange", 0.0) + sp.get("combine", 0.0)
            print(f"{tag} {card} rank {c} step {i}: loss {st['loss']:.6f}; "
                  f"{sum(sp.values()):.1f} ms (fwd+bwd "
                  f"{sp.get('step', 0.0):.1f}, update "
                  f"{sp.get('update', 0.0):.1f}, mix {mix:.1f}; CUDA "
                  f"events); launches flash {st['launches']['flash']}, "
                  f"fused_dsgd_many {st['launches']['fused_dsgd_many']}, "
                  f"gossip_mix_many {st['launches']['gossip_mix_many']}; "
                  f"gathers {st['gathers']} receiving {st['gather_bytes']} "
                  f"bytes, of them in the backward {st['bwd_gathers']} / "
                  f"{st['bwd_bytes']}; gossip sent {st['sent']} bytes; "
                  f"peak {st['peak'] / 2**30:.2f} GiB; parameters "
                  f"{r['param_bytes'] / 2**30:.3f} GiB")
        if r["n_nodes"] == 1:
            print(f"{tag} rank {c}: step-0 loss off the whole model's by "
                  f"{r['loss_err']:.3g}, gradients by {r['grads_err']:.3g}; "
                  f"parameters after {TP_TRAIN_STEPS} steps off the "
                  f"unmixed update's by {r['params_err']:.3g} (tolerance "
                  f"{TP_F32_TOL})")
            if max(r["loss_err"], r["grads_err"], r["params_err"]) \
                    > TP_F32_TOL:
                fails.append(f"rank {c}: off the whole model's")
            continue
        if "unshard" not in r:
            continue
        if r["unshard"] != "ok":
            fails.append(f"rank {c}: the node's shards do not go back "
                         f"together: {r['unshard']}")
            continue
        losses = [st["loss"] for st in r["steps"]]
        off = [abs(a - b) for a, b in zip(losses, r["one_losses"])]
        ok = all(d <= TP_LOSS_REL * abs(b)
                 for d, b in zip(off, r["one_losses"]))
        w = r["params_check"]
        print(f"{tag} node {r['node']}: losses {losses} against the "
              f"one-model-rank trainer's {r['one_losses']} ({r['one_s']:.1f}"
              f" s for its {TP_TRAIN_STEPS} steps; off by {off}, tolerance "
              f"{TP_LOSS_REL} relative); parameters after step "
              f"{TP_TRAIN_STEPS}: {w['differing']} of {w['elements']} "
              f"differ, max abs {w['max_abs']:.4g}, worst "
              f"{w['max_ratio']:.3f} of the tolerance, "
              f"{w['violations']} over it")
        if not ok or w["violations"]:
            fails.append(f"node {r['node']}: off the one-model-rank "
                         f"trainer's")
    if fails:
        raise SystemExit(f"{tag} failed:\n" + "\n".join(fails))


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.iterdir() if f.is_file())


def phase_ckpt(torch, dev, card, seq, overlapped):
    """``[ckpt]``: async checkpoints of the ``[dist]`` cell and a resume
    by a second spawn of ranks, bit for bit (see the module's docstring);
    ``seq`` is ``[dist]``'s run, ``overlapped`` ``[dist-overlap]``'s
    ranks, whose extra step the saving run's fourth must equal."""
    import shutil

    from repro_torch.compress import CompressionConfig
    from repro_torch.compress import reference_leaves
    from repro_torch.launch.distributed import spawn_local

    tag = "[ckpt]"
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(CKPT_DIR).free
    if free < CKPT_DISK:
        raise SystemExit(f"{tag} failed: the disk under {CKPT_DIR} has "
                         f"{free / 2**30:.1f} GiB free; the phase writes up "
                         f"to {CKPT_DISK / 2**30:.0f} GiB")
    full = dataclasses.replace(seq["opts"], steps=CKPT_STEPS,
                               ckpt_dir=str(CKPT_DIR / "full"),
                               ckpt_every=CKPT_EVERY)
    comp = dataclasses.replace(
        seq["opts"], reduced=True, remat=False, steps=CKPT_C_STEPS,
        seq=64, compress=CompressionConfig(
            codec=COMPRESS_CODEC, chunk=CHUNK, error_feedback=True,
            seed=0).to_json(),
        ckpt_dir=str(CKPT_DIR / "comp"), ckpt_every=CKPT_EVERY)
    # the reference's schedule: a save after step s when s % every == 0
    saved_at = [s for s in range(1, CKPT_STEPS) if s % CKPT_EVERY == 0]
    assert saved_at[-1] < CKPT_STEPS - 1 and (CKPT_C_STEPS - 2) \
        % CKPT_EVERY == 0, "a step must run beside the last save"
    fails = []
    try:
        t0 = time.perf_counter()
        first = spawn_local(_ckpt_rank, TRAIN_N, backend="gloo", device=dev,
                            timeout=DIST_TIMEOUT, args=(full, comp, False))
        first_s = time.perf_counter() - t0
        latest = CKPT_DIR / "full" / "latest"
        mean_dir = CKPT_DIR / "full" / "ckpt"
        manifests = sorted(p.name for p in latest.glob("manifest-p*.json"))
        with open(latest / "manifest.json") as f:
            leaves = json.load(f)["leaves"]
        shapes = seq["shapes"]
        want_leaves = 2 * len(reference_leaves(list(shapes))) + 1
        blocks = len({k.split(".")[2] for k in shapes
                      if k.startswith("stack.blocks.")})
        wq = leaves["params/stack/blocks/0/attn/wq/w"]
        shapes_ok = (
            leaves["params/embed/table"]["shape"]
            == [TRAIN_N, *shapes["embed.table"]]
            and wq["shape"] == [TRAIN_N, blocks,
                                *shapes["stack.blocks.0.0.attn.wq.w"]]
            and leaves["opt/u/final_norm/scale"]["shape"]
            == [TRAIN_N, *shapes["final_norm.scale"]]
            and leaves["step"]["shape"] == []
            and wq["shards"][0]["stored_dtype"] == (
                None if full.reduced else "bfloat16"))
        print(f"{tag} latest: {manifests}, {len(leaves)} leaves "
              f"(the reference's keys: params/..., opt/u/..., step; "
              f"{want_leaves} expected), shapes as the reference's: "
              f"{shapes_ok}; the node-mean ckpt {_dir_bytes(mean_dir)} bytes")
        if manifests != [f"manifest-p{r}.json" for r in range(TRAIN_N)] \
                or len(leaves) != want_leaves or not shapes_ok:
            fails.append("latest's manifests, keys or shapes are not the "
                         "reference's")
        t0 = time.perf_counter()
        second = spawn_local(_ckpt_rank, TRAIN_N, backend="gloo", device=dev,
                             timeout=DIST_TIMEOUT, args=(full, comp, True))
        second_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    print(f"{tag} gemma3-1b full width, {TRAIN_N} gloo ranks on {dev}, "
          f"ckpt_every={CKPT_EVERY} over {CKPT_STEPS} steps: spawn to join "
          f"{first_s:.1f}s; the resume (a second spawn, one step) "
          f"{second_s:.1f}s")
    for a, b, base, ovl in zip(first, second, seq["results"], overlapped):
        r = a["rank"]
        fa, fb = a["full"], b["full"]
        extra = ovl["digests"]["extra"]
        same_run = {
            "losses 0-2 as [dist]'s":
                fa["losses"][:DIST_STEPS] == base["losses"],
            "loss 3 as [dist-overlap]'s":
                fa["losses"][DIST_STEPS:DIST_STEPS + 1] == extra["losses"]}
        same_resume = {"step": fb["step"] == saved_at[-1],
                       "loss": fb["losses"] == fa["losses"][-1:],
                       "params": fb["params"] == fa["params"],
                       "state": fb["state"] == fa["state"]}
        if not all(same_run.values()):
            fails.append(f"rank {r}: the saving run differs from [dist]: "
                         f"{same_run}")
        if not all(same_resume.values()):
            fails.append(f"rank {r}: the resumed step differs from the "
                         f"saving run's: {same_resume}")
        saves = fa["saves"]
        if [s["name"] for s in saves] != ["latest"] * len(saved_at):
            fails.append(f"rank {r} saves {saves}")
        per_step = {k: base["launches"][k] // DIST_STEPS
                    for k in ("flash", "fused_dsgd_many", "gossip_mix_many")}
        if {k: fa["launches"][k] for k in per_step} \
                != {k: v * CKPT_STEPS for k, v in per_step.items()} \
                or {k: fb["launches"][k] for k in per_step} != per_step:
            fails.append(f"rank {r} launches {fa['launches']} and, resumed, "
                         f"{fb['launches']}; [dist]'s per step {per_step}")
        ms = [sum(s.values()) for s in fa["spans"]]
        print(f"{tag} rank {r} {card}: saves after steps "
              f"{' and '.join(map(str, saved_at))}: "
              + "; ".join(f"{s['bytes'] / 1e9:.3f} GB, {s['save_ms']:.1f} ms "
                          f"in save() on the step's thread ("
                          f"{'new' if s['new_buffer'] else 'reused'} host "
                          f"buffer), writer {s['write_s']:.2f} s"
                          for s in saves)
              + f"; ms/step {[round(x, 1) for x in ms]} (steps "
              f"0-{CKPT_STEPS - 1}, CUDA events; [dist] "
              f"{[round(sum(s.values()), 1) for s in base['spans']]}); "
              f"load {fb['load_s']:.2f} s; launches in the saving run "
              f"{fa['launches']}, in the resumed step {fb['launches']}; "
              f"equal bit for bit: {same_run}; the resumed step "
              f"{CKPT_STEPS - 1} equals the saving run's: {same_resume}")
        u, s_, cb = a["uninterrupted"], a["saved"], b["comp"]
        k = len(cb["payloads"])
        same_c = {"saving run": s_["losses"] == u["losses"]
                  and s_["params"] == u["params"]
                  and s_["state"] == u["state"],
                  "loaded ct": cb["loaded_ct"] == CKPT_C_STEPS - 1,
                  "ct": cb["ct"] == u["ct"] == CKPT_C_STEPS,
                  "loss": cb["losses"] == u["losses"][-1:],
                  "params": cb["params"] == u["params"],
                  "state (u, ef, ct)": cb["state"] == u["state"],
                  "payloads": k > 0 and cb["payloads"] == u["payloads"][-k:]}
        print(f"{tag} rank {r} reduced int8 + EF: resumed at step "
              f"{cb['step'] + 1} of {CKPT_C_STEPS}, {k} payloads of the "
              f"step, launches {cb['launches']} (uninterrupted, "
              f"{CKPT_C_STEPS} steps: {u['launches']}); equal to the "
              f"uninterrupted run bit for bit: {same_c}")
        if not (cb["launches"]["quantize_ef_many"]
                and cb["launches"]["quantized_gossip_mix_many"]):
            fails.append(f"rank {r}: the compressed resume launched "
                         f"{cb['launches']}")
        if not all(same_c.values()):
            fails.append(f"rank {r}: the compressed resume differs: "
                         f"{same_c}")
    total = sum(s["bytes"] for a in first for s in a["full"]["saves"])
    print(f"{tag} {total / 1e9:.3f} GB written by {TRAIN_N} ranks in "
          f"{len(saved_at)} saves of latest")
    if fails:
        raise SystemExit(f"{tag} failed:\n" + "\n".join(fails))


def phase_consensus(torch, dev):
    """``optim.mix`` over one period of Base-(k+1) on the card reaches
    exact consensus (to f32 rounding); the ring after as many rounds
    does not."""
    from repro_torch.optim.decentralized import mix
    from repro_torch.sim.engine import _consensus_error
    from repro_torch.topology import TopologySpec, build_schedule

    gen = torch.Generator(device=dev).manual_seed(5)
    for n, k in ((3, 1), (21, 2)):
        base = build_schedule(TopologySpec(name="base", n=n, k=k))
        rounds = len(base)
        x0 = {"x": torch.randn(n, 1 << 20, generator=gen, device=dev)}
        rel = {}
        for name, sched in (("base", base), ("ring", build_schedule(
                TopologySpec(name="ring", n=n)))):
            Ws, _ = sched.as_dense_stack(rounds, device=dev)
            x = x0
            for r in range(rounds):
                x = mix(Ws[r % Ws.shape[0]], x)
            rel[name] = float(_consensus_error(x) / _consensus_error(x0))
        print(f"[consensus] Base-{k + 1} at n={n}: {rounds} rounds (max "
              f"degree {base.max_degree}), relative consensus error "
              f"{rel['base']:.3e} (limit 1e-10); ring after {rounds} "
              f"rounds: {rel['ring']:.3e}")
        if not rel["base"] <= 1e-10:
            raise SystemExit(f"Base-{k + 1} at n={n} did not reach "
                             f"consensus: {rel['base']}")


def phase_profile(torch, dev, params, engine, tokens):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M
    from repro_torch.serve import make_engine

    cfg = engine.cfg
    with torch.inference_mode():
        _, caches = M.prefill(cfg, params, {"tokens": tokens}, SEQ,
                              torch.bfloat16)
        tok = tokens[:, -1:]
        M.decode_step(cfg, params, caches, tok, PROMPT)   # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(4):
                M.decode_step(cfg, params, caches, tok, PROMPT + 1 + i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 4
    print_kernel_times(prof, "decode step", wall, 4)

    # one continuous decode step: 8 slots at ragged positions, paged
    eng = continuous_engine(torch, dev, cfg)
    B = CONT_SLOTS
    table = torch.arange(1, B * CONT_MAXP + 1, dtype=torch.int32,
                         device=dev).reshape(B, CONT_MAXP)
    pos = torch.tensor([64, 207, 351, 512, 640, 801, 1000, 1086],
                       device=dev)
    tok = tokens[:, -1:].repeat(2, 1)
    with torch.inference_mode():
        M.decode_step(cfg, params, eng.pools, tok, pos, decode_mode="paged",
                      block_table=table)                     # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(4):
                M.decode_step(cfg, params, eng.pools, tok, pos + 1 + i,
                              decode_mode="paged", block_table=table)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 4
    print_kernel_times(prof, "continuous decode step (8 slots, paged)", wall,
                       4)
    del eng
    # one self-speculative generation of the [spec] cell, per round
    spec = make_engine(cfg, batch=BATCH, prompt_len=PROMPT, max_new=NEW,
                       speculate_k=SPEC_K, draft_layers=SPEC_DRAFT,
                       param_dtype=torch.bfloat16,
                       cache_dtype=torch.bfloat16, device=dev)
    spec.generate(params, {"tokens": tokens})               # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = spec.generate_with_state(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rounds = int(res.spec.rounds.max())
    print_kernel_times(prof, f"self-speculative generation, per round "
                       f"({rounds} rounds, prefill included)",
                       wall / rounds, rounds)
    del spec, res
    torch.cuda.empty_cache()


def print_kernel_times(prof, what, wall, steps):
    """Device busy time per step and the twelve busiest kernel names of
    a profiler trace over ``steps`` steps of ``wall`` seconds each."""
    from torch.autograd import DeviceType
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    busy = sum(t for t, _ in per_kernel.values()) / steps / 1e3
    print(f"[profile] {what}: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}%), "
          f"{sum(n for _, n in per_kernel.values()) // steps} kernels")
    for name, (us, n) in sorted(per_kernel.items(),
                                key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile] {us / steps / 1e3:9.4f} ms/step {n // steps:5d}x "
              f"{name[:90]}")
    for key, also in (("attn_kernel", "false>"),   # the port's: dense
                      ("attn_kernel", "true>"),    # paged
                      ("combine_kernel", ""), ("fused_dsgd_kernel", ""),
                      ("quantize_ef_kernel", "")):
        mine = [v for name, v in per_kernel.items()
                if key in name and also in name]
        if mine:
            ms = sum(t for t, _ in mine) / steps / 1e3
            print(f"[profile] {key}{'<' + also if also else ''}: "
                  f"{ms:.4f} ms/step in "
                  f"{sum(n for _, n in mine) // steps} launches")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a decode step, a continuous decode "
                         "step and a training step with torch.profiler")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on "
                         "the card")
    # a SIGTERM ends the run as a failure does: the subprocesses started
    # here are killed on the way out (_start)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: src/repro_torch not found beside "
                         f"{Path(__file__).name}; run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.compress import CompressionConfig
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    lap = PhaseClock()
    phase_build(torch)
    lap("[build]")
    entries = phase_flash_kernels(torch, dev)
    entries += phase_dsgd_kernels(torch, dev)
    entries += phase_quantize_kernels(torch, dev)
    entries += phase_paged_kernels(torch, dev)
    lap("[kernels] [dsgd] [quantize] [paged]")
    entries += phase_zoo_kernels(torch, dev)
    entries += phase_moe_kernels(torch, dev)
    entries += phase_hybrid_kernels(torch, dev)
    lap("[zoo-kernels] [moe-kernels] [hybrid-kernels]")
    entries += phase_vlm_kernels(torch, dev)
    entries += phase_encdec_kernels(torch, dev)
    lap("[vlm-kernels] [encdec-kernels]")
    entries += phase_gossip_kernels(torch, dev)
    lap("[gossip-mix]")
    # the padded pairs' entries report the launches counted under their
    # (D, Dv) over every path run from here to the sweep
    flash_attention_fwd.launches_by_dims.clear()
    launches, params, engine, tokens, plain = phase_main_path(torch, dev,
                                                              card)
    launches.update(phase_spec(torch, dev, card, params, tokens, plain))
    launches.update(phase_continuous(torch, dev, card, params))
    launches.update(phase_continuous(torch, dev, card, params, spec=True))
    if args.profile:
        phase_profile(torch, dev, params, engine, tokens)
    del params, engine, tokens, plain
    torch.cuda.empty_cache()
    lap("[main] [spec] [continuous] [continuous-spec]")
    for arch in ZOO_PROMPTS:        # each model freed before the next
        launches.update(phase_zoo_serve(torch, dev, card, arch))
    for arch, blocks in MOE_BLOCKS.items():
        launches.update(phase_zoo_serve(torch, dev, card, arch, blocks))
    launches.update(phase_zoo_serve(torch, dev, card, SSM_ARCH, kind="ssm"))
    launches.update(phase_zoo_serve(torch, dev, card, HYBRID_ARCH, blocks=1,
                                    pattern=HYBRID_CUT, kind="hybrid"))
    lap("[zoo-serve] [moe-serve] [ssm-serve] [hybrid-serve]")
    launches.update(phase_zoo_serve(torch, dev, card, VLM_ARCH, kind="vlm",
                                    prompt=VLM_PROMPT, stub_len=VLM_PATCHES))
    launches.update(phase_zoo_serve(
        torch, dev, card, ENCDEC_ARCH, kind="encdec", prompt=ENCDEC_PROMPT,
        stub_len=ENCDEC_FRAMES))
    lap("[vlm-serve] [encdec-serve]")
    launches.update(phase_train(torch, dev, card, profile=args.profile))
    launches.update(phase_train(
        torch, dev, card, profile=args.profile,
        compression=CompressionConfig(codec=COMPRESS_CODEC, chunk=CHUNK,
                                      error_feedback=True, seed=0)))
    launches.update(phase_train(
        torch, dev, card, arch=ZOO_TRAIN_ARCH, nodes=ZOO_TRAIN_N,
        steps=ZOO_TRAIN_STEPS, tag="[zoo-train]", pre="zoo-train-"))
    for arch in MOE_BLOCKS:
        launches.update(phase_train(
            torch, dev, card, arch=arch, nodes=MOE_TRAIN_N,
            steps=MOE_TRAIN_STEPS, tag="[moe-train]",
            pre=f"moe-train-{arch}-", reduced=True))
    launches.update(phase_train(
        torch, dev, card, arch=SSM_ARCH, nodes=SSM_TRAIN_N,
        steps=SSM_TRAIN_STEPS, tag="[ssm-train]", pre="ssm-train-",
        remat=True))
    launches.update(phase_train(
        torch, dev, card, arch=HYBRID_ARCH, nodes=HYBRID_TRAIN_N,
        steps=SSM_TRAIN_STEPS, tag="[hybrid-train]", pre="hybrid-train-",
        reduced=True))
    lap("[train] ... [hybrid-train]")
    launches.update(phase_train(
        torch, dev, card, arch=ENCDEC_ARCH, nodes=ENCDEC_TRAIN_N,
        steps=SSM_TRAIN_STEPS, tag="[encdec-train]", pre="encdec-train-",
        stub_len=ENCDEC_FRAMES))
    launches.update(phase_train(
        torch, dev, card, arch=VLM_ARCH, nodes=VLM_TRAIN_N,
        steps=SSM_TRAIN_STEPS, tag="[vlm-train]", pre="vlm-train-",
        reduced=True, stub_len=VLM_TRAIN_PATCHES))
    lap("[encdec-train] [vlm-train]")
    launches.update(phase_remat(torch, dev, card))
    lap("[remat]")
    dist_launches, seq = phase_dist(torch, dev, card)
    launches.update(dist_launches)
    launches.update(phase_dist(
        torch, dev, card,
        compression=CompressionConfig(codec=COMPRESS_CODEC, chunk=CHUNK,
                                      error_feedback=True, seed=0))[0])
    lap("[dist] [dist-compress]")
    overlapped = phase_dist_overlap(torch, dev, card, seq)
    lap("[dist-overlap]")
    phase_ckpt(torch, dev, card, seq, overlapped)
    lap("[ckpt]")
    tp_launches, tp_entries, counted = phase_tp_serve(torch, dev, card)
    spec_launches = tp_launches.pop("tp-spec")
    print(f"[tp-spec] flash launches per rank in its generation: "
          f"{spec_launches} ({sum(spec_launches)} on the four)")
    launches.update(tp_launches)
    entries += tp_entries
    lap("[tp-serve] [tp-train] [tp-spec]")
    launches.update(phase_failure(torch, dev, card))
    dry = start_dry_sweep()         # on the host, to the end (phase_tools)
    sweep_launches, sweep_kernels = phase_sweep(torch, dev, card)
    launches.update(sweep_launches)
    entries += sweep_kernels
    lap("[failure] [sweep]")
    # [failure] runs row 1 at the training shapes and row 3 over the 340
    # leaves at unit pre-scale (its mixer closure): the entries measured
    # at those shapes report its launches as well
    entries += [(f"failure-{kind}", dict(e, name=e["name"] + " [failure]"))
                for phase, e in list(entries)
                for kind, of in (("flash", "train-flash"),
                                 ("fused_dsgd", "train-compress-fused_dsgd"))
                if phase == of]
    for D, Dv in MOE_PADDED:
        launches[f"path-flash-{D}x{Dv}"] = \
            flash_attention_fwd.launches_by_dims[(D, Dv)]
    # the non-causal Tq > S case is on no path: its entry reads 0
    launches["encdec-noncausal-tq-gt-s"] = 0
    for phase, e in entries:
        e["launches"] = launches[phase]
        if "segments" in e:
            e["segments"] = launches[phase + "-segments"]
    idle = [e["name"] for phase, e in entries
            if not e["launches"] and phase not in (
                "dist-gossip_mix_stacked", "path-flash-64x32",
                "encdec-noncausal-tq-gt-s")]
    if idle:        # the stacked, (64, 32) and Tq > S entries: on no path
        raise SystemExit(f"kernels of a main path launched no time there: "
                         f"{idle}")

    def checks():
        """Items 5 and 6 of the module's docstring: they time nothing,
        so they run beside the tools' subprocesses, on two CPU threads
        (eight, among the ~20 processes of the tools on eight cores,
        wait on one another at every parallel region: ~25x slower)."""
        threads = torch.get_num_threads()
        torch.set_num_threads(2)
        try:
            _checks()
        finally:
            torch.set_num_threads(threads)

    def _checks():
        phase_cpu_vs_card(torch, dev)
        phase_moe_cpu_vs_card(torch, dev)
        phase_moe_cpu_vs_card(torch, dev, archs=(SSM_ARCH, HYBRID_ARCH),
                              tag="[ssm-cpu-vs-card]")
        phase_moe_cpu_vs_card(torch, dev, archs=(VLM_ARCH, ENCDEC_ARCH),
                              tag="[encdec-cpu-vs-card]")
        phase_train_cpu_vs_card(torch, dev)
        phase_compress_cpu_vs_card(torch, dev)
        phase_continuous_cpu_vs_card(torch, dev)
        phase_spec_cpu_vs_card(torch, dev)
        phase_failure_cpu_vs_card(torch, dev)
        phase_consensus(torch, dev)

    phase_tools(card, counted, dry, checks)
    lap("[dryrun] [smoke-mp] [examples] beside the cpu-vs-card phases and "
        "[consensus]")
    print(card)
    print(json.dumps({"kernels": [e for _, e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
