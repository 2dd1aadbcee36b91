#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card, end to end.

Run from the root of a checkout (it needs ``src/repro_torch`` beside it and
one CUDA device; the kernels are built into ``build/kernels/`` first):

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. print the card's name and power limit, build the four kernels, and
   print the registers and spill stores ``-Xptxas -v`` gives for each (the
   multi design's and the split-row stream's instantiations one by one);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones (``coded_matvec``'s stream, split
   and general designs each reached directly at ragged shapes of their
   own), and time kernel, plain version and
   one PyTorch library call two ways, with CUDA events:
   - ``device_ms``: many launches back to back, queued behind a sleep kernel
     so that the host runs ahead (checked, and timed again with fewer calls
     where it did not), divided by their count: the device's time;
   - ``call_ms``: the median of 20 single calls, each timed from the host's
     enqueue: the time a caller that waits for each call sees;
   the predictor's kernel is timed as the main path calls it, one 32-step
   window over the 12 workers through the sequence kernel; beside it the
   per-step cell and the launch floor (a one-element in-place add);
3. in turns on the card (new, old, old, new), at the main shape:
   ``coded_matvec``'s stream design against the warp-per-row design, each
   reached directly, and against ``torch.matmul`` on the same rows gathered
   beforehand (the general design keeps this place in turns since the
   workloads it ran take the split-row stream); the fused decode against
   the composition it replaced (index
   gather → ``mds_decode`` → transpose copy) and against the same three
   steps with ``torch.bmm``; the predictor's 32-step window through the
   sequence kernel against the per-step loop it replaced (32 ``lstm_cell``
   launches, each with the head) and against ``torch.nn.LSTM`` and the head;
4. the main path at full size: encode a 600,000 × 2,048 float32 matrix with
   a (12, 10)-MDS code, then 30 iterations of predict (LSTM) → plan
   (Algorithm 1) → coded matvec (assigned chunks only) → decode, each checked
   against a float64 product on the card, then one more encode with the
   allocator's memory warm; the kernels' launch counters are zeroed just
   before this phase and read just after it.  It fails unless every
   ``coded_matvec`` launch took the stream design, ``mds_decode``
   launched exactly once per iteration, and the predictor launched the
   sequence kernel once per prediction with history (29) and the per-step
   cell never.  Before it, the last prediction's window is run both through
   the sequence kernel and through the per-step loop, which must agree;
5. the cluster engine (``repro_torch.cluster``) on the card: 12 worker
   threads on the in-process transport compute their chunks through the
   CUDA ``KernelBackend`` (shards resident on the card) and the master
   decodes through ``mds_decode`` (``decode_with_kernel``), planning with
   the LSTM on the card, under the trace's speeds.  A 600,000 × 2,048
   tenant, C = 20, is encoded on the host in float64 as the reference does;
   then 5 ``GeneralS2C2`` matvec rounds, one ``matmul`` round at B = 8
   and one at B = 20, each within 1e-3 of a float64 product.  The counters
   are zeroed before each group of rounds and read after it, once every
   worker is idle.  It fails unless every B = 1 chunk launch took the
   stream design, ``coded_matvec`` launched once per chunk computed and
   column group of at most 16, ``mds_decode`` once per round, and the
   predictor's sequence kernel once per round with history (its cell
   never), every B = 1 chunk launch took the stream design and every
   ``matmul`` chunk launch the multi design.  At a chunk's shape it holds
   each ``coded_matvec`` launch the backend makes (B = 1, 8 and 20) and the
   round's ``mds_decode`` against their plain versions on the same card
   tensors, and times in turns (multi, ``torch.matmul``, plain and back) the
   multi design on a chunk's view of a resident shard at B = 2, 4, 8 and 16,
   and on the worker's whole partition (nb = 20 chunks) at B = 8, each
   launch on the next of the shard's 20 chunks, so that none finds its rows
   in the 50 MB L2 cache, as a round does not.  It prints the host
   encode's time and resident memory, the makespans, ``compute_chunk``'s
   ``call_ms``, the decode's times, ``calibrate_row_cost`` and the
   backend's caches.  Then a small pool of spawned worker processes
   (``SocketTransport``, 4 workers, each building the CUDA backend on the
   card from the library built here) runs 3 exact rounds.  Last, the
   cluster's fault paths: ``scripts/torch_chaos_demo.py``'s three scenarios
   at seed 0 at the script's sizes, each a pool of spawned workers
   computing through the CUDA backend (``kernel:cuda:<index>``) on
   float32 shards resident on the card (kill at the main path's 60,000 ×
   2,048 a worker, D = 240,000; partition and recover at 20,000 × 2,048,
   D = 60,000), the master decoding
   through ``mds_decode`` and planning with the LSTM on the card: ``kill``
   ((6, 4), a worker SIGKILLed mid-round: a fail-stop verdict on its dead
   process before the first failover, the worker fenced, the card's memory
   regaining at least its 491.5 MB shard), ``partition`` ((3, 3), a 2 s
   events-only partition: a verdict, a rejoin, chunks of the partition
   credited, not recomputed) and ``recover`` (the master crashed mid-round
   and rebuilt from its journal: one recovered round, no journaled ack
   re-enqueued, the adopted children's shards not uploaded again); every
   ``y`` within 1e-4 of float64, the master's ``mds_decode`` once a decoded
   round and sequence launches once a prediction from history, no segment
   of the scenario's pool (``s2c2shm_<uid>``) left in ``/dev/shm`` and the
   card's memory in use back within 1 GB after each, one survivor's chunk
   and one round's decode held to their plain versions;
6. the paper's workloads at full size, through ``repro_torch.workloads``
   (the loops the examples run), each step with its launches counted from
   0 and checked, each of its kernels then held against its plain version
   on the step's own card tensors (the encode it ran, one real round's
   ``coded_matvec`` and ``mds_decode_into``, the training window's
   sequence), its tensors freed before the next:
   (a) the LSTM predictor trained on the card as ``benchmarks/
       fig_predictor.py`` trains it (300 epochs over 400 × 20 traces) from
       the JAX package's start (``data/lstm_predictor_init.json``): one
       sequence launch under grad per epoch and one per evaluation (302,
       the per-step cell never), its test MAPE within 1e-3 (relative) of
       the JAX package's training (the committed parameters) and below
       the untrained model's; 5 epochs all plain on the card and on the
       CPU are timed beside it;
   (b) logistic regression and the SVM by 100 steps of gradient descent
       on ``make_lr_dataset(240,000, 5,000)`` with A·w coded ((12, 10)
       code, C = 20, the stream design) and planned each step from the
       trained predictor's forecast of ``controlled_traces(12, 100, 1
       straggler)``, Aᵀ·g a float32 ``torch.matmul``: every coded A·w
       within 1e-3 of the float64 product, the logistic weights within
       1e-3 of the same descent in float64 on the card, the SVM's
       objective within 3e-5 of its float64 run's (its weights, like an
       uncoded float32 run's, are printed beside them), accuracy above 0.8
       and within 0.005 of float64; 200 ``coded_matvec``, 200
       ``mds_decode`` and 198 sequence launches;
   (e) a cyclic gradient code (12 groups, 2 stragglers) over 24,000 of
       those rows, partitioned by ``balanced_part_sizes`` from (b)'s
       forecast, each group's coded gradient from ``encode_local`` on the
       card, decoded from 3 live sets within 1e-3 of float64;
   (c) PageRank (40 power iterations on ``make_graph(32,768, 16)``) and a
       3-hop Laplacian filter on its first 16,384 nodes, each matvec coded
       on the split-row stream (rows over the stream's 32 KB) and planned
       from the trained predictor, every coded product within 1e-3 and
       the result within 1e-4 of float64 on the card; 43 split-design
       and 43 ``mds_decode`` launches; then the split design at both
       shapes in turns (new, old, old, new) against the general design
       reached directly on the same operands, ``torch.matmul`` on the same
       rows gathered beforehand and the plain version;
   (d) the Hessian AᵀDA of a 6,000 × 6,000 matrix on a (12, a = b = 3)
       polynomial code from 9 nodes, within 1e-3 of float64 on the card;
7. serving mistral-nemo-12b at full width and depth (40 layers, d_model
   5,120, 12.2 B parameters, 24.5 GB in bfloat16, random weights from a
   seed) through ``repro_torch.launch.serve``:
   (a) ``main(["--coded-head"])``'s two steps, ``build`` and ``run``, with
       the JAX package's defaults (6 requests, 8-token prompts, 8 new
       tokens, max_batch 4) and the coded head's validation, its launches
       counted from 0: exactly one ``mds_encode``, one ``coded_matvec``
       (the multi design) and one ``mds_decode``, the coded head within
       1e-3 of the dense product;
   (b)-(d) the model of (a) kept, the same requests served with each
       decode step between CUDA events (median beside its bound: the bytes
       of the weights and the KV cache over 3.35 TB/s), tokens/s, and two
       steps under ``torch.profiler`` for the kernels' time and the
       device's idle share: smoke traffic, at a context of at most 16;
   (d2) the same at a real context: 4 prompts of 2,048 tokens through
       ``LM.prefill``, then 8 greedy decode steps between CUDA events and
       two under the profiler;
   (e) prefill of 12 tokens then one decode step against 13 decode steps
       from scratch, within 5e-2 of the largest logit (bfloat16 through
       40 layers);
   (f)-(g) ``CodedLMHead`` over the float32 head ((6, 4) code, 8 chunks):
       logits of x (2, 5,120) under speeds [1, 1, 0.2, 1, 1, 0.5] within
       1e-3 of a float64 product on the card, one launch of each kernel
       counted from 0 and each held to its plain version on the same
       tensors; then the call's time against ``x @ head`` and the plain
       versions, and the multi design at the head's shape in turns against
       the plain version and three PyTorch calls (``torch.matmul`` and
       ``F.linear`` on the assigned rows gathered beforehand, and the dense
       ``x @ head``, which reads as many bytes); the fastest of the three is
       the record's ``library_ms``.

8. serving the other decoder families through the same entry point, one
   arch at a time, each freed before the next (phase 7's model is freed
   before the first), random weights from seed 0 in bfloat16 at full
   width: phi3.5-moe-42b-a6.6b (d_model 4,096, 16 experts of d_ff 6,400)
   at 28 of 32 layers, zamba2-1.2b (38 Mamba-2 layers, 7 applications of
   the shared attention block) and xlstm-125m (9 mLSTM and 3 sLSTM
   layers) whole, gemma3-27b whole (62 layers, 52 local with a 1,024-token
   window and 10 global, head_dim 168, GeGLU, the attention logits'
   softcap, the head tied to the embedding), internvl2-26b whole (48
   layers, the projector of 256 image embeddings of width 3,200, a
   92,553-token vocabulary padded to 92,672), mixtral-8x22b at 14 of 56
   layers (8 experts top-2, a 4,096-token window on every layer),
   nemotron-4-340b at 8 of 96 layers (d_model 18,432, head_dim 192,
   squared ReLU, LayerNorm) and mistral-large-123b at 26 of 88 layers
   (d_model 12,288, 96 query heads over 8 KV heads, SwiGLU of d_ff
   28,672, an untied head): the cut archs at the most layers that leave
   8 GiB of the card free after the build (the depth is printed; the
   phase fails, never shrinks, where they do not fit);
   (a) ``launch.serve.run(parse_args(["--arch", A, "--coded-head"]),
       model)`` at the JAX package's defaults, the launches counted from 0:
       exactly one ``mds_encode``, one ``coded_matvec`` (the multi design,
       at each head's shape) and one ``mds_decode``, the coded head within
       1e-3 of the dense product, 6 requests of 8 tokens served; the card's
       peak memory of the build and of the serve.  gemma3's tied head gets
       no coded head (none launched, as the JAX package's entry point
       builds none); nemotron runs without ``--coded-head`` (none
       launched), since the head's float32 copies do not fit beside its
       layers;
   (b) the same requests with each decode step between CUDA events
       (tokens/s, the median step at B = 4 beside its bytes bound: every
       weight, the K/V within each layer's window and the recurrent
       states; for a MoE also the bound of the experts the step's tokens
       are routed to, counted outside the timed steps), two steps under
       the profiler (kernel time, idle share), then the same after a 4 ×
       2,048-token ``LM.prefill`` (internvl2's with 256 random image
       embeddings ahead of each prompt; mixtral also after 4 × 4,608
       tokens), printing the attention caches' lengths: past its window a
       local layer decodes from a rotating cache of the window's length;
   (c) prefill of 12 tokens then one decode step against 13 decode steps
       from scratch in float32 (internvl2: prefill of its image embeddings
       and 12 tokens then a step, against the prefill of 13), within 2e-3
       of the largest logit;
   (d) bfloat16 against float32 of the same weights: a MoE's layer-0 block
       on 4 × 16 normed positions, over the tokens routed alike in both
       (a token routed otherwise is printed with its float32 gates and
       fails the run unless they lie within twice the router's own
       bfloat16 error), and internvl2's projector on (b)'s embeddings, on
       the model of (a); then 16 decode steps at B = 4 in bfloat16 with
       every norm, attention, MLP and recurrent block and ``head_apply`` run
       again in float32 on the bfloat16 run's input and state, within
       2e-2 (an mLSTM block 0.1), and the same steps after the weights are
       upcast in place, the first step's logits within 0.25 (a MoE's over
       the tokens routed alike; the later steps' drift is printed): on the
       model of (a) for zamba2 and xlstm, else on a bfloat16 draw of the
       first layers at full width from the same seed (the same embedding
       and first layers: phi 4, gemma3 6, so that global layer 5 is in,
       internvl2 4, mixtral 4, nemotron 1, mistral-large 4), on whose
       float32 weights (c) runs;
   (e) the coded head at each untied head (``hold_coded_head``: exactly
       one launch of each kernel, each held against its plain version;
       nemotron's 18,432 × 256,000 head built here, after its layers are
       released, its launches in its record and not in
       ``families_launches``), then the multi design in turns against
       ``x @ head`` and the plain version, beside its bound.
9. the encoder-decoder, seamless-m4t-large-v2 whole (24 encoder and 24
   decoder layers, d_model 1,024, vocab 256,206 padded to 256,256, 1.63 B
   parameters, 3.27 GB in bfloat16, random from seed 0), driven through
   ``EncDecLM``'s own ``prefill`` and ``decode_step``: ``launch.serve.main``
   must refuse the arch with ``SystemExit``, as the JAX package's does;
   (a) smoke traffic, B = 4 sequences of 16 frames and 8 prompt tokens,
       then 8 greedy steps, and (b) a real context, 4 × (2,048 frames +
       2,048 tokens), then 8 steps: the prefill with its encoder and
       decoder timed apart between CUDA events, each step between CUDA
       events beside its bound (the decoder's weights, the head, the self
       K/V and every layer's cross K/V), two steps under the profiler;
       then each encoder block on (b)'s frames in bfloat16 against float32
       of the same weights on the same input, within 2e-2;
   (c) on a float32 copy of the same weights, prefill(16 frames, 12 tokens)
       then one decode step against prefill(16 frames, 13 tokens), within
       2e-3 of the largest logit;
   (d) bfloat16 against that float32 copy, 16 decode steps at B = 4 after
       a prefill: every decoder block (self-attention, cross-attention,
       MLP) and ``head_apply`` run again in float32 on the bfloat16 run's
       input and cache, within 2e-2, the first step's logits within 0.25;
   (e) the coded head at d = 1,024 × V = 256,256 (``hold_coded_head``:
       exactly one launch of each kernel, each held against its plain
       version), then the multi design (nb = 32 blocks of 8,008 rows) in
       turns against ``x @ head`` and the plain version, beside its bound.

10. training on the card through ``repro_torch.launch.train`` (``main``,
    and ``run`` on a model built at a cut depth), the kernels' launch
    counters zeroed before (a) and read after (f):
    (a) xlstm-125m whole (12 layers, 9 mLSTM and 3 sLSTM, d_model 768,
        vocab 50,304, random from seed 0) with ``examples/train_lm.py``'s
        flags without ``--reduced`` but the sequence: coded DP over 8 groups
        tolerating 2, group 3 killed at step 10, batch 16, seq 32 (the
        example's 48 cut for the script's time), 11 steps into a temporary
        checkpoint directory (24 microbatches a step), group 3 dead in
        exactly step 10 (the loop's 5-step window, cut by the run's end;
        the CPU rehearsal's 15 steps hold all of it); every loss finite and
        ``loss_improved=True`` printed; then ``main`` again with 12 steps,
        which must resume from the step-10 checkpoint and run the
        step left; each step's time (the card synchronised at its start)
        and the peak memory;
    (b) zamba2-1.2b whole (38 Mamba-2 layers and the shared attention
        block, 1.17 B parameters) for 1 coded AdamW step over 8 groups,
        its peak memory beside the reckoning of the JAX package's
        functional step (parameters, AdamW moments, 8 float32 coded trees,
        the decoded tree and its /n copy, a microbatch's gradients);
    (c) the sLSTM scan's backward (autograd through ``ssm._slstm_scan``'s
        loop) on one xlstm-125m sLSTM layer, float32: at B = 2, S = 64,
        (dr, db, dxw) against the same loop's in float64 within 1e-4 of
        each gradient's largest value; at S = 64 and 1,024, forward and
        backward between CUDA events and the memory the backward's graph
        held, beside the outputs' bytes;
    (d) every kernel counter reads 0 across (a)-(f): the training path,
        like the JAX package's, reaches none of the four kernels;
    (e) one coded microbatch of each (B = 2, S = 32: ``loss_fn`` and the
        gradient of every parameter) under ``torch.profiler``: its kernels'
        time, launches and the device's idle share;
    (f) the four families (a) and (b) do not train, at full width in
        bfloat16 from seed 0, each through ``launch.train.run`` for 1 coded
        AdamW step: seamless-m4t-large-v2 whole (24 encoder and 24 decoder
        layers, 1.633 B parameters) over 8 groups tolerating 2, 16 x 32
        tokens and 16 frames a sequence; phi3.5-moe-42b-a6.6b at 1 of 32
        layers (1.565 B) over 4 groups tolerating 1, 8 x 256 tokens;
        gemma3-27b at 1 of 62 layers (a local layer, 1.843 B) over 4 groups
        tolerating 1, 4 x 2,048 tokens, past its 1,024-token window; and
        mistral-large-123b at 1 of 88 layers (2.189 B: GQA attention over 96
        query and 8 KV heads, SwiGLU, RMSNorm, an untied head) over 4 groups
        tolerating 1, 8 x 256 tokens.  Before
        each build its reckoning in place (the parameters, AdamW's moments,
        the coded trees and a microbatch's gradients) must leave 8 GiB of
        the card's free memory (seamless falls back to 4 groups tolerating
        1; nothing is cut); then its step's time, finite losses, its peak
        memory beside the reckoning in all and in place, its build time,
        one coded microbatch of the run's first batch under the profiler,
        and the float64 witness on its first sequence with the weights the
        run started from: the loss and every gradient in float32 on them
        upcast, against the same in float64 under ``float64_witness`` (no
        float32 tensor left), the loss and gradient norm within 1e-4 and
        every leaf within 2e-3 of its largest witness value (phi: the tokens
        routed otherwise in the two runs printed).

11. the worker mesh and ``launch/``'s step builders at full width:
    (a) the main path's (n, k) = (12, 10), D = 600,000, d = 2,048 float32,
        C = 20 across a worker mesh (``make_worker_mesh(12,
        device_type="cuda")``) of 12 spawned ranks that share the card over
        gloo (NCCL refuses two ranks on one device): A made once in host
        memory (a file-backed array each rank maps), each rank encoding its
        own partition chunk by chunk (``mds_encode`` on ``G[w:w+1]``), then
        10 iterations of phase 4's allocations (the predictor on the card
        over ``controlled_traces(12, 30, 2, seed=7)``, here in the parent):
        each rank's assigned chunks (``coded_matvec``), the all-gather of the
        partials (through pinned host memory under gloo), the decode
        (``mds_decode``), every rank's y within 1e-3 of a float64 product;
        each rank's launches (each kernel above 0; ``mds_encode`` once a
        chunk, ``mds_decode`` once an iteration, ``coded_matvec`` on the
        stream design), rank 0's iteration median and the combine's share,
        the ranks' peak allocations beside ``mesh_memory_reckoning`` and the
        card's memory in use;
    (b) ``build_train_step`` on zamba2-1.2b whole at ``train_4k``'s 4,096
        tokens, its global batch of 256 cut to 4, ``grad_accum_for``'s
        microbatches, ``cfg.optimizer``: 1 step, its loss and gradient norm
        finite, its time and the peak memory;
    (c) ``build_prefill_step`` and ``build_decode_step`` on mistral-nemo-12b
        whole in bfloat16, ``decode_32k``'s batch of 128 cut to 4 and its
        context to a 2,048-token prompt, 8 greedy steps: the logits and
        tokens bit for bit ``LM.prefill`` and ``LM.decode_step`` called
        directly; then the parameters placed by ``param_shardings`` on a
        (1, 1) mesh over a world-size-1 NCCL group, whose tokens must be the
        same;
    (d) ``build_prefill_step`` and ``build_decode_step`` on a (2, 2)
        ``("data", "model")`` mesh of 4 spawned ranks that share the card
        over gloo (DTensor's all-gathers, reduce-scatters and all-to-alls
        of CUDA tensors staged through host memory: gloo crashes gathering
        CUDA tensors into one): zamba2-1.2b and seamless-m4t-large-v2 whole
        and phi3.5-moe-42b-a6.6b at full width and 2 of its 32 layers (its
        experts split over the model axis, the dispatch an all-to-all), in
        bfloat16 and in float32 with the same weights, 4 x 512 tokens
        (seamless: 512 frames and 512 tokens) and 2 steps decoding the
        unsharded bfloat16 run's greedy tokens; each rank's heads, experts,
        caches and recurrent states its own (``partition.on_local_shards``),
        every cache a DTensor placed by ``cache_sharding_rules`` after the
        prefill and each step; float32 logits within F32_HANDOFF_REL of the
        unsharded run's; bfloat16 logits, at each step, within HANDOFF_REL
        of the unsharded float32 run's or no farther from them than
        MESH_BF16_RATIO times the unsharded bfloat16 run's; every token a
        rank picks (the prefill's and each step's) the argmax of the logits
        it holds there; in float32 the first step's tokens the unsharded
        run's (in bfloat16, for a row whose token differs, the unsharded
        run's gap between the two tokens beside the row's largest logit
        difference, shown); each rank's peak allocation beside the
        dry-run's reckoning of the cells on a ``fake`` group of 4;
    (e) ``build_train_step`` on the same mesh of 4 spawned gloo ranks:
        zamba2-1.2b at full width and 19 of its 38 layers in float32
        (drawn as (d) draws it), ``train_4k``'s
        4,096 tokens cut to 1,024 and its batch of 256 to 4,
        ``grad_accum_for``'s microbatches, SGDM, one step, the weights placed
        by ``shard_model``, the optimizer's state by
        ``train_state_shardings``, the batch by ``batch_shardings``; every
        rank, and the same step unsharded in float32, held to the same step
        unsharded in float64 on the card (the witness): the loss and
        gradient norm within 1e-4 of the witness's, every parameter after
        the step within 2e-3 of the witness's largest update of it (the half
        float32 ulp of its largest value aside); rank 0's step time beside
        the unsharded one; each rank's peak allocation over the step beside
        the dry-run's reckoning of the cell on a ``fake`` group of 4;
        (b)-(e) launch none of the four kernels (their counters read 0), as
        the JAX package's step builders reach no Pallas kernel.

12. the dry-run, the roofline and the cluster demo:
    (a) ``python -m repro_torch.launch.dryrun`` in three subprocesses on
        the host (the card hidden from them), started together before
        phase 10, so that they run on the host's idle cores beside phases
        10 and 11, and collected after (b) and (c): zamba2-1.2b ×
        ``train_4k`` × pod at two
        microbatches (``REPRO_GRAD_ACCUM=2``, so the step splits the
        gathered batch), mistral-nemo-12b ×
        ``decode_32k`` × pod and zamba2-1.2b × ``decode_32k`` × multipod,
        each on a ``fake`` group of 256 or 512 ranks, each record ``ok``
        with every key of the JAX package's and printed;
    (b) phase 11 (b)'s train step and (c)'s decode step again, once each
        under ``roofline.StepCounter`` on the card's tensors (one rank):
        the ``RooflineResult`` with the H100's data-sheet constants beside
        phase 11's medians (the bound, its term, measured over bound); then
        the dry-run of that decode cell on a (1, 1) mesh of a one-rank
        ``fake`` group, its peak resident bytes beside the card's
        ``max_memory_allocated`` over the step;
    (c) ``examples/torch_cluster_demo.py`` on the card, its launches
        counted from 0 (``coded_matvec`` on the stream and multi designs,
        the predictor's sequence kernel, no encode or decode launch), the
        first launch of each design and the first window kept and held
        against their plain versions, each within DEMO_HELD_REL of the plain
        result's largest value.

The last lines are phase 12's, 11's, 10's, 9's, 8's, 7's and 6's records as JSON,
the in-turn times as JSON, the per-kernel record as JSON (``ms``,
``plain_ms`` and ``library_ms`` are device times; ``*call_ms`` the per-call
times; ``launches`` the main path's, ``cluster_launches`` the cluster
phase's, ``workload_launches`` phase 6's, ``serve_launches`` phase 7's entry
point's, ``families_launches`` phase 8's entry points',
``encdec_launches`` phase 9's coded head's, ``chaos_launches`` the
master's in phase 5's fault scenarios (null for ``coded_matvec``'s records:
the spawned children launch it, and their counters stay in their
processes; the chunk spans they forwarded are in the ``chaos`` record),
``train_launches`` phase 10's,
all 0, ``mesh_launches`` phase 11 (a)'s, summed over the ranks, and for the
predictor's kernel the parent's, ``demo_launches`` phase 12 (c)'s) and the
device line.
The record of ``coded_matvec``'s multi design that the cluster's
``matmul`` rounds launch is at a chunk's shape at B = 8, and its
``launches`` are the cluster phase's; the
two records of the split design, which only phase 6 launches, are at
PageRank's and the filter's shapes, with phase 6's launches and the general
design's time on the same operands (``old_ms``); the record of
the multi design at the lm_head's shape has phase 7's.
"""

from __future__ import annotations

import atexit
import collections.abc
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the main path: the paper's logistic-regression workload as the repo sizes it
# (benchmarks/fig_overheads.py: (n, k) = (12, 10), D = 600,000; C = 20 chunks
# as in examples/pagerank.py), with d = 2,048 float32 columns
N, K, CHUNKS, ROWS, COLS, ITERS = 12, 10, 20, 600_000, 2_048, 30
# the cluster phase: the same code, D, C and d
# 5 rounds, not 20 (10 before mistral-large-123b came): the script's time
CL_ROUNDS, CL_ROW_COST, CL_WIDTHS = 5, 1e-5, (8, 20)
MULTI_WIDTHS = (2, 4, 8, 16)    # coded_matvec's multi design in turns at a chunk
WINDOW = 32                     # the predictor's window (SpeedPredictor's default)
REL_ERR_LIMIT = 1e-3
F32_TOL = 2e-4                  # a float32 kernel against its plain version (rtol = atol)
HEAD_SLAB = 8_192               # columns of a coded head's float64 reference at a time
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12         # float32 outside the tensor cores
REPS = 20
DEVICE_WINDOW_MS = 50.0         # device_ms: about this much work per window
# phase 6, the paper's workloads: the predictor's training call of
# benchmarks/fig_predictor.py; gradient descent over gisette's 5,000 features
# (the dataset the paper duplicates) as examples/coded_regression.py runs it;
# PageRank and the 3-hop filter of examples/pagerank.py on a larger graph;
# the Hessian at benchmarks/fig_polynomial.py's 6,000 x 6,000
PRED_TRACES = dict(n_nodes=20, n_iters=400, noise_sigma=0.08, p_become_straggler=0.03,
                   p_recover=0.25, drift_sigma=0.05)
PRED_SEED, PRED_EPOCHS = 7, 300
PRED_MAPE_RTOL = 1e-3           # the port's training against the JAX package's, test MAPE
PLAIN_EPOCHS = 5                # all-plain training, timed per epoch (not 30: the script's time)
SVM_OBJECTIVE_RTOL = 3e-5       # 10x the worst reading of PR 17's runs (2.8e-6)
LR_ROWS, LR_COLS, LR_ITERS, LR_STEP = 240_000, 5_000, 100, 0.5
PR_NODES, PR_DEGREE, PR_ITERS, PR_DAMPING = 32_768, 16, 40, 0.85
FILTER_NODES, FILTER_HOPS = 16_384, 3
HESSIAN, POLY_NODES = 6_000, [0, 1, 3, 4, 5, 7, 8, 9, 11]
GC_S, GC_BATCH, GC_LIVE_SETS = 2, 24_000, 3
# phase 7, serving: mistral-nemo-12b at full width and depth in bfloat16,
# with the JAX package's serving defaults and coded-head stragglers
# PROFILED_STEPS: 2, not 5, since phase 8 serves seven archs: the profiler's
# host time grows with its events, about 1 s a gemma3-27b step, the count
# and kernel time alike (scripts/torch_profiler_cost.py)
SERVE_ARCH, SERVE_SPEEDS, PROFILED_STEPS = "mistral-nemo-12b", [1, 1, 0.2, 1, 1, 0.5], 2
HANDOFF_REL = 5e-2              # bfloat16 prefill handoff, over the largest logit
# a decode step at a real context: 4 prompts of 2,048 tokens through
# LM.prefill, then greedy steps, each between CUDA events (8, not 16, since
# phase 8 serves seven archs)
LONG_BATCH, LONG_CONTEXT, LONG_STEPS = 4, 2_048, 8
BF16_FLOPS_PER_S = 989e12       # H100 SXM, dense bfloat16 tensor cores
# phase 8, the other decoder families through the same entry point, each at
# full width in bfloat16 from seed 0: zamba2-1.2b, xlstm-125m, gemma3-27b
# and internvl2-26b whole; phi3.5-moe, mixtral-8x22b, nemotron-4-340b and
# mistral-large-123b at the depth of FAMILY_LAYERS, the most layers that
# leave FREE_AFTER_BUILD free on an 80 GB card (73.35, 70.92, 74.14 and 73.59
# GB; mistral-large's 27 layers, 76.36 GB, would leave 7.7-7.9 GB of the
# 84.1-84.3 GB free before a build; the phase fails where they do not fit,
# it never shrinks them)
FAMILY_ARCHS = ("phi3.5-moe-42b-a6.6b", "zamba2-1.2b", "xlstm-125m", "gemma3-27b",
                "internvl2-26b", "mixtral-8x22b", "nemotron-4-340b", "mistral-large-123b")
MOE_ARCH, MOE_LAYERS = "phi3.5-moe-42b-a6.6b", 28
FAMILY_LAYERS = {MOE_ARCH: MOE_LAYERS, "mixtral-8x22b": 14, "nemotron-4-340b": 8,
                 "mistral-large-123b": 26}
FREE_AFTER_BUILD = 8 * 2**30    # room for the caches, the prefill and the coded head
# (c) and (d) on a bfloat16 draw of the first layers at full width where the
# whole model's float32 twin does not fit (upcast in place, in float32:
# phi 4 layers 21.9, gemma3 6 16.0, internvl2 4 10.9, mixtral 4 41.7,
# nemotron 1 51.6, mistral-large 4 25.4 GB); zamba2's and xlstm's on the
# model of (a)
F32_LAYERS = {MOE_ARCH: 4, "gemma3-27b": 6, "internvl2-26b": 4, "mixtral-8x22b": 4,
              "nemotron-4-340b": 1, "mistral-large-123b": 4}
# served without --coded-head: nemotron's coded head in float32 (the dense
# head 18.9 GB and 6 coded partitions of 64,000 rows, 28.3 GB) does not fit
# beside its layers; (e) builds and holds it alone
UNCODED_ENTRY = ("nemotron-4-340b",)
# (b)'s real contexts: LONG_CONTEXT, and for mixtral also one past its
# 4,096-token window, so that its caches rotate (gemma3's 1,024-token window
# is passed at LONG_CONTEXT)
LONG_CONTEXTS = {"mixtral-8x22b": (LONG_CONTEXT, 4_608)}
F32_HANDOFF_REL = 2e-3          # float32 prefill handoff (tests/test_models.py's 2e-3)
# bfloat16 against float32 of the same weights (measured on one H100 in
# three runs): one block on the same input, at most 8.2e-3 for phi's MoE
# block, 4.9e-3 attention, 5.8e-3 MLP, 7.0e-3 Mamba-2, 4.1e-3 sLSTM, and
# 4.5e-2 mLSTM, whose normaliser |nᵀq| is a sum that can cancel; a whole
# model's logits after its first decode step, 1.4e-2 for zamba2 and 0.154
# for xlstm (the random weights amplify each block's rounding through the
# layers; later steps compound it through the recurrent states, as the JAX
# package's bfloat16 decode does, and are printed, not bounded)
BF16_REL = 2e-2
BF16_MLSTM_REL = 0.1
BF16_LOGITS_REL = 0.25
HANDOFF_TOKENS = 12
# phase 9, the encoder-decoder: seamless-m4t-large-v2 whole (24 encoder and
# 24 decoder layers, d_model 1,024, vocab 256,206 padded to 256,256) in
# bfloat16 from seed 0, through EncDecLM's prefill and decode_step; smoke
# traffic of B = 4 x (16 frames + 8 prompt tokens) and 8 greedy steps, then
# a real context of 2,048 frames + 2,048 tokens (half each of a 4,096
# budget, as the JAX package's enc_len_for splits it) and LONG_STEPS steps;
# its encoder and decoder blocks held at BF16_REL, its first step's logits
# at BF16_LOGITS_REL.  Measured on one H100 (NVIDIA H100 80GB HBM3, 700 W):
# an encoder block at most 5.3e-3 (attention) and 4.6e-3 (MLP), a decoder
# block 5.2e-3, cross-attention 4.2e-3, head_apply 3.3e-3, the first step's
# logits 1.3e-2: the limits hold with a margin of about 4x and 19x
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_SMOKE = (16, 8, 8)       # frames, prompt tokens, decode steps at B = 4
ENCDEC_CONTEXT = 2_048          # frames and prompt tokens of (b)

# phase 10, training on the card through launch.train.main: xlstm-125m whole
# with examples/train_lm.py's flags without --reduced (8 groups, 2 tolerated,
# group 3 killed at step 10, batch 16) but its seq 48 cut to 32, for
# TRAIN_STEPS[0] steps, then
# a restart to TRAIN_STEPS[1] that resumes from the last checkpoint;
# zamba2-1.2b whole for BIG_STEPS coded AdamW steps; the sLSTM scan's
# backward at B, S = SLSTM_BS, float32, against the same loop's in float64,
# then timed and its graph's memory read at S = SLSTM_BS[1] and
# SLSTM_LONG_S (the reduced config's, the CPU test's, shorter)
TRAIN_ARCH = "xlstm-125m"
TRAIN_BIG = "zamba2-1.2b"
# (15 steps held the loop's whole 5-step dead window, 10-14, before the
# checkpoint; 12 since (f) came, for the script's time (steps of 10.2-13.8
# s), the window cut to 10-11, the CPU test's 15 holding all of it; a
# restart to one step more resumes 1; 20 and 24 took the phase 500 s of
# a 1,200 s script on a slow host.  Seq 32, not the example's 48, since
# phase 11 (d)'s MoE and (e) came: an xlstm step 7.6 s, not 12.4, on one
# H100 (NVIDIA H100 80GB HBM3, 700 W); at 24 the 15 steps did not lower
# the loss, 11.2020 to 11.2826.  Since (e)'s float64 witness, for the
# script's time: the sLSTM's long scan is 1,024, not 2,048; since phase 8
# serves seven archs: the restart resumes 1 step, not 3, and zamba2 takes
# BIG_STEPS = 1, not 3, each timed up to the final checkpoint; 11 steps, not
# 12, since phase 8 serves and (f) trains mistral-large-123b: the window cut
# to step 10 alone, the restart to 12 resuming 1)
TRAIN_STEPS = (11, 12, 16, 32)          # steps, steps after the restart, batch, seq
TRAIN_STEPS_REDUCED = (15, 18, 8, 16)   # the CPU test's
DEAD_STEPS = 5                          # train_loop.train's window for a killed group
BIG_STEPS = 1
SLSTM_BS = (2, 64)
SLSTM_LONG_S = {False: 1_024, True: 256}
SLSTM_BWD_REL = 1e-4                    # of each gradient's largest value
PROFILED_MICROBATCHES = 2
# (f) the four families phase 10 had not trained, at full width through
# launch.train.run, BIG_STEPS coded AdamW steps each: seamless-m4t-large-v2
# whole with examples/train_lm.py's flags (16 frames a sequence); phi3.5-moe,
# gemma3-27b and mistral-large-123b at TRAIN_LAYERS, the most that fit one
# card by the in-place reckoning (phi 1.565 B parameters at one layer, 43.8
# GB at 4 groups, two layers 2.865 B do not fit; gemma3 1.843 B, 51.6 GB, its
# first global layer is the sixth and six layers, 4.01 B, do not fit;
# mistral-large 2.189 B, 61.3 GB, where 8 groups reckon 96.3 and two layers,
# 3.573 B, do not fit at 4), gemma3's 2,048 tokens past its 1,024-token
# window; mistral-large with phi's 8 x 256 tokens.  Seamless at 8 groups
# reckons 71.9 GB in place; where that does not fit it takes
# TRAIN_FALLBACK_GROUPS (4 groups tolerating 1).
# Then the loss and every gradient on one sequence of the first batch in
# float32, with the weights the run started from, held to float64
# (float64_witness) at MESH_TRAIN_TOL and, leaf by leaf, at
# MESH_TRAIN_UPDATE_TOL of the witness's largest value.  On one H100
# (NVIDIA H100 80GB HBM3, 700 W) (f) took 113.9 s alone: seamless 67.0
# (a step 25.4 s, its 16.3 GB final checkpoint about 14), phi 20.4, gemma3
# 22.6; peaks 74.06, 47.23 and 62.94 GB
TRAIN_FAMILIES = ("seamless-m4t-large-v2", "phi3.5-moe-42b-a6.6b", "gemma3-27b",
                  "mistral-large-123b")
TRAIN_LAYERS = {"phi3.5-moe-42b-a6.6b": 1, "gemma3-27b": 1, "mistral-large-123b": 1}
TRAIN_FLAGS = {
    "seamless-m4t-large-v2": ("--arch", "seamless-m4t-large-v2", "--coded-dp", "--groups", "8",
                              "--tolerate", "2", "--batch", "16", "--seq", "32"),
    "phi3.5-moe-42b-a6.6b": ("--arch", "phi3.5-moe-42b-a6.6b", "--coded-dp", "--groups", "4",
                             "--tolerate", "1", "--batch", "8", "--seq", "256"),
    "gemma3-27b": ("--arch", "gemma3-27b", "--coded-dp", "--groups", "4", "--tolerate", "1",
                   "--batch", "4", "--seq", "2048"),
    "mistral-large-123b": ("--arch", "mistral-large-123b", "--coded-dp", "--groups", "4",
                           "--tolerate", "1", "--batch", "8", "--seq", "256"),
}
# the CPU test's: the reduced configs, gemma3's 32 tokens past the reduced window of 16
TRAIN_FLAGS_REDUCED = {
    arch: flags[:-4] + ("--batch", flags[-3], "--seq", "32") + ("--reduced",)
    for arch, flags in TRAIN_FLAGS.items()}
TRAIN_FALLBACK_GROUPS = {"seamless-m4t-large-v2": (4, 1)}

# phase 11, the worker mesh and the step builders: (a) the main path's
# (n, k), D, d and C over N ranks that share the card over gloo, MESH_ITERS
# of phase 4's allocations; (b) build_train_step on zamba2-1.2b whole at
# train_4k's 4,096 tokens, its global batch of 256 cut to STEP_TRAIN_BATCH;
# (c) build_prefill_step and build_decode_step on mistral-nemo-12b whole,
# decode_32k's batch of 128 cut to STEP_SERVE_BATCH and its 32,768-token
# context to a STEP_SERVE_PROMPT-token prompt
MESH_ITERS, MESH_TIMEOUT = 10, 600
MESH_SIZE_REDUCED = (4, 3, 6, 360, 16, 3)   # the CPU test's n, k, C, rows, cols, iterations
# (b) takes one step since phase 11 (d) came (two before), and 4 sequences
# since phase 8 serves seven archs (8 before; phase 12 (b) counts the same
# step again), for the script's time; the CPU test's reduced run two.
# (c) takes 8 greedy steps, not 16, since mistral-large-123b came
STEP_TRAIN_ARCH, STEP_TRAIN_BATCH, STEP_TRAIN_STEPS = "zamba2-1.2b", 4, 1
STEP_TRAIN_STEPS_REDUCED = 2
STEP_SERVE_ARCH, STEP_SERVE_BATCH, STEP_SERVE_PROMPT, STEP_SERVE_STEPS = (
    "mistral-nemo-12b", 4, 2_048, 8)
# (d) build_prefill_step and build_decode_step on a MESH_SERVE_SHAPE
# ("data", "model") mesh of spawned ranks sharing the card over gloo, each
# model whole from seed 0 in bfloat16 and in float32 (the same weights,
# upcast): B prompts of P tokens (the encoder-decoder: P frames and P
# tokens), then S steps, against the same calls unsharded on the card.
# float32 logits at F32_HANDOFF_REL of the unsharded float32 run's; the
# bfloat16 run no farther from that float32 run than MESH_BF16_RATIO times
# the unsharded bfloat16 run is, step by step, or within HANDOFF_REL of it:
# on one H100 (NVIDIA H100 80GB HBM3, 700 W) zamba2's unsharded bfloat16
# run is 0.53 of the largest logit from its float32 twin over the 512-token
# prefill and 8 steps with random weights, so no bfloat16 run that sums in
# another order comes within HANDOFF_REL of it (tests/test_torch_mesh_serve_bf16.py
# holds the port's bfloat16 distance from float32 to the JAX package's).
# A first token is not held to the unsharded bfloat16 run's: two bfloat16
# runs that lie as far apart as each lies from float32 (on that H100 zamba2's mesh
# 0.30-0.40 of the largest logit from the unsharded run, the unsharded run
# 0.34-0.50 from float32) agree on a token by the toss of their rounding.
# Each rank's tokens are held to the argmax of its own logits instead (a
# sampler on a local vocabulary shard, or on other logits, fails that)
MESH_SERVE_ARCHS = ("zamba2-1.2b", "seamless-m4t-large-v2", "phi3.5-moe-42b-a6.6b")
# phi3.5-moe at full width (d_model 4,096, 16 experts of d_ff 6,400) and
# two of its 32 layers: each rank draws the model whole in bfloat16 (5.7
# GB at two layers), moves it to the host and upcasts a float32 copy on
# the card (11.5 GB) before it keeps its shard, four ranks at once on one
# 80 GB card (46 GB); three layers would take 65 GB of it
MESH_SERVE_LAYERS = {"phi3.5-moe-42b-a6.6b": 2}
MESH_BF16_RATIO = 1.5
MESH_SERVE_DTYPES = ("float32", "bfloat16")
MESH_SERVE_SHAPE, MESH_SERVE_TIMEOUT = (2, 2), 600
# B, P, S (8 steps before (e)'s witness, 4 before mistral-large-123b came)
MESH_SERVE_TRAFFIC = (4, 512, 2)
MESH_SERVE_TRAFFIC_REDUCED = (4, 16, 4)      # the CPU test's
# (e) build_train_step on the same mesh of spawned ranks: zamba2-1.2b at
# full width and MESH_TRAIN_LAYERS of its 38 layers, drawn as (d) draws it
# (seed 0, bfloat16, upcast to float32),
# train_4k's sequence cut to S and its global batch to B, grad_accum_for's
# microbatches, SGDM at MESH_TRAIN_LR (its step is lr times the gradient,
# where AdamW's first step, g / |g|, turns a float32 reordering of a
# near-zero gradient into a whole ±lr).  Each rank, and the same step
# unsharded in float32, is held to the step unsharded in float64 (the
# witness): the loss and gradient norm within MESH_TRAIN_TOL of the
# witness's (tests/test_torch_mesh_train.py's TOL), every parameter within
# MESH_TRAIN_UPDATE_TOL of the witness's largest update of it, once the
# half float32 ulp of its largest value is allowed for.  The unsharded
# float32 step of the whole model lies 6.1e-4 to 1.02e-3 of the update from
# the witness at 1, 2 or 4 microbatches (examples/torch_train_precision.py;
# NVIDIA H100 80GB HBM3, 700 W): float32 alone does not reach 1e-4 of a gradient summed over
# 4,096 tokens, on the leaves that start at zero (Mamba-2's a_log and
# dt_bias, -lr·g after the step) as on the others
MESH_TRAIN_ARCH, MESH_TRAIN_LR, MESH_TRAIN_TOL = "zamba2-1.2b", 1e-2, 1e-4
MESH_TRAIN_UPDATE_TOL = 2e-3                 # twice the unsharded float32 step's worst
MESH_TRAIN_TRAFFIC = (4, 1_024)              # B, S
MESH_TRAIN_TRAFFIC_REDUCED = (4, 16)         # the CPU test's
MESH_TRAIN_TIMEOUT = 600
# 19 of 38 layers (3 applications of the shared attention block) since
# phase 10 (f) came, for the script's time: whole, (e) took 162 s
# of a 1,145.6 s run on a slow host (NVIDIA H100 80GB HBM3, 700 W)
MESH_TRAIN_LAYERS = 19

# phase 12, the dry-run, the roofline and the cluster demo: (a) cells of
# python -m repro_torch.launch.dryrun, (arch, shape, mesh, REPRO_GRAD_ACCUM
# or 0 for the config's), each a subprocess on the CPU within
# DRYRUN_TIMEOUT, started before phase 10 so that they run on the host's
# idle cores beside phases 10 and 11; the train cell at two microbatches,
# which runs the step's split of the gathered batch, since its eight take
# the dry-run 4-9 minutes on a CPU (the pod sweep of launch.dryrun --all)
DRYRUN_CELLS = (("zamba2-1.2b", "train_4k", "pod", 2),
                ("mistral-nemo-12b", "decode_32k", "pod", 0),
                ("zamba2-1.2b", "decode_32k", "multipod", 0))
DRYRUN_CELLS_REDUCED = (("xlstm-125m", "decode_32k", "pod", 0),)   # the CPU test's
DRYRUN_TIMEOUT = 420
# (c): a kept demo launch against its plain version, its largest error as a
# share of the plain result's largest value (PageRank's first round has
# x = 1/D, entries near 4e-4, where an absolute F32_TOL would pass anything)
DEMO_HELD_REL = 1e-5

KERNELS = {
    "coded_matvec": "src/repro/kernels/coded_matvec.py:54",
    "mds_encode": "src/repro/kernels/mds_encode.py:35",
    "mds_decode": "src/repro/kernels/mds_decode.py:31",
    "lstm_cell": "src/repro/kernels/lstm_cell.py:46",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """Registers and spill stores per kernel, from the build's ``-Xptxas -v``
    lines: the multi design's instantiations one by one, the rest in sum."""
    kernels = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?"
                         r"Used (\d+) registers", log, re.S)
    multi, split = [], []
    for name, spill, regs in kernels:
        m = re.search(r"coded_matvec_multi_kernelI(f|13__nv_bfloat16)Li(\d+)E", name)
        if m:
            multi.append((m[1] != "f", int(m[2]), regs, spill))
        m = re.search(r"coded_matvec_split_kernelI(f|13__nv_bfloat16)E", name)
        if m:
            split.append((m[1] != "f", regs, spill))
    spilled = [name for name, spill, _ in kernels if int(spill)]
    return (f"ptxas: {len(kernels)} kernels, at most "
            f"{max(int(regs) for _, _, regs in kernels)} registers a thread, {len(spilled)} "
            f"with spill stores {spilled}; coded_matvec's multi design: " + "; ".join(
                f"{'bfloat16' if bf16 else 'float32'} NV = {nv}: {regs} registers, {spill} "
                f"bytes spilled" for bf16, nv, regs, spill in sorted(multi))
            + "; its split-row stream: " + "; ".join(
                f"{'bfloat16' if bf16 else 'float32'}: {regs} registers, {spill} bytes spilled"
                for bf16, regs, spill in sorted(split)))


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def host_peak(fn):
    """``fn()``, with the process's resident memory in GB before the call
    and at its peak during it (sampled every 5 ms)."""
    page = os.sysconf("SC_PAGE_SIZE")

    def rss_gb() -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page / 1e9

    start, peak, done = rss_gb(), [0.0], threading.Event()

    def sample():
        while not done.wait(0.005):
            peak[0] = max(peak[0], rss_gb())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        out = fn()
    finally:
        done.set()
        sampler.join()
    return out, (start, max(peak[0], rss_gb()))


def wait_idle(eng, timeout: float = 120.0) -> None:
    """Until every worker of an in-process engine has nothing queued or
    running (a round returns while cancelled stragglers finish a chunk)."""
    deadline = time.monotonic() + timeout
    while not all(w.idle() for w in eng.workers):
        if time.monotonic() > deadline:
            raise RuntimeError("cluster: workers still busy after the rounds")
        time.sleep(0.005)


def cluster_phase(dev, call_ms, timed, compare, in_turns, rows: int) -> tuple[dict, dict]:
    """Phase 5: the cluster engine on the card, over a ``rows`` × d tenant.
    Returns the launches of its in-process rounds per kernel and the record
    of ``coded_matvec``'s multi design."""
    import numpy as np
    import torch

    from repro_torch.cluster import (ClusterConfig, CodedExecutionEngine, NoSlowdown,
                                     SocketTransport, TraceInjector, kernel_backend)
    from repro_torch.cluster.transport import _compute_spec
    from repro_torch.convert import load_params
    from repro_torch.core.predictor import SpeedPredictor
    from repro_torch.core.simulation import calibrate_row_cost
    from repro_torch.core.strategies import GeneralS2C2
    from repro_torch.core.traces import controlled_traces
    from repro_torch.kernels import coded_matvec as cmv
    from repro_torch.kernels import mds_decode as dec
    from repro_torch.kernels import ops
    from repro_torch.kernels.coded_matvec import MAX_NVEC

    rng = np.random.default_rng(3)
    a = rng.standard_normal((rows, COLS), dtype=np.float32)
    a64 = a.astype(np.float64)
    backend = kernel_backend()
    predictor = SpeedPredictor(N, load_params())
    traces = controlled_traces(N, CL_ROUNDS, n_stragglers=2, seed=7)
    eng = CodedExecutionEngine(
        ClusterConfig(n_workers=N, k=K, row_cost=CL_ROW_COST, decode_with_kernel=True),
        injector=TraceInjector(traces), compute=backend, predictor=predictor)
    totals: dict = {}
    multi_launches = 0
    try:
        t0 = time.perf_counter()
        data, rss = host_peak(lambda: eng.load_matrix(a, chunks=CHUNKS))
        encode_s = time.perf_counter() - t0
        rpc = data.rows_per_chunk
        strategy = GeneralS2C2(N, K, rows, chunks=CHUNKS)
        print(f"cluster: tenant {rows} x {COLS}, ({N}, {K}) code, C = {CHUNKS} "
              f"(rpc {rpc}); host float64 encode and install {encode_s:.2f} s, host resident memory "
              f"{rss[0]:.2f} GB before it and {rss[1]:.2f} GB at its peak; coded state "
              f"on the card {N * data.partitions[0].size * 4 / 1e9:.2f} GB", flush=True)

        def run_group(label, widths):
            """Rounds at the given RHS widths (None: matvec), checked, with
            their launches added to ``totals``."""
            wait_idle(eng)
            ops.reset_launch_counts()
            before = backend.cache_info()
            makespans, planned, walls, decodes = [], [], [], []
            worst, with_history = 0.0, 0
            for width in widths:
                x = rng.standard_normal(COLS if width is None else (COLS, width))
                with_history += bool(predictor.history)
                t0 = time.perf_counter()
                out = (eng.matvec(data, x, strategy) if width is None
                       else eng.matmul(data, x, strategy))
                walls.append(time.perf_counter() - t0)
                makespans.append(out.metrics.makespan)
                planned.append(out.metrics.planned_makespan)
                decodes.append(out.metrics.decode_time)
                want = a64 @ x
                if out.y.shape != want.shape or not np.isfinite(out.y).all():
                    raise RuntimeError(f"cluster {label}: y has shape {out.y.shape} or "
                                       "non-finite values")
                err = float(np.abs(out.y - want).max() / np.abs(want).max())
                if err > REL_ERR_LIMIT:
                    raise RuntimeError(f"cluster {label}: relative error {err:.3e} > "
                                       f"{REL_ERR_LIMIT}")
                worst = max(worst, err)
            wait_idle(eng)
            counts, designs = ops.launch_counts(), ops.design_counts()
            info = backend.cache_info()
            chunks = info["x_hits"] + info["x_misses"] - before["x_hits"] - before["x_misses"]
            groups = 1 if widths[0] is None else -(-widths[0] // MAX_NVEC)
            ms = sorted(m * 1e3 for m in makespans)
            print(f"cluster {label}: {len(widths)} round(s); makespan ms median "
                  f"{statistics.median(ms):.3f} (min {ms[0]:.3f}, max {ms[-1]:.3f}); planned "
                  f"ms median {statistics.median(planned) * 1e3:.3f}; host wall ms median "
                  f"{statistics.median(walls) * 1e3:.3f}; decode ms median "
                  f"{statistics.median(decodes) * 1e3:.3f}; worst relative error {worst:.3e}; "
                  f"chunks computed {chunks}; launches {counts}; by design {designs}",
                  flush=True)
            if counts["coded_matvec"] != chunks * groups:
                raise RuntimeError(f"cluster {label}: {counts['coded_matvec']} coded_matvec "
                                   f"launches for {chunks} chunks of {groups} column group(s)")
            # every B = 1 chunk on the stream design, every B > 1 chunk on
            # the multi design, one launch per column group
            design = "stream" if widths[0] is None else "multi"
            want = {name: chunks * groups * (name == design)
                    for name in ("stream", "split", "multi", "general")}
            if designs["coded_matvec"] != want:
                raise RuntimeError(f"cluster {label}: coded_matvec launches by design "
                                   f"{designs['coded_matvec']}, not {want}")
            if counts["mds_decode"] != len(widths):
                raise RuntimeError(f"cluster {label}: mds_decode launched "
                                   f"{counts['mds_decode']} times in {len(widths)} rounds")
            if designs["lstm_cell"] != {"sequence": with_history, "cell": 0}:
                raise RuntimeError(f"cluster {label}: the predictor's launches "
                                   f"{designs['lstm_cell']}, not one sequence launch for "
                                   f"each of {with_history} rounds with history")
            for name, v in counts.items():
                totals[name] = totals.get(name, 0) + v
            return designs["coded_matvec"]["multi"]

        run_group("matvec rounds", [None] * CL_ROUNDS)
        for width in CL_WIDTHS:
            multi_launches += run_group(f"matmul round, B = {width}", [width])

        # a chunk's compute at its shape, beside the time the worker stretches
        # it to at speed 1.0; and its launches, each held against the plain
        # version on the same card tensors: the view of a systematic and of
        # a parity shard with block id 0, one launch per column group, as
        # the backend makes them
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        shards = [torch.as_tensor(data.partitions[w], dtype=torch.float32, device=dev)
                  for w in (0, N - 1)]
        for width in (None,) + CL_WIDTHS:
            x = rng.standard_normal(COLS if width is None else (COLS, width))
            t = call_ms(lambda: backend.compute_chunk(0, data.shard_id, data.partitions[0],
                                                      rpc, 2 * rpc, x))
            x_d = torch.as_tensor(x, dtype=torch.float32, device=dev)
            groups = ([x_d] if width is None else
                      [x_d[:, c:c + MAX_NVEC].contiguous() for c in range(0, width, MAX_NVEC)])
            err = 0.0
            for shard in shards:
                view = shard[rpc:2 * rpc]
                for xg in groups:
                    err = max(err, compare(
                        f"cluster coded_matvec ({rpc}, {COLS}) x {tuple(xg.shape)}",
                        ops.coded_matvec(view, xg, zero, rpc),
                        cmv.coded_matvec_plain(view, xg, zero, rpc), F32_TOL))
            launch = timed(lambda: [ops.coded_matvec(shards[0][rpc:2 * rpc], xg, zero, rpc)
                                    for xg in groups])
            print(f"cluster compute_chunk ({rpc}, {COLS}), B = {width or 1}: call ms {t:.4f} "
                  f"against {rpc * (width or 1) * CL_ROW_COST * 1e3:.1f} ms of a chunk at "
                  f"speed 1.0; its {len(groups)} coded_matvec launch(es): device ms "
                  f"{launch['device_ms']:.4f}, call ms {launch['call_ms']:.4f}; against "
                  f"the plain version max abs err {err:.3e} (tol {F32_TOL})", flush=True)
        multi_record = multi_in_turns(shards[0], rpc, zero, compare, timed, in_turns, rng, dev)
        multi_record.update(launches=multi_launches, cluster_launches=multi_launches)
        del shards
        # the decode of one round at (C, k, k) x rpc·B: the kernel alone on
        # the card, held against the plain version on the same tensors, and
        # the whole host decode (upload, launch, download)
        cov_ids = np.stack([np.sort(rng.choice(N, K, replace=False)) for _ in range(CHUNKS)])
        dms = data.code.decode_submats(cov_ids)
        w_d = torch.as_tensor(dms, dtype=torch.float32, device=dev)
        table = torch.arange(CHUNKS * K, dtype=torch.int32, device=dev).view(CHUNKS, K)
        for width in (None,) + CL_WIDTHS:
            cols = rpc * (width or 1)
            y_parts = rng.standard_normal((CHUNKS, K, cols))
            p_d = torch.as_tensor(y_parts.reshape(CHUNKS * K, cols), dtype=torch.float32,
                                  device=dev)
            buf = torch.empty((K, CHUNKS, cols), device=dev)
            err = compare(f"cluster mds_decode ({CHUNKS}, {K}, {K}) x {cols}",
                          ops.mds_decode_into(w_d, p_d, table, buf.transpose(0, 1)),
                          dec.mds_decode_into_plain(w_d, p_d, table,
                                                    torch.empty_like(buf).transpose(0, 1)),
                          F32_TOL)
            kern = timed(lambda: ops.mds_decode_into(w_d, p_d, table, buf.transpose(0, 1)))
            host = call_ms(lambda: data.decode_compact(
                dms, y_parts if width is None else y_parts.reshape(CHUNKS, K, rpc, width),
                use_kernel=True))
            print(f"cluster decode ({CHUNKS}, {K}, {K}) x {cols}: mds_decode device ms "
                  f"{kern['device_ms']:.4f}, call ms {kern['call_ms']:.4f}; decode_compact "
                  f"(upload, launch, download) call ms {host:.4f}; against the plain version "
                  f"max abs err {err:.3e} (tol {F32_TOL})", flush=True)
        print(f"cluster calibrate_row_cost on the card: {calibrate_row_cost():.3e} s a row "
              f"(the engine's row_cost: {CL_ROW_COST:.0e})", flush=True)
        print(f"cluster backend caches: {backend.cache_info()}", flush=True)
    finally:
        eng.shutdown()
    del backend
    torch.cuda.empty_cache()

    # spawned worker processes, each on the card (the library is built)
    n, k, chunks, rows, d = 4, 2, 4, 4096, 256
    a_p = rng.standard_normal((rows, d)).astype(np.float32).astype(np.float64)
    backend = kernel_backend()
    spec = _compute_spec(backend)
    if spec != f"kernel:{dev.type}:{torch.cuda.current_device()}":
        raise RuntimeError(f"cluster processes: the backend travels as {spec!r}")
    t0 = time.perf_counter()
    eng = CodedExecutionEngine(
        ClusterConfig(n_workers=n, k=k, row_cost=1e-6, starvation_timeout=60.0),
        NoSlowdown(), compute=backend, transport=SocketTransport(connect_timeout=120.0))
    try:
        start_s = time.perf_counter() - t0
        data = eng.load_matrix(a_p, chunks=chunks)
        worst = 0.0
        for _ in range(3):
            x = rng.standard_normal(d)
            y = eng.matvec(data, x, GeneralS2C2(n, k, rows, chunks=chunks)).y
            want = a_p @ x
            err = float(np.abs(y - want).max() / np.abs(want).max())
            if not np.isfinite(y).all() or err > 1e-4:
                raise RuntimeError(f"cluster processes: relative error {err:.3e} > 1e-4")
            worst = max(worst, err)
    finally:
        eng.shutdown()
    print(f"cluster processes: {n} spawned workers ({spec}) started in {start_s:.1f} s; 3 "
          f"rounds, worst relative error {worst:.3e}", flush=True)
    return totals, multi_record


def chaos_demo():
    """``scripts/torch_chaos_demo.py`` as a module, registered under its
    name (its dataclasses need it)."""
    import importlib.util

    if "torch_chaos_demo" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "torch_chaos_demo", ROOT / "scripts" / "torch_chaos_demo.py")
        demo = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = demo
        spec.loader.exec_module(demo)
    return sys.modules["torch_chaos_demo"]


def chaos_part(dev) -> tuple[dict, dict]:
    """Phase 5's last part: ``scripts/torch_chaos_demo.py``'s three fault
    scenarios at seed 0 on the card, at the script's sizes (each raises
    where its property fails).  Returns the master's launches by kernel
    record name, summed over the scenarios (the spawned children's
    ``coded_matvec`` launches are counted in their own processes and not
    read here), and each scenario's record."""
    launches = collections.Counter()
    records = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_") as tmp:
        for name, scenario in chaos_demo().SCENARIOS.items():
            out = scenario(0, str(Path(tmp) / f"{name}.json"), 4, device=dev)
            launches["mds_decode"] += out["launches"]["mds_decode"]
            launches["lstm_cell"] += out["launches"]["lstm_cell"]
            records[name] = out
            print(f"chaos {name}: {out['wall_s']:.1f} s", flush=True)
    return dict(launches), records


def multi_in_turns(shard, rpc, zero, compare, timed, in_turns, rng, dev) -> dict:
    """``coded_matvec``'s multi design against ``torch.matmul`` and the plain
    version, in turns, on a chunk's view of a resident shard (nb = 1) at each
    B of ``MULTI_WIDTHS`` and on the whole shard (nb = 20) at B = 8, beside
    the stream design on the same chunks at B = 1.  Each call takes the next
    of the shard's chunks, so that its rows are not in L2.  Returns the
    record of the chunk at B = 8."""
    import torch

    from repro_torch.kernels import coded_matvec as cmv

    views = [shard[c * rpc:(c + 1) * rpc] for c in range(CHUNKS)]
    turn = [0]

    def view():
        turn[0] = (turn[0] + 1) % CHUNKS
        return views[turn[0]]

    whole = torch.arange(CHUNKS, dtype=torch.int32, device=dev)
    # the same chunks at B = 1 on the stream design: what one launch over a
    # chunk's bytes costs on this card's fastest path
    x1 = torch.as_tensor(rng.standard_normal(COLS), dtype=torch.float32, device=dev)
    stream_b1 = timed(lambda: cmv.coded_matvec_stream(view(), x1, zero, rpc))
    print(f"coded_matvec stream, chunk ({rpc}, {COLS}), nb = 1, B = 1, the same chunks in "
          f"turn: device ms {stream_b1['device_ms']:.4f}, call ms {stream_b1['call_ms']:.4f}",
          flush=True)
    cases = [(f"chunk ({rpc}, {COLS}), nb = 1, B = {b}", b, False) for b in MULTI_WIDTHS]
    cases.append((f"partition ({CHUNKS * rpc}, {COLS}), nb = {CHUNKS}, B = 8", 8, True))
    record = {}
    for label, width, full in cases:
        x = torch.as_tensor(rng.standard_normal((COLS, width)), dtype=torch.float32,
                            device=dev)
        if full:
            versions = {"multi": lambda: cmv.coded_matvec_multi(shard, x, whole, rpc),
                        "torch.matmul": lambda: torch.matmul(shard, x),
                        "plain": lambda: cmv.coded_matvec_plain(shard, x, whole, rpc)}
            rows, ids = CHUNKS * rpc, CHUNKS
            err = compare(f"coded_matvec multi, {label}", versions["multi"](),
                          versions["plain"](), F32_TOL)
        else:
            versions = {"multi": lambda: cmv.coded_matvec_multi(view(), x, zero, rpc),
                        "torch.matmul": lambda: torch.matmul(view(), x),
                        "plain": lambda: cmv.coded_matvec_plain(view(), x, zero, rpc)}
            rows, ids = rpc, 1
            err = max(compare(f"coded_matvec multi, {label}, chunk {c}",
                              cmv.coded_matvec_multi(views[c], x, zero, rpc),
                              cmv.coded_matvec_plain(views[c], x, zero, rpc), F32_TOL)
                      for c in (0, CHUNKS - 1))
        b_ms, b_by = bound_ms(4 * (rows * COLS + COLS * width + rows * width + ids),
                              2 * rows * COLS * width)
        names = list(versions)
        times = in_turns(f"coded_matvec multi, {label}", versions, names + names[::-1])
        best = {name: min(t["device_ms"]) for name, t in times.items()}
        print(f"coded_matvec multi, {label}: bound {b_ms:.4f} ms ({b_by}); best device ms: "
              + ", ".join(f"{name} {t:.4f}" for name, t in best.items())
              + f"; multi at {b_ms / best['multi'] * 100:.1f} % of the bound; max abs err "
              f"against the plain version {err:.3e} (rtol = atol = {F32_TOL})", flush=True)
        if width == 8 and not full:
            call = {name: statistics.median(t["call_ms"]) for name, t in times.items()}
            record = dict(name="coded_matvec (multi design)", route="cuda",
                          source="src/repro_torch/kernels/csrc/coded_matvec.cu",
                          replaces=KERNELS["coded_matvec"], launches=0, max_abs_err=err,
                          ms=best["multi"], plain_ms=best["plain"], bound_ms=b_ms,
                          bound_by=b_by, library_ms=best["torch.matmul"],
                          device_ms=best["multi"], call_ms=call["multi"],
                          plain_device_ms=best["plain"], plain_call_ms=call["plain"],
                          library_device_ms=best["torch.matmul"],
                          library_call_ms=call["torch.matmul"],
                          library=f"torch.matmul on the chunk's view, ({rpc}, {COLS}) @ "
                                  f"({COLS}, 8)", design="multi", shape=label,
                          stream_b1_device_ms=stream_b1["device_ms"])
    return record


# -- 6. the paper's workloads ------------------------------------------------

def expect(label: str, got, want) -> None:
    """Fail the run unless ``got == want``."""
    if got != want:
        raise RuntimeError(f"{label}: {got}, not {want}")


def rel_err(got, want) -> float:
    """The largest error over the largest entry of ``want`` (the error
    itself where ``want`` is 0, as the first iterate's product from w = 0)."""
    diff, scale = (got.double() - want).abs().max(), want.abs().max()
    return float(diff / scale if scale > 0 else diff)


class Forecast:
    """``speeds(it)`` for a workload loop, closing the paper's loop on the
    card: the trained predictor observes iteration it - 1's true speeds,
    then forecasts iteration it's (one sequence launch once it has
    history)."""

    def __init__(self, trained, observed, dev):
        from repro_torch.core.predictor import SpeedPredictor

        self.predictor = SpeedPredictor(N, trained, device=dev)
        self.observed, self.last = observed, None

    def __call__(self, it):
        if it:
            self.predictor.observe(self.observed[it - 1])
        self.last = self.predictor.predict()
        return self.last


class IterClock:
    """``on_iter`` for a workload loop: each iteration's time on the host's
    clock, the card synchronised at both ends, then ``check(it, x, y)``
    outside the timed span."""

    def __init__(self, check):
        self.check, self.ms = check, []
        self.restart()

    def restart(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def __call__(self, it, x, y) -> None:
        import torch

        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - self.t0) * 1e3)
        self.check(it, x, y)
        self.restart()

    def summary(self) -> dict:
        ms = sorted(self.ms)
        return dict(iter_ms_median=statistics.median(ms), iter_ms_min=ms[0], iter_ms_max=ms[-1])


def hold_round(label, cm, a32, coded, x, speeds, design, compare) -> dict:
    """Each kernel of a workload's coded product against its plain version on
    the workload's own card tensors: the encode it ran (``coded``) against
    ``mds_encode_plain`` on the same blocks, then one round's
    ``coded_matvec`` and ``mds_decode_into`` on the tables Algorithm 1
    gives for ``speeds``, with the workload's last iterate ``x`` scaled.
    Returns the largest error by kernel."""
    import torch

    from repro_torch.core.coding import pad_rows
    from repro_torch.core.s2c2 import general_allocation
    from repro_torch.kernels import coded_matvec as cmv
    from repro_torch.kernels import ops
    from repro_torch.kernels.mds_decode import mds_decode_into_plain
    from repro_torch.kernels.mds_encode import mds_encode_plain

    n, rows, d = coded.shape
    rpc, dev = rows // CHUNKS, coded.device
    errs, scale = {}, {}

    def hold(name, label_, got, want):
        errs[name] = compare(f"{label} {label_}", got, want, F32_TOL)
        scale[name] = float(want.abs().max())

    g = torch.as_tensor(cm.code.generator, dtype=torch.float32, device=dev)
    hold("mds_encode", f"mds_encode ({K}, {rows}, {d})", coded,
         mds_encode_plain(g, pad_rows(a32, K * CHUNKS).view(K, rows, d)))
    torch.cuda.empty_cache()
    begin, count, weights, responders = cm.plan_tables(general_allocation(speeds, K, CHUNKS))
    ids, gather = cm.device_tables(begin, count, responders, dev)
    # x at a largest entry of 1, so that the tolerance's absolute part is
    # relative to the product's scale (PageRank's r has entries near 1/n)
    view, x = coded.view(n * rows, d), (x / x.abs().max()).float()
    expect(f"{label}: coded_matvec's design", cmv.design_of(view, x), design)
    parts = ops.coded_matvec(view, x, ids, rpc)
    hold("coded_matvec", f"coded_matvec {design}, nb = {ids.numel()}, br = {rpc}, d = {d}",
         parts, cmv.coded_matvec_plain(view, x, ids, rpc))
    out = torch.empty(K, CHUNKS, rpc, device=dev)
    hold("mds_decode", f"mds_decode_into ({CHUNKS}, {K}, {K}) x {rpc}",
         ops.mds_decode_into(weights, parts, gather, out.transpose(0, 1)),
         mds_decode_into_plain(weights, parts, gather, torch.empty_like(out).transpose(0, 1)))
    print(f"{label}: kernels against their plain versions on the workload's tensors, max abs "
          "err " + ", ".join(f"{name} {e:.3e} (largest entry {scale[name]:.3e})"
                             for name, e in errs.items()) + f" (rtol = atol = {F32_TOL})",
          flush=True)
    return errs


def train_step(dev, compare) -> tuple:
    """(a): the predictor trained on the card from the JAX package's start
    (``convert.INIT_PARAMS``), each epoch one sequence launch under grad,
    held to the JAX package's trained parameters (the committed ones); the
    sequence kernel held to its plain version on the training window; then
    a few epochs all plain on the card and on the CPU, for their time.
    Returns the trained parameters and the step's record."""
    import torch

    from repro_torch.convert import INIT_PARAMS, load_params
    from repro_torch.core.predictor import _adam_update, lstm_apply, mape, train_predictor
    from repro_torch.core.traces import TraceConfig, sample_traces, train_test_split
    from repro_torch.kernels import ops
    from repro_torch.kernels.lstm_cell import lstm_sequence_plain

    traces = sample_traces(TraceConfig(**PRED_TRACES), seed=PRED_SEED)
    train, test = train_test_split(traces)
    start = load_params(INIT_PARAMS, device=dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, metrics = train_predictor(traces, epochs=PRED_EPOCHS, device=dev, init=start)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = ops.design_counts()["lstm_cell"]
    expect("workloads (a): the predictor's launches in training", launches,
           {"sequence": PRED_EPOCHS + 2, "cell": 0})

    def window(arr):
        return (torch.as_tensor(arr[:-1], dtype=torch.float32, device=dev)[:, :, None]
                .contiguous(), torch.as_tensor(arr[1:], dtype=torch.float32, device=dev))

    def test_mape(model) -> float:
        xs, tg = window(test)
        with torch.no_grad():
            return float(mape(lstm_apply(model, xs)[:, :, 0], tg))

    committed_params = load_params(device=dev)
    untrained, committed = test_mape(start), test_mape(committed_params)
    mape_err = abs(metrics["test_mape"] - committed) / committed
    param_err = max(float((p.detach() - q.detach()).abs().max()) for p, q in
                    zip(params.parameters(), committed_params.parameters()))
    if not metrics["test_mape"] < untrained or mape_err > PRED_MAPE_RTOL:
        raise RuntimeError(f"workloads (a): test MAPE {metrics['test_mape']:.6f} after training "
                           f"from the JAX package's start; its own training gives "
                           f"{committed:.6f} (relative {mape_err:.3e} > {PRED_MAPE_RTOL}), "
                           f"untrained {untrained:.6f}")
    xs_tr, tg_tr = window(train)
    named = [params.w_ih, params.w_hh, params.b, params.w_out, params.b_out]
    with torch.no_grad():
        seq_err = compare(f"workloads (a) lstm_cell sequence, the training window (T = "
                          f"{xs_tr.shape[0]}, B = {xs_tr.shape[1]})",
                          ops.lstm_sequence(xs_tr, *named), lstm_sequence_plain(xs_tr, *named),
                          F32_TOL)

    # a few epochs from the same start with lstm_sequence_plain forward and
    # backward, on the card and on the CPU: what a backward kernel would save
    def all_plain(device) -> float:
        model = load_params(INIT_PARAMS, device=device)
        opt = tuple({n: torch.zeros_like(p)
                     for n, p in model.named_parameters()} for _ in range(2))
        xs, tg = xs_tr.to(device), tg_tr.to(device)
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(PLAIN_EPOCHS):
            named_p = dict(model.named_parameters())
            loss = torch.mean((lstm_sequence_plain(xs, *named_p.values())[:, :, 0] - tg) ** 2)
            grads = dict(zip(named_p, torch.autograd.grad(loss, list(named_p.values()))))
            model, opt = _adam_update(model, grads, opt, step)
        float(loss.detach())
        return (time.perf_counter() - t0) / PLAIN_EPOCHS * 1e3

    rec = dict(train_s=train_s, epoch_ms=train_s / PRED_EPOCHS * 1e3,
               plain_card_epoch_ms=all_plain(dev), plain_cpu_epoch_ms=all_plain("cpu"),
               plain_epochs=PLAIN_EPOCHS, untrained_test_mape=untrained,
               committed_test_mape=committed, test_mape_err=mape_err, param_err=param_err,
               sequence_err=seq_err, launches=launches, **metrics)
    print(f"workloads (a) predictor training, {PRED_EPOCHS} epochs over ({len(traces)}, "
          f"{traces.shape[1]}) traces (T = {len(train) - 1}, B = {traces.shape[1]}) from the JAX "
          f"package's start: kernel forward, plain backward on the card {train_s:.2f} s "
          f"({rec['epoch_ms']:.2f} ms an epoch, the two evaluations included); all plain over "
          f"{PLAIN_EPOCHS} epochs: {rec['plain_card_epoch_ms']:.2f} ms an epoch on the card, "
          f"{rec['plain_cpu_epoch_ms']:.2f} ms on the CPU; final train loss "
          f"{metrics['final_train_loss']:.7f}; test MAPE {metrics['test_mape']:.6f} (the JAX "
          f"package's training {committed:.6f}, relative {mape_err:.3e}, tol {PRED_MAPE_RTOL}; "
          f"parameters {param_err:.3e} from its; untrained {untrained:.4f}; last value "
          f"{metrics['last_value_test_mape']:.4f}); launches {launches}", flush=True)
    return params, rec


def regression_step(dev, trained, compare) -> tuple:
    """(b): logistic regression and the SVM by ``coded_gradient_descent``,
    A·w coded through ``CodedMatvec`` and planned from the trained
    predictor, Aᵀ·g a float32 ``torch.matmul``; every iteration's coded A·w
    held to the float64 product, each descent to the same one in float64
    on the card, and the kernels to their plain versions on the data.
    Returns the first rows of the data, the logistic weights and the last
    forecast, for (e), and the step's record."""
    import torch

    from repro_torch.core.coded_matmul import CodedMatvec
    from repro_torch.core.coding import MDSCode
    from repro_torch.core.traces import controlled_traces
    from repro_torch.data.pipeline import make_lr_dataset
    from repro_torch.kernels import ops
    from repro_torch.workloads import coded_gradient_descent, gd_gradient

    t0 = time.perf_counter()
    (a_np, y_np, _), rss = host_peak(lambda: make_lr_dataset(rows=LR_ROWS, cols=LR_COLS,
                                                             seed=0))
    make_s = time.perf_counter() - t0
    keep = (a_np[:GC_BATCH].copy(), y_np[:GC_BATCH].copy())
    a64 = torch.from_numpy(a_np).to(dev)
    del a_np
    a32, y64 = a64.float(), torch.from_numpy(y_np).to(dev)
    y32 = y64.float()
    ops.reset_launch_counts()
    cm = CodedMatvec(MDSCode(N, K), CHUNKS, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coded = cm.shard(a32)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    traces = controlled_traces(N, LR_ITERS, n_stragglers=1, seed=3)
    step = LR_STEP / LR_ROWS
    rec, forecast, w_logistic, worst_ax = {}, None, None, 0.0

    def hinge_objective(w_) -> float:
        """What the SVM's descent minimises, in float64."""
        w_ = w_.double()
        return float(torch.clamp(1 - y64 * (a64 @ w_), min=0).sum() + 0.5e-3 * (w_ @ w_))

    def check_ax(it, w_, ax):
        nonlocal worst_ax
        err = rel_err(ax, a64 @ w_.double())
        if not err <= REL_ERR_LIMIT:
            raise RuntimeError(f"workloads (b) iteration {it}: coded A·w {err:.3e} from float64 "
                               f"> {REL_ERR_LIMIT}")
        worst_ax = max(worst_ax, err)

    for loss in ("logistic", "hinge"):
        speeds = Forecast(trained, traces, dev)
        clock = IterClock(check_ax)
        w = coded_gradient_descent(cm, coded, a32, y32, loss, LR_ITERS, speeds, lr=LR_STEP,
                                   on_iter=clock)
        # the same descent uncoded, in float64 and in float32
        w64 = torch.zeros(LR_COLS, dtype=torch.float64, device=dev)
        w32 = torch.zeros(LR_COLS, device=dev)
        for it in range(LR_ITERS):
            w64 = w64 - step * gd_gradient(loss, a64, y64, w64, a64 @ w64)
            w32 = w32 - step * gd_gradient(loss, a32, y32, w32, a32 @ w32)
        if not torch.isfinite(w).all():
            raise RuntimeError(f"workloads (b) {loss}: non-finite weights")
        err, err32 = rel_err(w, w64), rel_err(w32, w64)
        acc = float(((a32 @ w > 0) * 2 - 1 == y32).float().mean())
        acc64 = float(((a64 @ w64 > 0) * 2 - 1 == y64).double().mean())
        if not acc > 0.8 or abs(acc - acc64) > 0.005:
            raise RuntimeError(f"workloads (b) {loss}: accuracy {acc:.4f} (float64 "
                               f"{acc64:.4f}; need > 0.8 and within 0.005)")
        # the hinge's subgradient jumps where a margin crosses 1, and float32
        # margins cross it elsewhere than float64 ones: the SVM is held to
        # its objective, the logistic loss to its weights
        obj = obj64 = obj_err = None
        if loss == "logistic" and err > 1e-3:
            raise RuntimeError(f"workloads (b) logistic: w against float64 {err:.3e} > 1e-3")
        if loss == "hinge":
            obj, obj64 = hinge_objective(w), hinge_objective(w64)
            obj_err = abs(obj - obj64) / obj64
            if obj_err > SVM_OBJECTIVE_RTOL:
                raise RuntimeError(f"workloads (b) hinge: objective {obj:.6f} against float64 "
                                   f"{obj64:.6f}, relative {obj_err:.3e} > {SVM_OBJECTIVE_RTOL}")
        rec[loss] = dict(err=err, err_uncoded_float32=err32, accuracy=acc, accuracy64=acc64,
                         objective=obj, objective64=obj64, objective_err=obj_err,
                         **clock.summary())
        print(f"workloads (b) {loss}: {LR_ITERS} coded iterations, median "
              f"{rec[loss]['iter_ms_median']:.3f} ms (min {rec[loss]['iter_ms_min']:.3f}, max "
              f"{rec[loss]['iter_ms_max']:.3f}); w against float64 {err:.3e} (uncoded float32: "
              f"{err32:.3e}); accuracy {acc:.4f} (float64 {acc64:.4f})"
              + ("" if obj is None else f"; objective {obj:.6f}, float64 {obj64:.6f}, relative "
                 f"{obj_err:.3e} (tol {SVM_OBJECTIVE_RTOL})"), flush=True)
        if loss == "logistic":
            forecast, w_logistic = speeds.last, w
    counts, designs = ops.launch_counts(), ops.design_counts()
    expect("workloads (b): launches", {n: counts[n] for n in ("coded_matvec", "mds_decode",
                                                              "mds_encode")},
           {"coded_matvec": 2 * LR_ITERS, "mds_decode": 2 * LR_ITERS, "mds_encode": 1})
    expect("workloads (b): coded_matvec launches by design", designs["coded_matvec"],
           {"stream": 2 * LR_ITERS, "split": 0, "multi": 0, "general": 0})
    expect("workloads (b): the predictor's launches", designs["lstm_cell"],
           {"sequence": 2 * (LR_ITERS - 1), "cell": 0})
    rec.update(make_s=make_s, host_gb=rss, encode_ms=encode_s * 1e3, launches=counts,
               ax_err=worst_ax, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    rec["kernel_errs"] = hold_round("workloads (b)", cm, a32, coded, w_logistic, forecast,
                                    "stream", compare)
    print(f"workloads (b): make_lr_dataset({LR_ROWS}, {LR_COLS}) {make_s:.1f} s, host resident "
          f"memory {rss[0]:.2f} GB before it and {rss[1]:.2f} GB at its peak; encode "
          f"{encode_s * 1e3:.3f} ms; coded state {coded.numel() * 4 / 1e9:.2f} GB; card peak "
          f"{rec['peak_gb']:.1f} GB; every coded A·w within {worst_ax:.3e} of float64; "
          f"launches {counts}, by design {designs}", flush=True)
    return keep, w_logistic, forecast, rec


def gradient_code_step(dev, keep, w, forecast) -> dict:
    """(e): the logistic gradient over a batch of the (b) data, partitioned
    by ``balanced_part_sizes`` from the (b) forecast, each group's coded
    gradient from ``encode_local`` on the card, decoded from live sets of
    n - s groups."""
    import numpy as np
    import torch

    from repro_torch.core.gradient_coding import CyclicGradientCode

    gc = CyclicGradientCode(n=N, s=GC_S)
    sizes = gc.balanced_part_sizes(np.asarray(forecast), GC_BATCH)
    edges = np.concatenate([[0], np.cumsum(sizes)])
    a64 = torch.from_numpy(keep[0]).to(dev)
    y64 = torch.from_numpy(keep[1]).to(dev)
    a32, y32 = a64.float(), y64.float()

    def logistic_grad(a, y, w_):
        return a.T @ (-y / (1 + torch.exp(y * (a @ w_))))

    parts = torch.stack([logistic_grad(a32[lo:hi], y32[lo:hi], w)
                         for lo, hi in zip(edges[:-1], edges[1:])])
    coded = torch.stack([gc.encode_local(parts[gc.window(g)], g) for g in range(N)])
    want = logistic_grad(a64, y64, w.double())
    rng = np.random.default_rng(5)
    worst, live_sets = 0.0, []
    while len(live_sets) < GC_LIVE_SETS:
        dead = set(rng.choice(N, GC_S, replace=False).tolist())
        live = [g for g in range(N) if g not in dead]
        if live in live_sets:
            continue
        live_sets.append(live)
        wts = torch.as_tensor(gc.decode_weights(live), device=dev)
        got = (wts[:, None] * coded.double()).sum(0)
        err = rel_err(got, want)
        if not torch.isfinite(got).all() or err > 1e-3:
            raise RuntimeError(f"workloads (e): decode from {live}: error {err:.3e} > 1e-3")
        worst = max(worst, err)
    print(f"workloads (e) gradient coding: CyclicGradientCode({N}, {GC_S}) over {GC_BATCH} rows "
          f"in partitions of {sizes.tolist()} rows; {len(live_sets)} live sets "
          f"{live_sets}: worst error {worst:.3e}", flush=True)
    return dict(sizes=sizes.tolist(), live_sets=live_sets, err=worst)


def split_in_turns(label, coded, rpc, d, compare, in_turns, dev) -> dict:
    """``coded_matvec``'s split-row stream on a workload's coded state, k·C
    blocks of rpc rows, in turns (new, old, old, new) with the general
    design reached directly on the same operands, ``torch.matmul`` on the
    same rows gathered beforehand and the plain version."""
    import torch

    from repro_torch.kernels import coded_matvec as cmv

    gen = torch.Generator(device=dev).manual_seed(8)
    a = coded.view(-1, d)
    ids = torch.randperm(N * CHUNKS, generator=gen, device=dev)[: K * CHUNKS].to(torch.int32)
    x = torch.randn(d, generator=gen, device=dev)
    nb = ids.numel()
    sel = a.view(N * CHUNKS, rpc, d)[ids.long()].reshape(-1, d)
    if cmv.design_of(a, x) != "split":
        raise RuntimeError(f"{label}: the shape does not take the split design")
    want = cmv.coded_matvec_plain(a, x, ids, rpc)
    err = compare(f"coded_matvec split, {label}", cmv.coded_matvec_split(a, x, ids, rpc), want,
                  F32_TOL)
    old_err = compare(f"coded_matvec general, {label}", cmv.coded_matvec_general(a, x, ids, rpc),
                      want, F32_TOL)
    del want
    lib_name = "torch.matmul on pre-gathered rows"
    versions = {"split": lambda: cmv.coded_matvec_split(a, x, ids, rpc),
                "general": lambda: cmv.coded_matvec_general(a, x, ids, rpc),
                lib_name: lambda: torch.matmul(sel, x),
                "plain": lambda: cmv.coded_matvec_plain(a, x, ids, rpc)}
    names = list(versions)
    times = in_turns(f"coded_matvec split, {label}", versions, names + names[::-1])
    best = {name: min(t["device_ms"]) for name, t in times.items()}
    call = {name: statistics.median(t["call_ms"]) for name, t in times.items()}
    b_ms, b_by = bound_ms(4 * (nb * rpc * d + d + nb + nb * rpc), 2 * nb * rpc * d)
    lib = best[lib_name]
    print(f"coded_matvec split, {label}: bound {b_ms:.4f} ms ({b_by}); best device ms: "
          + ", ".join(f"{name} {t:.4f}" for name, t in best.items())
          + f"; split at {b_ms / best['split'] * 100:.1f} % of the bound, "
          f"{best['split'] / lib:.3f}x torch.matmul, general at "
          f"{b_ms / best['general'] * 100:.1f} %; max abs err {err:.3e}, general "
          f"{old_err:.3e} (tol {F32_TOL})", flush=True)
    return dict(name=f"coded_matvec (split design, {label})", route="cuda",
                source="src/repro_torch/kernels/csrc/coded_matvec.cu",
                replaces=KERNELS["coded_matvec"], launches=0, max_abs_err=err,
                ms=best["split"], plain_ms=best["plain"], bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, device_ms=best["split"], call_ms=call["split"],
                plain_device_ms=best["plain"], plain_call_ms=call["plain"],
                library_device_ms=lib, library_call_ms=call[lib_name],
                library=f"{lib_name}, ({nb * rpc}, {d}) @ ({d},)",
                old_ms=best["general"], old_call_ms=call["general"], old="general design",
                design="split", shape=f"({N * CHUNKS * rpc}, {d}) float32, nb = {nb}, "
                                      f"br = {rpc}")


def graph_step(dev, trained, compare, in_turns) -> tuple:
    """(c): ``pagerank`` and a 3-hop ``graph_filter``, each matvec coded and
    planned from the trained predictor, every iteration's coded product
    held to the float64 one and the result to the float64 iteration on the
    card, the kernels to their plain versions on the data; the split
    design timed at both shapes.  Returns the split design's two records
    and the step's record."""
    import numpy as np
    import torch

    from repro_torch.core.coded_matmul import CodedMatvec
    from repro_torch.core.coding import MDSCode
    from repro_torch.core.traces import controlled_traces
    from repro_torch.data.pipeline import laplacian_matrix, make_graph
    from repro_torch.kernels import ops
    from repro_torch.workloads import graph_filter, pagerank

    def build():
        adj = make_graph(PR_NODES, PR_DEGREE, seed=1)
        col = adj.sum(0, keepdims=True)
        m = adj / np.maximum(col, 1)
        m[:, col[0] == 0] = 1.0 / PR_NODES          # dangling columns: uniform
        return m, laplacian_matrix(adj[:FILTER_NODES, :FILTER_NODES])

    t0 = time.perf_counter()
    (m_np, lap_np), rss = host_peak(build)
    make_s = time.perf_counter() - t0
    traces = controlled_traces(N, PR_ITERS, n_stragglers=2, seed=7)
    cm = CodedMatvec(MDSCode(N, K), CHUNKS, device=dev)
    rec, split, launches = {}, [], {}
    for name, mat_np, n_it in (("pagerank", m_np, PR_ITERS), ("filter", lap_np, FILTER_HOPS)):
        ops.reset_launch_counts()
        n = mat_np.shape[0]
        m64 = torch.from_numpy(mat_np).to(dev)
        m32 = m64.float()
        coded = cm.shard(m32)
        rpc = coded.shape[1] // CHUNKS
        speeds = Forecast(trained, traces, dev)
        ref = {"x64": None, "worst": 0.0}

        def check(it, x_, y_):
            """The coded product against float64 on the same input; the
            float64 iteration advanced beside it."""
            err = rel_err(y_, m64 @ x_.double())
            if not err <= REL_ERR_LIMIT:
                raise RuntimeError(f"workloads (c) {name} iteration {it}: coded product "
                                   f"{err:.3e} from float64 > {REL_ERR_LIMIT}")
            ref["worst"] = max(ref["worst"], err)
            x64 = x_.double() if ref["x64"] is None else ref["x64"]
            ref["x64"] = ((1 - PR_DAMPING) / n + PR_DAMPING * (m64 @ x64) if name == "pagerank"
                          else m64 @ x64)

        clock = IterClock(check)
        if name == "pagerank":
            x = pagerank(cm, coded, n, n_it, speeds, damping=PR_DAMPING, on_iter=clock)
        else:
            x0 = torch.as_tensor(np.random.default_rng(0).standard_normal(n), device=dev)
            ref["x64"] = x0
            clock.restart()
            x = graph_filter(cm, coded, x0, n_it, speeds, on_iter=clock)
        if not torch.isfinite(x).all():
            raise RuntimeError(f"workloads (c) {name}: non-finite values")
        err = rel_err(x, ref["x64"])
        if err > 1e-4:
            raise RuntimeError(f"workloads (c) {name}: error {err:.3e} > 1e-4")
        counts, designs = ops.launch_counts(), ops.design_counts()
        expect(f"workloads (c) {name}: launches",
               {k_name: counts[k_name] for k_name in ("coded_matvec", "mds_decode", "mds_encode")},
               {"coded_matvec": n_it, "mds_decode": n_it, "mds_encode": 1})
        expect(f"workloads (c) {name}: coded_matvec launches by design",
               designs["coded_matvec"], {"stream": 0, "split": n_it, "multi": 0, "general": 0})
        expect(f"workloads (c) {name}: the predictor's launches", designs["lstm_cell"],
               {"sequence": n_it - 1, "cell": 0})
        for k_name, v in counts.items():
            launches[k_name] = launches.get(k_name, 0) + v
        rec[name] = dict(n=n, err=err, product_err=ref["worst"], **clock.summary())
        print(f"workloads (c) {name}: ({n}, {n}) float32, coded ({N}, {coded.shape[1]}, {n}) "
              f"{coded.numel() * 4 / 1e9:.2f} GB; {n_it} coded iterations, median "
              f"{rec[name]['iter_ms_median']:.3f} ms (min {rec[name]['iter_ms_min']:.3f}, max "
              f"{rec[name]['iter_ms_max']:.3f}); error {err:.3e}, every coded product within "
              f"{ref['worst']:.3e} of float64; launches {counts}, by design {designs}",
              flush=True)
        rec[name]["kernel_errs"] = hold_round(f"workloads (c) {name}", cm, m32, coded, x,
                                              speeds.last, "split", compare)
        split.append(split_in_turns(name, coded, rpc, n, compare, in_turns, dev))
        split[-1]["launches"] = counts["coded_matvec"]
        del m64, m32, coded
        torch.cuda.empty_cache()
    expect("workloads (c): launches", {k_name: launches[k_name]
                                       for k_name in ("coded_matvec", "mds_decode")},
           {"coded_matvec": PR_ITERS + FILTER_HOPS, "mds_decode": PR_ITERS + FILTER_HOPS})
    del m_np, lap_np
    rec.update(make_s=make_s, host_gb=rss, launches=launches)
    print(f"workloads (c): make_graph({PR_NODES}, {PR_DEGREE}), the transition matrix and the "
          f"Laplacian {make_s:.1f} s, host resident memory {rss[0]:.2f} GB before and "
          f"{rss[1]:.2f} GB at the peak; launches {rec['launches']}", flush=True)
    return split, rec


def hessian_step(dev, call_ms) -> dict:
    """(d): the Hessian AᵀDA on a polynomial code, decoded from 9 of its 12
    nodes, held to the float64 product on the card."""
    import torch

    from repro_torch.core.polynomial import PolynomialCode

    pc = PolynomialCode(n=N, a=3, b=3)
    gen = torch.Generator(device=dev).manual_seed(4)
    a = torch.randn(HESSIAN, HESSIAN, generator=gen, device=dev)
    diag = torch.rand(HESSIAN, generator=gen, device=dev) + 0.5     # uniform in [0.5, 1.5]
    got = pc.full_product(a, a, diag, nodes=POLY_NODES)
    a64 = a.double()
    want = a64.T @ (diag.double()[:, None] * a64)
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"workloads (d): shape {tuple(got.shape)} or non-finite values")
    err = rel_err(got, want)
    if err > 1e-3:
        raise RuntimeError(f"workloads (d): Hessian error {err:.3e} > 1e-3")
    coded_ms = call_ms(lambda: pc.full_product(a, a, diag, nodes=POLY_NODES))
    f64_ms = call_ms(lambda: a64.T @ (diag.double()[:, None] * a64))
    print(f"workloads (d) Hessian AᵀDA, ({HESSIAN}, {HESSIAN}) float32, PolynomialCode({N}, "
          f"3, 3) from nodes {POLY_NODES}: {coded_ms:.3f} ms a product (encode, 9 node "
          f"products, decode); float64 on the card {f64_ms:.3f} ms; error {err:.3e}",
          flush=True)
    return dict(err=err, ms=coded_ms, float64_ms=f64_ms)


def workloads_phase(dev, call_ms, compare, in_turns) -> tuple:
    """Phase 6.  Returns the split design's records, the launches over the
    phase's workloads by record name (``coded_matvec``: the stream design's),
    and the phase's record."""
    import torch

    from repro_torch.kernels import ops

    trained, rec_a = train_step(dev, compare)
    torch.cuda.reset_peak_memory_stats()
    keep, w, forecast, rec_b = regression_step(dev, trained, compare)
    torch.cuda.empty_cache()
    rec_e = gradient_code_step(dev, keep, w, forecast)
    del keep, w
    torch.cuda.empty_cache()
    split, rec_c = graph_step(dev, trained, compare, in_turns)
    rec_d = hessian_step(dev, call_ms)
    torch.cuda.empty_cache()
    launches = {name: rec_b["launches"].get(name, 0) + rec_c["launches"].get(name, 0)
                for name in ops.launch_counts()}
    launches["lstm_cell"] += sum(rec_a["launches"].values())
    # coded_matvec by design: (b) all stream, (c) all split
    launches["coded_matvec (multi design)"] = 0
    launches["coded_matvec"] = rec_b["launches"]["coded_matvec"]
    for rec in split:
        launches[rec["name"]] = rec["launches"]
    return split, launches, dict(train=rec_a, regression=rec_b, graph=rec_c, hessian=rec_d,
                                   gradient_code=rec_e)

# -- 7. serving a dense LM at full width ------------------------------------

def decode_step_bound(model, b: int, pos: int, expert_share: float = 1.0,
                      enc_len: int = 0) -> tuple:
    """The least time one decode step of ``b`` tokens at position ``pos``
    takes on ``model``: every weight of the decoder read once (b rows of
    the embedding table, all of it where it is the tied head; of the
    experts' weights, ``expert_share``; an encoder-decoder's encoder,
    ``frontend_proj`` and a VLM's ``projector`` not at all), every
    self-attention application's valid K/V read (a local layer's window
    of it at most) and one position written,
    an encoder-decoder's cross K/V of ``enc_len`` positions read in every
    layer, each recurrent state read and written, the logits written;
    against the bfloat16 peak for 2 operations a weight a token (k of E
    experts a token).  Returns (ms, "bytes" or "operations")."""
    cfg = model.cfg
    item = model.cache_dtype().itemsize
    n_bytes = b * cfg.d_model * item + b * cfg.padded_vocab * 4
    ops_params = 0.0
    for name, p in model.named_parameters():
        if (name == "embed.embedding" and not cfg.tie_embeddings) or name.split(".")[0] in (
                "frontend_proj", "projector", "enc", "enc_norm"):
            continue
        expert = ".moe.w" in name
        n_bytes += p.numel() * p.dtype.itemsize * (expert_share if expert else 1.0)
        ops_params += p.numel() * (cfg.experts_per_token / cfg.num_experts if expert else 1.0)
    caches = model.init_cache(b, 1, 1) if cfg.is_encdec else model.init_cache(b, 1)
    attn_kinds = ("attn", "shared", "self")
    attn = sum(1 for entry in caches for kind in entry if kind in attn_kinds)
    local = sum(1 for slot in getattr(model, "slots", ())
                if slot.local and slot.kind in ("attn_mlp", "attn_moe"))
    # positions a self-attention application reads: all, or its window's
    seen = (attn - local) * (pos + 1) + local * min(pos + 1, cfg.sliding_window)
    cross = sum(1 for entry in caches if "cross" in entry)
    kv = 2 * b * cfg.kv_dim * item
    states = sum(t.numel() * t.element_size() for entry in caches
                 for kind, state in entry.items() if kind not in attn_kinds + ("cross",)
                 for t in state.values())
    n_bytes += kv * (seen + attn) + cross * kv * enc_len + 2 * states
    flops = 2 * b * ops_params + 4 * b * cfg.q_dim * (seen + cross * enc_len)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def device_kernel_ms(fn, steps: int) -> tuple:
    """Device time of the kernels ``fn`` launches, from ``torch.profiler``,
    over ``steps`` calls after one more that the profiler runs but does not
    count (a profile's first kernels can miss its record: on one H100 two
    counted xlstm-125m steps read 516 launches a step, five 575): (busy ms a
    call, host ms a call, kernel launches a call, the top kernels), or None
    where the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for i in range(steps):
            fn()
            if i == steps - 1:              # the counted steps end on the card first
                torch.cuda.synchronize()
            prof.step()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def own(e) -> float:
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy_us = sum(own(e) for e in kernels)
    if not busy_us:
        return None
    top = sorted(kernels, key=own, reverse=True)[:6]
    return (busy_us / 1e3 / steps, host_ms, sum(e.count for e in kernels) / steps,
            [(e.key[:60], e.count // steps, own(e) / 1e3 / steps) for e in top])


def smoke_requests(cfg) -> list:
    """The JAX package's serving defaults as ``launch.serve.run`` draws them
    from seed 0: 6 requests of 8-token prompts, 8 new tokens each."""
    import numpy as np

    from repro_torch.runtime.serve_loop import Request

    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, size=8).astype(np.int32),
                    max_new=8) for i in range(6)]


def clocked_serve(model, dev, label: str) -> tuple:
    """Serve the smoke requests (max_batch 4) with each decode step between
    CUDA events.  Returns (tokens by rid, seconds on the host's clock,
    [(batch, position, ms)]); fails unless each request got 8 tokens of
    the vocabulary."""
    import torch

    from repro_torch.runtime.serve_loop import ServeConfig, serve

    cfg = model.cfg
    steps = []
    decode_step = model.decode_step

    def clocked(token, caches, pos):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = decode_step(token, caches, pos)
        end.record()
        steps.append((token.shape[0], pos, start, end))
        return out

    model.decode_step = clocked
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve(model, smoke_requests(cfg), ServeConfig(max_batch=4), device=dev)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    finally:
        del model.decode_step
    if sorted(out) != list(range(6)) or any(
            len(v) != 8 or not all(0 <= t < cfg.padded_vocab for t in v) for v in out.values()):
        raise RuntimeError(f"{label}: serve returned {out}")
    return out, serve_s, [(b, pos, s.elapsed_time(e)) for b, pos, s, e in steps]


def short_context_busy(model, dev, warm=None):
    """``device_kernel_ms`` of PROFILED_STEPS decode steps at B = 4 and a
    context of at most 16, after 3 steps outside the profiler (run inside
    the context manager ``warm`` where one is given)."""
    import contextlib

    import numpy as np
    import torch

    caches = model.init_cache(4, 16)
    tok = torch.as_tensor(np.arange(1, 5)[:, None], device=dev)
    pos = iter(range(16))
    with warm or contextlib.nullcontext():
        for _ in range(3):
            model.decode_step(tok, caches, next(pos))
    return device_kernel_ms(lambda: model.decode_step(tok, caches, next(pos)), PROFILED_STEPS)


def long_context_decode(model, dev, label: str, context: int = LONG_CONTEXT,
                        image_embeds=None) -> dict:
    """LONG_BATCH prompts of ``context`` tokens (after ``image_embeds``,
    where given, through the VLM's projector) through ``LM.prefill``, then
    LONG_STEPS greedy decode steps, each between CUDA events, then
    PROFILED_STEPS under the profiler; fails where the logits are not
    finite.  Returns prefill_s, step_ms, decode_s, busy (``device_kernel_ms``'s
    tuple or None), and the caches, last token and next position, for a
    caller that goes on."""
    import numpy as np
    import torch

    cfg = model.cfg
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (LONG_BATCH, context)), device=dev)
    if image_embeds is not None:
        context += image_embeds.shape[1]            # the positions the prefill fills
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(toks, image_embeds=image_embeds,
                                   max_seq=context + LONG_STEPS + PROFILED_STEPS + 4)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cur = torch.argmax(logits, -1)[:, None]
    long_steps = []
    t0 = time.perf_counter()
    for i in range(LONG_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, caches = model.decode_step(cur, caches, context + i)
        end.record()
        long_steps.append((start, end))
        cur = torch.argmax(logits, -1)[:, None]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if not torch.isfinite(logits).all():
        raise RuntimeError(f"{label}: a decode step at a context of "
                           f"{context} gave logits that are not finite")
    pos = iter(range(context + LONG_STEPS, context + LONG_STEPS + PROFILED_STEPS + 1))
    busy = device_kernel_ms(lambda: model.decode_step(cur, caches, next(pos)), PROFILED_STEPS)
    return dict(prefill_s=prefill_s, step_ms=[s_.elapsed_time(e_) for s_, e_ in long_steps],
                decode_s=decode_s, busy=busy, caches=caches, token=cur,
                pos=context + LONG_STEPS + PROFILED_STEPS + 1)


def hold_coded_head(label: str, head, dev, compare) -> dict:
    """The coded lm_head of ``head`` (d × V, float32) as ``launch.serve``
    runs it: a (6, 4) code, 8 chunks, the logits of x (2, d) under
    SERVE_SPEEDS, with exactly one ``mds_encode``, one multi-design
    ``coded_matvec`` and one ``mds_decode`` launched and the logits within
    REL_ERR_LIMIT of float64; then each launch held against its plain
    version on the same tensors at F32_TOL.  The float64 product and the
    plain versions are taken a slab at a time (HEAD_SLAB columns, one
    chunk's rows, four blocks), so that nemotron's head (18.9 GB in
    float32, its coded partitions 28.3 GB) is held on one card.  Returns
    the measurements and the tensors, by name."""
    import numpy as np
    import torch

    from repro_torch.core.coding import pad_rows
    from repro_torch.core.s2c2 import general_allocation
    from repro_torch.kernels import coded_matvec as cmv
    from repro_torch.kernels import ops
    from repro_torch.kernels.mds_decode import mds_decode_into_plain
    from repro_torch.kernels.mds_encode import mds_encode_plain
    from repro_torch.runtime.serve_loop import CodedLMHead

    d, vocab = head.shape
    speeds = np.array(SERVE_SPEEDS)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((2, d)),
                        dtype=torch.float32, device=dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ch = CodedLMHead(head, n=6, k=4, chunks=8, device=dev)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    got = ch.logits(x, speeds)
    torch.cuda.synchronize()
    counts, designs = ops.launch_counts(), ops.design_counts()["coded_matvec"]
    expect(f"{label}: the coded head's launches (one encode, one logits call)", counts,
           {"coded_matvec": 1, "mds_encode": 1, "mds_decode": 1, "lstm_cell": 0})
    expect(f"{label}: the coded head's coded_matvec design", designs,
           {"stream": 0, "split": 0, "multi": 1, "general": 0})
    want = torch.cat([x.double() @ head[:, c:c + HEAD_SLAB].double()
                      for c in range(0, vocab, HEAD_SLAB)], 1)
    head_err = rel_err(got, want)
    del want
    if not (got.shape == (2, vocab) and head_err <= REL_ERR_LIMIT):
        raise RuntimeError(f"{label}: coded head {tuple(got.shape)}, error {head_err:.3e}")
    torch.cuda.empty_cache()
    n_, rows, _ = ch.coded.shape
    rpc = rows // 8
    g = torch.as_tensor(ch.code.generator, dtype=torch.float32, device=dev)
    blocks = pad_rows(head.T, 4 * 8).unflatten(0, (4, rows))      # a view of the head
    errs = {"mds_encode": max(
        compare(f"{label}: lm_head mds_encode (6, 4) x (4, {rows}, {d}), rows {r0}-{r0 + rpc}",
                ch.coded[:, r0:r0 + rpc], mds_encode_plain(g, blocks[:, r0:r0 + rpc]), F32_TOL)
        for r0 in range(0, rows, rpc))}
    torch.cuda.empty_cache()
    begin, count, weights, responders = ch.cm.plan_tables(general_allocation(speeds, 4, 8))
    ids, gather = ch.cm.device_tables(begin, count, responders, dev)
    view, xt = ch.coded.view(n_ * rows, d), x.T.contiguous()
    nb = ids.numel()
    parts = cmv.coded_matvec_multi(view, xt, ids, rpc)
    errs["coded_matvec"] = max(
        compare(f"{label}: lm_head coded_matvec multi, nb = {nb}, br = {rpc}, d = {d}, B = 2, "
                f"blocks {j}-{j + 4}", parts[j:j + 4],
                cmv.coded_matvec_plain(view, xt, ids[j:j + 4], rpc), F32_TOL)
        for j in range(0, nb, 4))
    flat = parts.reshape(nb, rpc * 2)

    def y_out():
        return torch.empty(4, 8, rpc * 2, device=dev).transpose(0, 1)

    errs["mds_decode"] = compare(f"{label}: lm_head mds_decode_into (8, 4, 4) x {rpc * 2}",
                                 ops.mds_decode_into(weights, flat, gather, y_out()),
                                 mds_decode_into_plain(weights, flat, gather, y_out()), F32_TOL)
    print(f"{label}: coded lm_head (6, 4), 8 chunks, float32 ({n_}, {rows}, {d}): encode "
          f"{encode_s * 1e3:.1f} ms on the host's clock; logits of x (2, {d}) under speeds "
          f"{SERVE_SPEEDS}: error {head_err:.3e} of max |x·head| against float64 "
          f"(limit {REL_ERR_LIMIT}); launches {counts}, coded_matvec by design {designs}; "
          "against their plain versions, max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (rtol = atol = {F32_TOL})", flush=True)
    return dict(ch=ch, x=x, speeds=speeds, view=view, xt=xt, ids=ids, rpc=rpc, nb=nb,
                weights=weights, gather=gather, flat=flat, y_out=y_out, g=g,
                head_err=head_err, encode_s=encode_s, counts=counts, errs=errs)


def head_in_turns(label: str, hold: dict, head, in_turns) -> dict:
    """The multi design at a coded head held by :func:`hold_coded_head`, in
    turns against ``x @ head`` (the dense product, which reads as many
    bytes) and the plain version, beside its bound: the record's fields."""
    from repro_torch.kernels import coded_matvec as cmv

    view, xt, ids, rpc, nb, x = (hold[k] for k in ("view", "xt", "ids", "rpc", "nb", "x"))
    d = head.shape[0]
    versions = {"multi": lambda: cmv.coded_matvec_multi(view, xt, ids, rpc),
                "x @ head (dense)": lambda: x @ head,
                "plain": lambda: cmv.coded_matvec_plain(view, xt, ids, rpc)}
    names = list(versions)
    times = in_turns(f"coded_matvec multi, {label} lm_head", versions, names + names[::-1])
    best = {name: min(t["device_ms"]) for name, t in times.items()}
    b_ms, b_by = bound_ms(4 * (nb * rpc * d + d * 2 + nb + nb * rpc * 2), 2 * nb * rpc * d * 2)
    rec = dict(head_multi_ms=best["multi"], head_dense_ms=best["x @ head (dense)"],
               head_plain_ms=best["plain"], head_bound_ms=b_ms, head_bound_by=b_by,
               head_shape=f"nb = {nb} blocks of {rpc} rows, d = {d}, float32, B = 2")
    print(f"{label}: coded_matvec multi at the lm_head, {rec['head_shape']}: best of two "
          f"{best['multi']:.4f} ms against a bound of {b_ms:.4f} ({b_by}, "
          f"{b_ms / best['multi']:.1%}); x @ head {best['x @ head (dense)']:.4f}, plain "
          f"{best['plain']:.4f}", flush=True)
    return rec


def serve_phase(dev, call_ms, timed, compare, in_turns) -> tuple:
    """Phase 7: ``repro_torch.launch.serve`` at full width and depth on the
    card.  Returns the entry point's launches by record name, the record of
    ``coded_matvec``'s multi design at the lm_head's shape, and the phase's
    record."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.core.coding import pad_rows
    from repro_torch.kernels import coded_matvec as cmv
    from repro_torch.kernels import ops
    from repro_torch.kernels.mds_decode import mds_decode_into_plain
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.params import param_count, tree_bytes

    rec = {}
    # (a) the entry point, as a user runs it: the JAX package's defaults
    # (6 requests, 8-token prompts, 8 new tokens, max_batch 4) and the coded
    # head's validation; the launches counted from 0.  main(argv) is
    # run(args, build(args)): the model is built once and kept for (b)-(e)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    args = launch_serve.parse_args(["--arch", SERVE_ARCH, "--coded-head"])
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        model = launch_serve.build(args)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        rc = launch_serve.run(args, model)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts, designs = ops.launch_counts(), ops.design_counts()["coded_matvec"]
    print(log.getvalue(), end="", flush=True)
    expect("phase 7: serve.main's exit code", rc, 0)
    expect("phase 7: serve.main's launches", counts,
           {"coded_matvec": 1, "mds_encode": 1, "mds_decode": 1, "lstm_cell": 0})
    expect("phase 7: serve.main's coded_matvec designs", designs,
           {"stream": 0, "split": 0, "multi": 1, "general": 0})
    main_err = float(re.search(r"rel_err=(\S+)", log.getvalue())[1])
    if not main_err <= REL_ERR_LIMIT:
        raise RuntimeError(f"phase 7: serve.main's coded head error {main_err} > {REL_ERR_LIMIT}")
    if "6 requests, 48 tokens" not in log.getvalue():
        raise RuntimeError("phase 7: serve.main did not serve 6 requests of 8 tokens")
    rec.update(main_s=main_s, main_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               main_coded_head_err=main_err, main_launches=counts)
    print(f"serve (a): launch.serve's build and run in {main_s:.1f} s, card peak "
          f"{rec['main_peak_gb']:.1f} GB; launches {counts}, coded_matvec by design {designs}",
          flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # (b) the model of (a), for its measurements
    cfg = model.cfg
    specs = model.specs()
    n_params, n_bytes = param_count(specs), tree_bytes(specs)
    print(f"serve (b): {cfg.name}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params:,} parameters, {n_bytes / 1e9:.3f} GB ({cfg.dtype}, norms float32), "
          f"built on the card from a seeded generator in {build_s:.2f} s", flush=True)

    # (c) serve the requests of (a), each decode step between CUDA events
    out, serve_s, steps = clocked_serve(model, dev, "phase 7")
    tokens = sum(len(v) for v in out.values())
    same = all(f"request {rid}: {out[rid]}" in log.getvalue() for rid in range(3))
    step_ms = [ms for _, _, ms in steps]
    bounds = [decode_step_bound(model, b, pos) for b, pos, _ in steps]
    full = [i for i, (b, _, _) in enumerate(steps) if b == 4]
    med = statistics.median(step_ms[i] for i in full)
    bound = statistics.median(bounds[i][0] for i in full)
    rec.update(serve_s=serve_s, tokens=tokens, tokens_per_s=tokens / serve_s,
               step_ms_median=med, step_ms_min=min(step_ms), step_ms_max=max(step_ms),
               step_bound_ms=bound, step_bound_by=bounds[full[0]][1], steps=len(steps),
               same_tokens_as_main=same)
    print(f"serve (c), smoke traffic at a context of at most 16: "
          f"{len(out)} requests, {tokens} tokens in {serve_s * 1e3:.1f} ms "
          f"({tokens / serve_s:.1f} tokens/s), {len(steps)} decode steps; a step at B = 4 "
          f"between CUDA events: median {med:.3f} ms (min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f} over all steps) against a bound of {bound:.3f} ms "
          f"({bounds[full[0]][1]}); the first 3 requests' tokens equal serve.main's: {same}",
          flush=True)

    # (d) the device's share of a step: the kernels of PROFILED_STEPS steps
    # at B = 4, from the profiler
    busy = short_context_busy(model, dev)
    if busy is None:
        print("serve (d): the profiler recorded no device time: device busy share not measured",
              flush=True)
    else:
        busy_ms, host_ms, n_kernels, top = busy
        rec.update(step_device_busy_ms=busy_ms, step_profiled_ms=host_ms,
                   step_kernel_launches=n_kernels, step_idle_share=1 - busy_ms / med,
                   step_top_kernels=top)
        print(f"serve (d): {PROFILED_STEPS} decode steps at B = 4 under the profiler: "
              f"{n_kernels:.0f} kernel launches and {busy_ms:.3f} ms of kernels a step, so the "
              f"device idles {1 - busy_ms / med:.1%} of (c)'s "
              f"median step (a profiled step takes {host_ms:.3f} ms on the host's clock); "
              "by kernel, launches and ms a step: " + "; ".join(
                  f"{name} {n} {ms:.3f}" for name, n, ms in top), flush=True)

    # (d2) a decode step at a real context: LONG_BATCH prompts of
    # LONG_CONTEXT tokens through LM.prefill, then LONG_STEPS greedy steps
    # between CUDA events, then PROFILED_STEPS under the profiler
    long = long_context_decode(model, dev, "phase 7")
    prefill_s, long_ms, long_s, busy = (long[k] for k in ("prefill_s", "step_ms", "decode_s",
                                                         "busy"))
    long_med = statistics.median(long_ms)
    long_bound, long_by = decode_step_bound(model, LONG_BATCH, LONG_CONTEXT + LONG_STEPS // 2)
    rec.update(long_batch=LONG_BATCH, long_context=LONG_CONTEXT, long_prefill_s=prefill_s,
               long_step_ms_median=long_med, long_step_ms_min=min(long_ms),
               long_step_ms_max=max(long_ms), long_step_bound_ms=long_bound,
               long_step_bound_by=long_by,
               long_tokens_per_s=LONG_BATCH * LONG_STEPS / long_s)
    line = (f"serve (d2): {LONG_BATCH} prompts of {LONG_CONTEXT} tokens: prefill "
            f"{prefill_s * 1e3:.1f} ms on the host's clock; {LONG_STEPS} decode steps "
            f"{LONG_BATCH * LONG_STEPS / long_s:.1f} tokens/s, a step between CUDA events "
            f"median {long_med:.3f} ms (min {min(long_ms):.3f}, max {max(long_ms):.3f}) "
            f"against a bound of {long_bound:.3f} ms ({long_by}, the KV cache included)")
    if busy is not None:
        busy_ms, _, n_kernels, top = busy
        rec.update(long_step_device_busy_ms=busy_ms, long_step_idle_share=1 - busy_ms / long_med)
        line += (f"; under the profiler {n_kernels:.0f} launches and {busy_ms:.3f} ms of kernels "
                 f"a step, so the device idles {1 - busy_ms / long_med:.1%} of the median "
                 "step; by kernel: " + "; ".join(f"{name} {n} {ms:.3f}" for name, n, ms in top))
    print(line, flush=True)
    del long
    torch.cuda.empty_cache()

    # (e) the prefill handoff at full width, in bfloat16, against decoding
    # from scratch: prefill 12 tokens, then one decode step
    toks = torch.as_tensor(np.random.default_rng(3).integers(1, cfg.vocab_size, (1, 13)),
                           device=dev)
    _, caches = model.prefill(toks[:, :12], max_seq=13)
    lg_a, _ = model.decode_step(toks[:, 12:13], caches, 12)
    scratch = model.init_cache(1, 13)
    for t in range(13):
        lg_b, scratch = model.decode_step(toks[:, t:t + 1], scratch, t)
    handoff = rel_err(lg_a, lg_b.double())
    if not (torch.isfinite(lg_a).all() and handoff <= HANDOFF_REL):
        raise RuntimeError(f"phase 7: prefill handoff error {handoff:.3e} > {HANDOFF_REL}")
    rec.update(handoff_rel_err=handoff, handoff_argmax_equal=bool(
        torch.equal(lg_a.argmax(-1), lg_b.argmax(-1))))
    print(f"serve (e): prefill(12) then decode_step(12) against 13 decode steps from scratch, "
          f"{cfg.dtype}: error {handoff:.3e} of the largest logit ({float(lg_b.abs().max()):.3f}; "
          f"limit {HANDOFF_REL}); argmax equal: {rec['handoff_argmax_equal']}", flush=True)
    del caches, scratch
    head = model.embed["head"].detach().float()
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()

    # (f) the coded lm_head at its full shape: (6, 4) code, 8 chunks, float32
    h = hold_coded_head("serve (f)", head, dev, compare)
    ch, x, speeds, view, xt, ids, rpc, nb, weights, gather, flat, y_out, g = (
        h[k] for k in ("ch", "x", "speeds", "view", "xt", "ids", "rpc", "nb", "weights",
                       "gather", "flat", "y_out", "g"))
    head_err, encode_s, head_counts, errs = (h[k] for k in ("head_err", "encode_s", "counts",
                                                            "errs"))
    n_, rows, d = ch.coded.shape
    blocks = pad_rows(head.T, 4 * 8).reshape(4, rows, d).contiguous()

    # (g) times: the whole call on the host's clock, and the device work of
    # the kernels against torch.matmul and the plain versions, in turns
    sel = view.view(n_ * 8, rpc, d)[ids.long()].reshape(-1, d)
    call = {"logits (kernels)": call_ms(lambda: ch.logits(x, speeds)),
            "x @ head (torch.matmul)": call_ms(lambda: x @ head)}
    versions = {
        "kernels: coded_matvec multi + mds_decode_into":
            lambda: ops.mds_decode_into(weights, cmv.coded_matvec_multi(view, xt, ids, rpc)
                                        .reshape(nb, -1), gather, y_out()),
        "x @ head (torch.matmul)": lambda: x @ head,
        "plain versions": lambda: mds_decode_into_plain(
            weights, cmv.coded_matvec_plain(view, xt, ids, rpc).reshape(nb, -1), gather, y_out()),
    }
    names = list(versions)
    head_times = in_turns("lm_head logits, device work", versions, names + names[::-1])
    # the library: each single PyTorch call that gives the same products from
    # the same bytes, the assigned rows gathered beforehand in two layouts,
    # and the dense head (the same 2.68 GB); the fastest is the record's
    libraries = {"torch.matmul on pre-gathered rows": lambda: torch.matmul(sel, xt),
                 "F.linear on pre-gathered rows": lambda: torch.nn.functional.linear(x, sel),
                 "x @ head (dense)": lambda: x @ head}
    kernel_versions = {"multi": lambda: cmv.coded_matvec_multi(view, xt, ids, rpc),
                       **libraries,
                       "plain": lambda: cmv.coded_matvec_plain(view, xt, ids, rpc)}
    names = list(kernel_versions)
    k_times = in_turns("coded_matvec multi, lm_head", kernel_versions, names + names[::-1])
    best = {name: min(t["device_ms"]) for name, t in k_times.items()}
    med_call = {name: statistics.median(t["call_ms"]) for name, t in k_times.items()}
    library = min(libraries, key=best.get)
    b_ms, b_by = bound_ms(4 * (nb * rpc * d + d * 2 + nb + nb * rpc * 2), 2 * nb * rpc * d * 2)
    dec = timed(lambda: ops.mds_decode_into(weights, flat, gather, y_out()))
    dec_b, _ = bound_ms(4 * (8 * 16 + 8 * 4 + 2 * nb * rpc * 2), 2 * 8 * 16 * rpc * 2)
    enc = timed(lambda: ops.mds_encode(g, blocks))
    enc_b, _ = bound_ms(4 * (24 + 10 * rows * d), 2 * 24 * rows * d)
    dev_best = {name: min(t["device_ms"]) for name, t in head_times.items()}
    rec.update(head_err=head_err, head_encode_s=encode_s, head_call_ms=call,
               head_device_ms=dev_best, head_launches=head_counts,
               head_kernel_vs_plain=errs, decode_device_ms=dec["device_ms"],
               decode_bound_ms=dec_b, encode_device_ms=enc["device_ms"], encode_bound_ms=enc_b)
    print(f"serve (g): lm_head logits call ms (median of {REPS}): " + ", ".join(
        f"{k} {v:.4f}" for k, v in call.items()) + "; device work, best of two: " + ", ".join(
        f"{k} {v:.4f}" for k, v in dev_best.items()) + f"; coded_matvec multi {best['multi']:.4f} "
        f"ms against a bound of {b_ms:.4f} ({b_by}, {b_ms / best['multi']:.1%}), " + ", ".join(
            f"{name} {best[name]:.4f}" for name in libraries) + f" (fastest: {library}), plain "
        f"{best['plain']:.4f}; mds_decode_into {dec['device_ms']:.4f} (bound {dec_b:.4f}); "
        f"mds_encode of the head {enc['device_ms']:.4f} (bound {enc_b:.4f})", flush=True)
    record = dict(name="coded_matvec (multi design, lm_head)", route="cuda",
                  source="src/repro_torch/kernels/csrc/coded_matvec.cu",
                  replaces=KERNELS["coded_matvec"], launches=counts["coded_matvec"],
                  max_abs_err=errs["coded_matvec"], ms=best["multi"], plain_ms=best["plain"],
                  bound_ms=b_ms, bound_by=b_by,
                  library_ms=best[library],
                  device_ms=best["multi"], call_ms=med_call["multi"],
                  plain_device_ms=best["plain"], plain_call_ms=med_call["plain"],
                  library_device_ms=best[library], library_call_ms=med_call[library],
                  library=f"{library}: the fastest of " + ", ".join(
                      f"{name} {best[name]:.4f} ms" for name in libraries)
                  + f" (the gathered rows ({nb * rpc}, {d}), x (2, {d}))", design="multi",
                  shape=f"lm_head: nb = {nb} blocks of {rpc} rows, d = {d}, float32, B = 2",
                  cluster_launches=0, workload_launches=0)
    del h, ch, head, blocks, sel, flat
    torch.cuda.empty_cache()
    launches = {"coded_matvec": designs["stream"], "coded_matvec (multi design)": 0,
                "mds_encode": counts["mds_encode"], "mds_decode": counts["mds_decode"],
                "lstm_cell": counts["lstm_cell"], record["name"]: designs["multi"]}
    return launches, record, rec


# -- 8. serving the other decoder families -----------------------------------

class RoutedExperts:
    """While entered, each ``moe_apply`` call also records how many distinct
    experts its tokens are routed to, and the experts of each token (a host
    sync each: outside timed work)."""

    def __init__(self):
        self.counts = []
        self.experts = []

    def __enter__(self):
        import torch

        from repro_torch.models import moe as MOE

        self._apply = apply = MOE.moe_apply

        def counting(p, x, cfg):
            _, _, experts = MOE.route(p, x.reshape(-1, x.shape[-1]), cfg)
            self.counts.append(torch.unique(experts).numel())
            self.experts.append(experts.sort(-1).values)
            return apply(p, x, cfg)

        MOE.moe_apply = counting
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as MOE

        MOE.moe_apply = self._apply

    def share(self, cfg) -> float:
        """The mean share of the experts routed to per call."""
        return statistics.mean(self.counts) / cfg.num_experts

    def alike(self, other: "RoutedExperts", calls: int):
        """Whether each token of the first ``calls`` calls, one decode step's
        layers, went to the same experts here as in ``other``."""
        import torch

        return torch.stack([(a == b).all(-1) for a, b in
                            zip(self.experts[:calls], other.experts[:calls])]).all(0)


class BlockErrors:
    """While entered, each attention, MLP and recurrent block and the logits
    projection that a decode step runs (or each of the functions ``names``)
    is run again in float32 on float32 copies of its weights (each made
    when the block reads it), input and cache or state, and its output's
    error over the float32 output's largest entry is recorded by function
    name."""

    NAMES = ("attn_decode", "cross_attn_decode", "mlp_apply", "mamba_decode", "mlstm_decode",
             "slstm_decode", "head_apply")

    def __init__(self, names: tuple = NAMES):
        self.names = names
        self.errors = {}

    def __enter__(self):
        import torch

        from repro_torch.models import layers as L
        from repro_torch.models import ssm as SSM

        def up(v):
            if isinstance(v, torch.Tensor):
                return v.float().clone()
            return {k: up(t) for k, t in v.items()} if hasattr(v, "items") else v

        class Upcast(collections.abc.Mapping):
            """A block's weights, each copied in float32 where it is read."""

            def __init__(self, p):
                self.p = p

            def __getitem__(self, key):
                v = self.p[key]
                return v.float() if isinstance(v, torch.Tensor) else Upcast(v)

            def __iter__(self):
                return iter(self.p)

            def __len__(self):
                return len(self.p)

            def __contains__(self, key):
                return key in self.p

        self._saved = []
        for name in self.names:
            module = L if hasattr(L, name) else SSM
            run = getattr(module, name)

            def checked(p, x, *rest, run=run, name=name, **kw):
                ref_rest = [up(r) for r in rest]     # before run writes a cache in place
                out = run(p, x, *rest, **kw)
                ref = run(Upcast(p), x.float(), *ref_rest, **kw)
                y, y32 = (out[0], ref[0]) if isinstance(out, tuple) else (out, ref)
                self.errors.setdefault(name, []).append(rel_err(y, y32.double()))
                return out

            self._saved.append((module, name, run))
            setattr(module, name, checked)
        return self

    def __exit__(self, *exc):
        for module, name, run in self._saved:
            setattr(module, name, run)


def check_fits(cfg, dev) -> None:
    """Fail unless ``cfg``'s parameters leave FREE_AFTER_BUILD of the card's
    free memory after its build."""
    import torch

    from repro_torch.models import LM

    need = sum(p.numel() * p.dtype.itemsize for p in LM(cfg, device="meta").parameters())
    free, _ = torch.cuda.mem_get_info(dev)
    if free - need < FREE_AFTER_BUILD:
        raise RuntimeError(f"{cfg.name} at {cfg.num_layers} layers takes {need / 1e9:.2f} GB "
                           f"of the card's {free / 1e9:.2f} GB free, leaving less than "
                           f"{FREE_AFTER_BUILD / 2**30:.0f} GiB")


def handoff_error(model, dev, seed: int) -> tuple:
    """prefill(HANDOFF_TOKENS) then one decode step, against decoding all
    HANDOFF_TOKENS + 1 tokens from scratch; for a VLM, whose prompt starts
    with its image embeddings, which only a prefill takes, against
    prefill(HANDOFF_TOKENS + 1)'s last logits: (error over the largest
    logit, argmax equal, what the step was held against)."""
    import numpy as np
    import torch

    cfg, n = model.cfg, HANDOFF_TOKENS
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, n + 1)), device=dev)
    if cfg.frontend == "vit_stub":
        img = torch.as_tensor(rng.standard_normal((1, cfg.frontend_tokens, cfg.frontend_dim)),
                              dtype=torch.float32, device=dev)
        _, caches = model.prefill(toks[:, :n], image_embeds=img, max_seq=img.shape[1] + n + 1)
        lg_a, _ = model.decode_step(toks[:, n:n + 1], caches, img.shape[1] + n)
        lg_b, _ = model.prefill(toks, image_embeds=img)
        what = (f"prefill({cfg.frontend_tokens} image embeddings, {n} tokens) then a decode "
                f"step against prefill({cfg.frontend_tokens} image embeddings, {n + 1} tokens)")
    else:
        _, caches = model.prefill(toks[:, :n], max_seq=n + 1)
        lg_a, _ = model.decode_step(toks[:, n:n + 1], caches, n)
        scratch = model.init_cache(1, n + 1)
        for t in range(n + 1):
            lg_b, scratch = model.decode_step(toks[:, t:t + 1], scratch, t)
        what = f"prefill({n}) then a decode step against {n + 1} decode steps from scratch"
    if not torch.isfinite(lg_a).all():
        raise RuntimeError(f"{cfg.name}: the prefill handoff's logits are not finite")
    return (rel_err(lg_a, lg_b.double()), bool(torch.equal(lg_a.argmax(-1), lg_b.argmax(-1))),
            what)


def moe_bf16_error(model, dev) -> dict:
    """Layer 0's MoE block of the bfloat16 ``model`` against the same
    weights in float32, on one input of 4 × 16 normed positions, capacity
    factor 8 (no drops).  A token whose experts differ between the two is
    a near tie only if its float32 gates of the swapped experts lie within
    twice the router's own bfloat16 error; the block's error is taken over
    the tokens routed alike.  Returns the record."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE

    cfg = dataclasses.replace(model.cfg, moe_capacity_factor=8.0)
    x = torch.as_tensor(np.random.default_rng(6).standard_normal((4, 16, cfg.d_model)),
                        dtype=torch.float32, device=dev)
    with torch.no_grad():
        p16 = {name: t if t.dtype == torch.float32 and name == "router" else
               t.to(torch.bfloat16) for name, t in model.layers[0]["moe"].items()}
        p32 = {name: t.float() for name, t in p16.items()}
        h32 = L.apply_norm(model.layers[0]["norm2"], x)
        h16 = h32.to(torch.bfloat16)
        out32, out16 = MOE.moe_apply(p32, h32, cfg), MOE.moe_apply(p16, h16, cfg)
        g32, _, i32 = MOE.route(p32, h32.reshape(-1, cfg.d_model), cfg)
        g16, _, i16 = MOE.route(p16, h16.reshape(-1, cfg.d_model), cfg)
    gate_err = float((g16 - g32).abs().max())
    alike = (i32.sort(-1).values == i16.sort(-1).values).all(-1)
    flips = []
    for t in torch.nonzero(~alike).flatten().tolist():
        swapped = set(i32[t].tolist()) ^ set(i16[t].tolist())
        gates = sorted(float(g32[t, e]) for e in swapped)
        flips.append({"token": t, "float32_gates_of_the_swapped_experts": gates})
        if gates[-1] - gates[0] > 2 * gate_err:
            raise RuntimeError(f"{cfg.name}: token {t}'s experts differ between bfloat16 and "
                               f"float32 beyond a near tie: gates {gates}, router error "
                               f"{gate_err:.3e}")
    keep = alike.view(4, 16)
    err = rel_err(out16[keep], out32[keep].double())
    return dict(moe_bf16_rel_err=err, moe_router_bf16_err=gate_err, moe_tokens=int(alike.numel()),
                moe_flips=flips)


def upcast(model):
    """``model`` made float32 in place, weight by weight (each upcast
    exactly, its bfloat16 tensor freed before the next is made), so that
    the card never holds both copies of it; returns it."""
    import dataclasses

    import torch
    from torch import nn

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.ParameterDict):
                for key in list(mod.keys()):
                    mod[key] = nn.Parameter(mod[key].float(), requires_grad=mod[key].requires_grad)
    model.cfg = dataclasses.replace(model.cfg, dtype="float32")
    return model


def cache_lengths(model, caches) -> dict:
    """The attention caches' lengths after a prefill, local and global
    layers apart: {"local" or "global": {length: layers}}."""
    out = {}
    for slot, entry in zip(model.slots, caches):
        if "attn" in entry:
            kind = out.setdefault("local" if slot.local else "global", {})
            length = int(entry["attn"]["k"].shape[1])
            kind[length] = kind.get(length, 0) + 1
    return out


def long_context_record(model, dev, label: str, context: int, image_embeds=None) -> dict:
    """(b) at a real context: ``long_context_decode``'s numbers beside the
    step's bound, the routed experts' bound for a MoE, and the caches'
    lengths, printed and returned."""
    import torch

    cfg = model.cfg
    moe = cfg.num_experts > 0
    long = long_context_decode(model, dev, label, context, image_embeds)
    med = statistics.median(long["step_ms"])
    total = context + (0 if image_embeds is None else image_embeds.shape[1])
    bound, by = decode_step_bound(model, LONG_BATCH, total + LONG_STEPS // 2)
    rec = dict(context=context, positions=total, prefill_s=long["prefill_s"],
               step_ms_median=med, step_ms_min=min(long["step_ms"]),
               step_ms_max=max(long["step_ms"]), step_bound_ms=bound, step_bound_by=by,
               tokens_per_s=LONG_BATCH * LONG_STEPS / long["decode_s"],
               cache_lengths=cache_lengths(model, long["caches"]))
    prompt = (f"{LONG_BATCH} prompts of {context} tokens" if image_embeds is None else
              f"{LONG_BATCH} prompts of {image_embeds.shape[1]} image embeddings (width "
              f"{image_embeds.shape[2]}, through the projector) and {context} tokens")
    line = (f"{label} (b): {prompt}: prefill {long['prefill_s'] * 1e3:.1f} ms on the host's "
            f"clock; attention caches by length {rec['cache_lengths']}; {LONG_STEPS} decode "
            f"steps {rec['tokens_per_s']:.1f} tokens/s, a step between CUDA events median "
            f"{med:.3f} ms (min {rec['step_ms_min']:.3f}, max {rec['step_ms_max']:.3f}) against "
            f"a bound of {bound:.3f} ms ({by}")
    if moe:
        with RoutedExperts() as routed:
            cur, caches = long["token"], long["caches"]
            for i in range(3):
                logits, caches = model.decode_step(cur, caches, long["pos"] + i)
                cur = torch.argmax(logits, -1)[:, None]
        share = routed.share(cfg)
        rec.update(routed_share=share, routed_bound_ms=decode_step_bound(
            model, LONG_BATCH, total + LONG_STEPS // 2, share)[0])
        line += (f", every expert read); {share * cfg.num_experts:.2f} experts routed a layer: "
                 f"bound {rec['routed_bound_ms']:.3f} ms")
    else:
        line += ")"
    if long["busy"] is not None:
        busy_ms, _, n_kernels, top = long["busy"]
        rec.update(device_busy_ms=busy_ms, kernel_launches=n_kernels,
                   idle_share=1 - busy_ms / med, top_kernels=top)
        line += (f"; under the profiler {n_kernels:.0f} launches and {busy_ms:.3f} ms of kernels "
                 f"a step, idle {1 - busy_ms / med:.1%}; by kernel: " + "; ".join(
                     f"{name} {n} {ms:.3f}" for name, n, ms in top))
    print(line, flush=True)
    return rec


def bf16_against_f32(half, dev, label: str) -> dict:
    """(d) and (c) on ``half``, a bfloat16 model: 16 decode steps at B = 4
    with every block and norm run again in float32 (``BlockErrors``), then ``half``
    upcast in place and the same 16 steps in float32, each step's logits
    against the bfloat16 run's (for a MoE, the first step's over the tokens
    routed alike in every layer: a token routed otherwise is printed);
    then the float32 prefill handoff.  Fails where a block is over BF16_REL
    (an mLSTM block BF16_MLSTM_REL), the first step's logits over
    BF16_LOGITS_REL or the handoff over F32_HANDOFF_REL.  Returns the
    record; ``half`` is float32 after."""
    import numpy as np
    import torch

    cfg = half.cfg
    moe = cfg.num_experts > 0
    toks = torch.as_tensor(np.random.default_rng(7).integers(1, cfg.vocab_size, (4, 16)),
                           device=dev)
    blocks = BlockErrors(BlockErrors.NAMES + ("apply_norm",))
    routed16, routed32 = (RoutedExperts(), RoutedExperts()) if moe else (None, None)
    caches, lg16 = half.init_cache(4, 16), []
    for t in range(16):
        with blocks, routed16 or contextlib.nullcontext():
            lg, caches = half.decode_step(toks[:, t:t + 1], caches, t)
        lg16.append(lg)
    del caches
    f32 = upcast(half)
    torch.cuda.empty_cache()
    caches, lg32 = f32.init_cache(4, 16), []
    for t in range(16):
        with routed32 or contextlib.nullcontext():
            lg, caches = f32.decode_step(toks[:, t:t + 1], caches, t)
        lg32.append(lg)
    del caches
    rows = (routed16.alike(routed32, len(routed16.experts) // 16) if moe else
            torch.ones(4, dtype=torch.bool, device=dev))
    if not rows.any():
        raise RuntimeError(f"{label}: every token of the first step was routed otherwise in "
                           "bfloat16 and in float32")
    errs = [rel_err(lg16[0][rows], lg32[0][rows].double())] + [
        rel_err(a, b.double()) for a, b in zip(lg16[1:], lg32[1:])]
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum()) for a, b in zip(lg16, lg32))
    worst = {name: max(e) for name, e in blocks.errors.items()}
    over = {name: e for name, e in worst.items()
            if not e <= (BF16_MLSTM_REL if name == "mlstm_decode" else BF16_REL)}
    handoff, same, handoff_what = handoff_error(f32, dev, 3)
    rec = dict(f32_layers=cfg.num_layers, bf16_block_rel_err=worst, bf16_step_rel_errs=errs,
               bf16_argmax_agree=agree / 64, bf16_first_step_rows=int(rows.sum()),
               f32_handoff_rel_err=handoff, f32_handoff_argmax_equal=same,
               f32_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    routed = ("" if not moe else f" over the {int(rows.sum())} of 4 tokens routed alike in "
              f"every layer (otherwise: {torch.nonzero(~rows).flatten().tolist()})")
    print(f"{label} (c): float32, {cfg.num_layers} layers, the bfloat16 weights upcast: "
          f"{handoff_what}, error {handoff:.3e} of the largest logit (limit "
          f"{F32_HANDOFF_REL}), argmax equal: {same}; (d) bfloat16 against float32 of the same "
          f"weights, each block of every layer on the bfloat16 run's input, 16 decode steps at "
          f"B = 4, the worst by block {', '.join(f'{k} {v:.2e}' for k, v in worst.items())}; "
          f"the logits after the first step {errs[0]:.3e}{routed} (limit {BF16_LOGITS_REL}), "
          f"then by step {', '.join(f'{e:.2e}' for e in errs[1:])}, argmax equal at {agree} of "
          f"64; card peak {rec['f32_peak_gb']:.1f} GB", flush=True)
    if over:
        raise RuntimeError(f"{label}: bfloat16 against float32 of the same block, {over} over "
                           f"{BF16_REL} (mlstm_decode {BF16_MLSTM_REL})")
    if not errs[0] <= BF16_LOGITS_REL:
        raise RuntimeError(f"{label}: bfloat16 against float32, the logits of the first decode "
                           f"step: {errs[0]:.3e} > {BF16_LOGITS_REL}")
    if not handoff <= F32_HANDOFF_REL:
        raise RuntimeError(f"{label}: float32 prefill handoff error {handoff:.3e} > "
                           f"{F32_HANDOFF_REL}")
    return rec


def serve_family(arch: str, dev, compare, in_turns, reduced: bool) -> tuple:
    """Phase 8 for one arch: returns its launches, its record."""
    import contextlib
    import dataclasses
    import io

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build_model
    from repro_torch.models.params import param_count, tree_bytes

    label = f"phase 8 {arch}"
    rec = {}
    # (a) the entry point as a user runs it (the model built once and kept)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    coded = arch not in UNCODED_ENTRY
    args = launch_serve.parse_args(["--arch", arch] + (["--coded-head"] if coded else [])
                                   + (["--reduced", "--device", "cpu"] if reduced else []))
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        if arch in FAMILY_LAYERS:
            cfg = get_config(arch)
            if reduced:
                cfg = cfg.reduced()
            else:
                cfg = dataclasses.replace(cfg, num_layers=FAMILY_LAYERS[arch])
                check_fits(cfg, dev)
            model = build_model(cfg, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(args.seed))
        else:
            model = launch_serve.build(args)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated() / 1e9
        rc = launch_serve.run(args, model)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts, designs = ops.launch_counts(), ops.design_counts()["coded_matvec"]
    print(log.getvalue(), end="", flush=True)
    cfg = model.cfg
    entry_head = int(coded and not cfg.tie_embeddings)
    expect(f"{label}: serve.run's exit code", rc, 0)
    expect(f"{label}: serve.run's launches", counts,
           {"coded_matvec": entry_head, "mds_encode": entry_head, "mds_decode": entry_head,
            "lstm_cell": 0})
    expect(f"{label}: serve.run's coded_matvec designs", designs,
           {"stream": 0, "split": 0, "multi": entry_head, "general": 0})
    if "6 requests, 48 tokens" not in log.getvalue():
        raise RuntimeError(f"{label}: serve.run did not serve 6 requests of 8 tokens")
    f32_head_gb = 4 * cfg.d_model * cfg.padded_vocab * (1 + 6 / 4) / 1e9
    if entry_head:
        head_err = float(re.search(r"rel_err=(\S+)", log.getvalue())[1])
        if not head_err <= REL_ERR_LIMIT:
            raise RuntimeError(f"{label}: the coded head's error {head_err} > {REL_ERR_LIMIT}")
        head_note = f"error {head_err:.2e}"
    elif cfg.tie_embeddings:
        head_err, head_note = None, ("none: the head is the tied embedding, for which "
                                     "launch.serve builds no coded head, as the JAX package's "
                                     "entry point does; (e) is skipped")
    else:
        head_err, head_note = None, (
            f"not built here: run without --coded-head, since its float32 copies (the dense "
            f"head and the 6 coded partitions, {f32_head_gb:.1f} GB) do not fit beside "
            f"{cfg.num_layers} layers; (e) builds and holds it alone after they are released")
    specs = model.specs()
    rec.update(arch=arch, layers=cfg.num_layers, full_layers=get_config(arch).num_layers,
               d_model=cfg.d_model, params=param_count(specs), gb=tree_bytes(specs) / 1e9,
               build_s=build_s, build_peak_gb=build_peak, main_s=main_s,
               main_peak_gb=torch.cuda.max_memory_allocated() / 1e9, coded_head_err=head_err,
               head=f"d = {cfg.d_model} x V = {cfg.padded_vocab}", entry_coded_head=head_note,
               launches=counts, designs=designs)
    print(f"{label} (a): {cfg.num_layers} of {rec['full_layers']} layers, d_model "
          f"{cfg.d_model}, {rec['params']:,} parameters, {rec['gb']:.3f} GB ({cfg.dtype}); "
          f"built in {build_s:.2f} s (card peak {build_peak:.1f} GB), build and serve.run "
          f"{main_s:.1f} s (card peak {rec['main_peak_gb']:.1f} GB); coded head "
          f"{rec['head']}: {head_note}; launches {counts}, coded_matvec by design {designs}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()

    # (b) tokens/s and a decode step at a context of at most 16 and after
    # a prefill of each of the arch's real contexts, beside its bound(s)
    # and its kernels
    moe = cfg.num_experts > 0
    out, serve_s, steps = clocked_serve(model, dev, label)
    tokens = sum(len(v) for v in out.values())
    full = [(pos, ms) for b, pos, ms in steps if b == 4]
    med = statistics.median(ms for _, ms in full)
    mid = statistics.median(pos for pos, _ in full)
    routed = RoutedExperts() if moe else None
    busy = short_context_busy(model, dev, routed)
    bound, by = decode_step_bound(model, 4, mid)
    rec.update(tokens=tokens, serve_s=serve_s, tokens_per_s=tokens / serve_s,
               step_ms_median=med, step_ms_min=min(ms for _, _, ms in steps),
               step_ms_max=max(ms for _, _, ms in steps), steps=len(steps),
               step_bound_ms=bound, step_bound_by=by)
    line = (f"{label} (b): {tokens} tokens in {serve_s * 1e3:.1f} ms ({tokens / serve_s:.1f} "
            f"tokens/s), {len(steps)} decode steps; a step at B = 4, context at most 16, "
            f"between CUDA events: median {med:.3f} ms (min {rec['step_ms_min']:.3f}, max "
            f"{rec['step_ms_max']:.3f}) against a bound of {bound:.3f} ms ({by}")
    if moe:
        share = routed.share(cfg)
        routed_bound, _ = decode_step_bound(model, 4, mid, share)
        rec.update(routed_share=share, routed_bound_ms=routed_bound)
        line += (f", every expert read); {share * cfg.num_experts:.2f} of {cfg.num_experts} "
                 f"experts routed a layer: bound {routed_bound:.3f} ms for those alone")
    else:
        line += ")"
    if busy is not None:
        busy_ms, host_ms, n_kernels, top = busy
        rec.update(step_device_busy_ms=busy_ms, step_kernel_launches=n_kernels,
                   step_idle_share=1 - busy_ms / med, step_top_kernels=top)
        line += (f"; under the profiler {n_kernels:.0f} launches and {busy_ms:.3f} ms of "
                 f"kernels a step, idle {1 - busy_ms / med:.1%} of the median; by kernel: "
                 + "; ".join(f"{name} {n} {ms:.3f}" for name, n, ms in top))
    print(line, flush=True)
    images = None
    if cfg.frontend == "vit_stub":
        images = torch.randn((LONG_BATCH, cfg.frontend_tokens, cfg.frontend_dim), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(5))
    rec["long"] = [long_context_record(model, dev, label, context, images)
                   for context in ((256,) if reduced else LONG_CONTEXTS.get(arch, (LONG_CONTEXT,)))]
    rec["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()

    # (d) bfloat16 against float32 of the same weights, on the model of (a):
    # a MoE's layer-0 block and a VLM's projector
    held = {}
    if moe:
        rec.update(moe_bf16_error(model, dev))
        held["moe_apply"] = rec["moe_bf16_rel_err"]
        print(f"{label} (d): bfloat16 against float32 of the same weights, layer 0's MoE block "
              f"on 4 x 16 positions ({len(rec['moe_flips'])} of {rec['moe_tokens']} tokens "
              f"routed otherwise, near ties: {rec['moe_flips']}): {rec['moe_bf16_rel_err']:.3e} "
              f"(limit {BF16_REL})", flush=True)
    if images is not None:
        with torch.no_grad():
            w = model.projector["w"]
            img = images.to(w.dtype)
            held["projector"] = rel_err(img @ w, (img.float() @ w.float()).double())
        print(f"{label} (d): bfloat16 against float32 of the same weights, the projector on "
              f"(b)'s {tuple(images.shape)} image embeddings: {held['projector']:.3e} (limit "
              f"{BF16_REL})", flush=True)
    over = {name: e for name, e in held.items() if not e <= BF16_REL}
    if over:
        raise RuntimeError(f"{label}: bfloat16 against float32, {over} over {BF16_REL}")
    del images
    # (e) the coded head at this arch's head, each launch against its plain
    # version on the same tensors, then the multi design in turns: the head
    # kept alone, the model of (a) freed, so that nemotron's fits
    head = None if cfg.tie_embeddings else model.embed["head"].detach()
    if arch in F32_LAYERS:
        del model
        torch.cuda.empty_cache()
    if head is None:
        print(f"{label} (e): skipped, the head is the tied embedding (no coded head)", flush=True)
    else:
        head = head.float()                 # as the model stores it, (d, V); its
        torch.cuda.empty_cache()            # bfloat16 copy freed and returned to the card
        hold = hold_coded_head(f"{label} (e)", head, dev, compare)
        rec.update(head_hold_err=hold["head_err"], head_kernel_vs_plain=hold["errs"],
                   head_launches=hold["counts"],
                   head_launches_counted_in=("this record alone: (e) built the head outside "
                                             "the entry point" if not entry_head else
                                             "this record; families_launches has (a)'s"),
                   **head_in_turns(f"{label} (e)", hold, head, in_turns))
        del hold, head
        torch.cuda.empty_cache()

    # (c) the float32 prefill handoff and (d) every block of 16 decode steps
    # and the logits, bfloat16 against float32 of the same weights: on the
    # model of (a) where its float32 twin fits, else on a bfloat16 draw of
    # its first F32_LAYERS layers at full width (the same seed draws the
    # same embedding and first layers); the handoff on the weights upcast
    torch.cuda.reset_peak_memory_stats()
    if arch in F32_LAYERS:
        model = build_model(dataclasses.replace(
            cfg, num_layers=min(F32_LAYERS[arch], cfg.num_layers), moe_capacity_factor=8.0),
            device=dev, generator=torch.Generator(device=dev).manual_seed(args.seed))
    rec.update(bf16_against_f32(model, dev, label))
    rec["bf16_block_rel_err"].update(held)
    del model
    torch.cuda.empty_cache()

    launches = {"coded_matvec": designs["stream"], "mds_encode": counts["mds_encode"],
                "mds_decode": counts["mds_decode"], "lstm_cell": counts["lstm_cell"],
                "coded_matvec (multi design, lm_head)": designs["multi"]}
    return launches, rec


def families_phase(dev, compare, in_turns, reduced: bool = False) -> tuple:
    """Phase 8: ``repro_torch.launch.serve`` on the FAMILY_ARCHS on the
    card; ``compare`` holds a kernel's output against its plain version,
    ``in_turns`` times versions of one function in turns, ``reduced`` runs
    the reduced configs, as the CPU test does.  Returns the launches of the
    entry points' runs by record name, and the phase's record by arch."""
    launches, records = {}, {}
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        counts, records[arch] = serve_family(arch, dev, compare, in_turns, reduced)
        records[arch]["phase_s"] = time.perf_counter() - t0
        print(f"phase 8 {arch}: {records[arch]['phase_s']:.1f} s", flush=True)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    return launches, records


# -- 9. serving the encoder-decoder ------------------------------------------

def encdec_decode(model, frames, tokens, steps: int, label: str) -> dict:
    """``EncDecLM.prefill(frames, tokens)`` with the encoder and the decoder
    timed apart between CUDA events, then ``steps`` greedy decode steps,
    each between CUDA events, then PROFILED_STEPS under the profiler; fails
    where the logits are not finite or a token leaves the vocabulary.
    Returns the times, the generated tokens and the caches."""
    import torch

    cfg = model.cfg
    s = tokens.shape[1]
    encode, marks = model.encode, {}

    def clocked_encode(frames_):
        out = encode(frames_)
        marks["encoded"] = torch.cuda.Event(enable_timing=True)
        marks["encoded"].record()
        return out

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    model.encode = clocked_encode
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        logits, caches = model.prefill(frames, tokens, max_seq=s + steps + PROFILED_STEPS + 1)
        end.record()
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    finally:
        del model.encode
    cur = torch.argmax(logits, -1)[:, None]
    generated, step_ms = [cur], []
    t0 = time.perf_counter()
    for i in range(steps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        logits, caches = model.decode_step(cur, caches, s + i)
        e1.record()
        step_ms.append((e0, e1))
        cur = torch.argmax(logits, -1)[:, None]
        generated.append(cur)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    out = torch.cat(generated, 1)
    if not (torch.isfinite(logits).all() and 0 <= int(out.min())
            and int(out.max()) < cfg.padded_vocab):
        raise RuntimeError(f"{label}: after a prefill of {tuple(frames.shape[:2])} frames and "
                           f"{s} tokens, {steps} decode steps gave logits that are not finite "
                           "or tokens outside the vocabulary")
    pos = iter(range(s + steps, s + steps + PROFILED_STEPS + 1))
    busy = device_kernel_ms(lambda: model.decode_step(cur, caches, next(pos)), PROFILED_STEPS)
    return dict(prefill_s=prefill_s, encoder_ms=start.elapsed_time(marks["encoded"]),
                decoder_ms=marks["encoded"].elapsed_time(end),
                step_ms=[e0.elapsed_time(e1) for e0, e1 in step_ms], decode_s=decode_s,
                busy=busy, tokens=out, caches=caches)


def encdec_traffic(model, dev, b: int, n_frames: int, n_tokens: int, steps: int, label: str,
                   seed: int) -> tuple:
    """``encdec_decode`` on ``b`` random sequences of ``n_frames`` frames and
    ``n_tokens`` prompt tokens drawn from ``seed``, with the step's bound
    beside it.  Returns (the record's entries, the frames)."""
    import numpy as np
    import torch

    cfg = model.cfg
    rng = np.random.default_rng(seed)
    frames = torch.as_tensor(rng.standard_normal((b, n_frames, cfg.frontend_dim)),
                             dtype=torch.float32, device=dev)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, (b, n_tokens)), device=dev)
    run = encdec_decode(model, frames, tokens, steps, label)
    med = statistics.median(run["step_ms"])
    bound, by = decode_step_bound(model, b, n_tokens + steps // 2, enc_len=n_frames)
    rec = dict(batch=b, frames=n_frames, prompt=n_tokens, steps=steps,
               prefill_s=run["prefill_s"], encoder_ms=run["encoder_ms"],
               decoder_prefill_ms=run["decoder_ms"], step_ms=run["step_ms"],
               step_ms_median=med, step_bound_ms=bound, step_bound_by=by,
               tokens_per_s=b * steps / run["decode_s"])
    line = (f"{label}: B = {b}, {n_frames} frames and {n_tokens} prompt tokens: prefill "
            f"{run['prefill_s'] * 1e3:.1f} ms on the host's clock (between CUDA events: encoder "
            f"{run['encoder_ms']:.3f} ms, decoder {run['decoder_ms']:.3f} ms); {steps} greedy "
            f"decode steps, {rec['tokens_per_s']:.1f} tokens/s, a step between CUDA events "
            f"median {med:.3f} ms (min {min(run['step_ms']):.3f}, max "
            f"{max(run['step_ms']):.3f}) against a bound of {bound:.3f} ms ({by}: the decoder's "
            f"weights, the head, the self K/V and {n_frames} positions of cross K/V a layer)")
    if run["busy"] is not None:
        busy_ms, _, n_kernels, top = run["busy"]
        rec.update(step_device_busy_ms=busy_ms, step_kernel_launches=n_kernels,
                   step_idle_share=1 - busy_ms / med, step_top_kernels=top)
        line += (f"; under the profiler {n_kernels:.0f} launches and {busy_ms:.3f} ms of kernels "
                 f"a step, idle {1 - busy_ms / med:.1%} of the median; by kernel: " + "; ".join(
                     f"{name} {n} {ms:.3f}" for name, n, ms in top))
    print(line, flush=True)
    return rec, frames


def encdec_phase(dev, compare, in_turns, reduced: bool = False) -> tuple:
    """Phase 9: seamless-m4t-large-v2 whole on the card, driven through
    ``EncDecLM``'s own prefill and decode (``launch.serve`` refuses the
    arch, as the JAX package's does); ``compare`` holds a kernel's output
    against its plain version, ``in_turns`` times versions in turns,
    ``reduced`` runs the reduced config, as the CPU test does.  Returns the
    coded head's launches by record name, and the phase's record."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build_model
    from repro_torch.models.params import param_count, tree_bytes

    label = "phase 9"
    try:
        launch_serve.main(["--arch", ENCDEC_ARCH])
    except SystemExit as refusal:
        rec = {"serve_refusal": str(refusal)}
    else:
        raise RuntimeError(f"{label}: launch.serve.main served {ENCDEC_ARCH}")
    cfg = get_config(ENCDEC_ARCH)
    if reduced:
        cfg = cfg.reduced()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    specs = model.specs()
    rec.update(arch=cfg.name, enc_layers=cfg.enc_layers, layers=cfg.num_layers,
               d_model=cfg.d_model, params=param_count(specs), gb=tree_bytes(specs) / 1e9,
               build_s=time.perf_counter() - t0,
               build_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               head=f"d = {cfg.d_model} x V = {cfg.padded_vocab}")
    print(f"{label}: {cfg.name}, {cfg.enc_layers} encoder and {cfg.num_layers} decoder layers, "
          f"d_model {cfg.d_model}, {rec['params']:,} parameters, {rec['gb']:.3f} GB "
          f"({cfg.dtype}, norms float32), built on the card from seed 0 in "
          f"{rec['build_s']:.2f} s; launch.serve.main refuses the arch: {rec['serve_refusal']!r}",
          flush=True)

    # (a) smoke traffic and (b) a real context, each step beside its bound;
    # then each encoder block of (b)'s frames in bfloat16 against float32
    frames_n, prompt, steps = ENCDEC_SMOKE
    rec["smoke"], _ = encdec_traffic(model, dev, 4, frames_n, prompt, steps, f"{label} (a)", 0)
    context = ENCDEC_CONTEXT if not reduced else 256
    rec["long"], frames = encdec_traffic(model, dev, LONG_BATCH, context, context, LONG_STEPS,
                                         f"{label} (b)", 4)
    rec["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with BlockErrors(("attn_apply", "mlp_apply")) as enc_blocks, torch.no_grad():
        model.encode(frames)
    enc_worst = {name: max(e) for name, e in enc_blocks.errors.items()}
    rec["bf16_encoder_block_rel_err"] = enc_worst
    print(f"{label} (b): each of the {cfg.enc_layers} encoder blocks on {tuple(frames.shape[:2])} "
          "frames in bfloat16 against float32 of the same weights on the same input, the worst: "
          + ", ".join(f"{k} {v:.2e}" for k, v in enc_worst.items())
          + f" (limit {BF16_REL})", flush=True)
    del frames
    torch.cuda.empty_cache()
    if not all(e <= BF16_REL for e in enc_worst.values()):
        raise RuntimeError(f"{label}: an encoder block in bfloat16 against float32, "
                           f"{enc_worst} over {BF16_REL}")

    # (c) the float32 handoff and (d) bfloat16 against float32 of the same
    # weights, on a float32 copy of the model
    head = model.embed["head"].detach().float()
    torch.cuda.reset_peak_memory_stats()
    f32 = build_model(dataclasses.replace(cfg, dtype="float32"), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        for dst, src in zip(f32.parameters(), model.parameters()):
            dst.copy_(src)
    rng = np.random.default_rng(3)
    n = HANDOFF_TOKENS
    frames = torch.as_tensor(rng.standard_normal((1, frames_n, cfg.frontend_dim)),
                             dtype=torch.float32, device=dev)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, n + 1)), device=dev)
    _, caches = f32.prefill(frames, toks[:, :n], max_seq=n + 1)
    lg_a, _ = f32.decode_step(toks[:, n:], caches, n)
    lg_b, _ = f32.prefill(frames, toks)
    handoff = rel_err(lg_a, lg_b.double())
    same = bool(torch.equal(lg_a.argmax(-1), lg_b.argmax(-1)))
    del caches
    if not (torch.isfinite(lg_a).all() and handoff <= F32_HANDOFF_REL):
        raise RuntimeError(f"{label}: float32 prefill handoff error {handoff:.3e} > "
                           f"{F32_HANDOFF_REL}")
    frames = torch.as_tensor(rng.standard_normal((4, frames_n, cfg.frontend_dim)),
                             dtype=torch.float32, device=dev)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (4, prompt + 16)), device=dev)
    _, c16 = model.prefill(frames, toks[:, :prompt], max_seq=prompt + 16)
    _, c32 = f32.prefill(frames, toks[:, :prompt], max_seq=prompt + 16)
    errs, agree, blocks = [], 0, BlockErrors()
    for t in range(prompt, prompt + 16):
        with blocks:
            lg16, c16 = model.decode_step(toks[:, t:t + 1], c16, t)
        lg32, c32 = f32.decode_step(toks[:, t:t + 1], c32, t)
        errs.append(rel_err(lg16, lg32.double()))
        agree += int((lg16.argmax(-1) == lg32.argmax(-1)).sum())
    worst = {name: max(e) for name, e in blocks.errors.items()}
    rec.update(f32_handoff_rel_err=handoff, f32_handoff_argmax_equal=same,
               bf16_block_rel_err=worst, bf16_step_rel_errs=errs, bf16_argmax_agree=agree / 64,
               f32_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"{label} (c): float32, the whole model: prefill({frames_n} frames, {n} tokens) then "
          f"a decode step against prefill({frames_n} frames, {n + 1} tokens), error "
          f"{handoff:.3e} of the largest logit (limit {F32_HANDOFF_REL}), argmax equal: {same}; "
          f"(d) bfloat16 against float32 of the same weights, each decoder block on the "
          f"bfloat16 run's input, 16 decode steps at B = 4 after a prefill of {frames_n} frames "
          f"and {prompt} tokens, the worst by block "
          f"{', '.join(f'{k} {v:.2e}' for k, v in worst.items())} (limit {BF16_REL}); the "
          f"logits after the first step {errs[0]:.3e} (limit {BF16_LOGITS_REL}), then by step "
          f"{', '.join(f'{e:.2e}' for e in errs[1:])}, argmax equal at {agree} of 64; card peak "
          f"{rec['f32_peak_gb']:.1f} GB", flush=True)
    del model, f32, c16, c32
    torch.cuda.empty_cache()
    over = {name: e for name, e in worst.items() if not e <= BF16_REL}
    if over:
        raise RuntimeError(f"{label}: bfloat16 against float32 of the same block, {over} over "
                           f"{BF16_REL}")
    if not errs[0] <= BF16_LOGITS_REL:
        raise RuntimeError(f"{label}: bfloat16 against float32, the logits of the first decode "
                           f"step: {errs[0]:.3e} > {BF16_LOGITS_REL}")

    # (e) the coded lm_head at the 256k vocabulary, each launch against its
    # plain version, then the multi design in turns against x @ head
    hold = hold_coded_head(f"{label} (e)", head, dev, compare)
    rec.update(head_hold_err=hold["head_err"], head_kernel_vs_plain=hold["errs"],
               head_launches=hold["counts"], **head_in_turns(f"{label} (e)", hold, head, in_turns))
    counts = hold["counts"]
    del hold, head
    torch.cuda.empty_cache()
    return {"coded_matvec": 0, "mds_encode": counts["mds_encode"],
            "mds_decode": counts["mds_decode"], "lstm_cell": counts["lstm_cell"],
            "coded_matvec (multi design, lm_head)": counts["coded_matvec"]}, rec


# -- 10. training on the card -------------------------------------------------

class Tee:
    """Writes to the real stdout and keeps a copy, to read what an entry
    point printed."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.lines)


class TrainProbe:
    """Records what ``launch.train.main`` ran: ``train``'s metrics (the
    module's own ``train`` wrapped by attribute), the host's clock at each
    ``CodedDPStep.step`` entry and at the last ``save_checkpoint`` call's
    entry (``train``'s final checkpoint), the card synchronised first, so
    that the interval from a step's entry to the next mark is one whole
    step (the coded gradients, the update, the log line and any checkpoint
    on the way, but not the final one), and the dead groups each step was
    given."""

    def __init__(self, dev):
        import repro_torch.launch.train as launch_train
        from repro_torch.runtime import train_loop
        from repro_torch.runtime.train_loop import CodedDPStep

        self.dev, self.metrics, self.starts, self.saved, self.dead = dev, [], [], None, []
        self._module, self._loop, self._cls = launch_train, train_loop, CodedDPStep
        self._train, self._save, self._step = (launch_train.train, train_loop.save_checkpoint,
                                               CodedDPStep.step)

    def __enter__(self):
        probe = self

        def train(*args, **kwargs):
            out = probe._train(*args, **kwargs)
            probe.metrics.append(out)
            return out

        def save(*args, **kwargs):
            probe.saved = probe.mark()
            return probe._save(*args, **kwargs)

        def step(self_, *args, **kwargs):
            probe.starts.append(probe.mark())
            probe.dead.append(sorted(kwargs.get("dead_groups") or ()))
            return probe._step(self_, *args, **kwargs)

        self._module.train, self._loop.save_checkpoint, self._cls.step = train, save, step
        return self

    def __exit__(self, *exc):
        self._module.train, self._loop.save_checkpoint, self._cls.step = (
            self._train, self._save, self._step)

    def mark(self) -> float:
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    def step_s(self) -> list:
        """Each step's seconds on the host's clock, the last one's up to the
        final checkpoint."""
        return [b - a for a, b in zip(self.starts, self.starts[1:] + [self.saved])]


def run_train_main(argv: list, dev, label: str, model=None) -> tuple:
    """``launch.train.main(argv)`` on ``dev``, or, where ``model`` is given,
    ``launch.train.run(parse_args(argv), model)``: (its metrics, its step
    times, what it printed, its peak memory in GB)."""
    import contextlib

    import torch

    from repro_torch.launch import train as launch_train

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    tee = Tee(sys.stdout)
    with TrainProbe(dev) as probe, contextlib.redirect_stdout(tee):
        argv = argv + ["--device", dev.type]
        rc = (launch_train.main(argv) if model is None
              else launch_train.run(launch_train.parse_args(argv), model))
    expect(f"{label}: launch.train's exit code", rc, 0)
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0
    step_s = probe.step_s()
    metrics = {**probe.metrics[-1], "dead_groups": probe.dead}
    losses = metrics["losses"]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"{label}: losses not all finite: {losses}")
    print(f"{label}: {len(losses)} steps, losses {[round(v, 4) for v in losses]}; median step "
          f"{statistics.median(step_s):.3f} s (min {min(step_s):.3f}, max {max(step_s):.3f}); "
          f"peak memory {peak:.2f} GB", flush=True)
    return metrics, step_s, tee.text(), peak


def coded_training_reckoning(model, n_groups: int) -> dict:
    """The peak of coded AdamW training of ``model`` (GB) as the JAX
    package's step holds it: the parameters, AdamW's two float32 moments,
    ``n_groups`` float32 coded trees, the decoded tree and its /n copy, one
    microbatch's gradients (the activations left out); and ``in_place``,
    the same less the decoded tree and its copy, which the port's
    ``CodedDPStep.step`` never allocates (it decodes into the coded
    trees)."""
    n = sum(p.numel() for p in model.parameters())
    size = sum(p.numel() * p.element_size() for p in model.parameters())
    parts = {"parameters": size, "adamw_state": 8 * n, "coded_trees": n_groups * 4 * n,
             "decoded_and_scaled": 2 * 4 * n, "microbatch_grads": size}
    total = sum(parts.values())
    return {k: v / 1e9 for k, v in parts.items()} | {
        "total": total / 1e9, "in_place": (total - parts["decoded_and_scaled"]) / 1e9}


def slstm_backward_at_width(dev, compare, reduced: bool) -> dict:
    """(c) One xlstm-125m sLSTM layer's scan (``ssm._slstm_scan``), float32,
    as the training path differentiates it (autograd through the loop): at
    B = 2, S = 64 its gradients (dr, db, dxw) against the same loop's in
    float64 on the same card tensors; then, at S = 64 and SLSTM_LONG_S, its
    forward and backward between CUDA events and the most memory the
    backward's graph held (the peak above what was allocated before the
    forward), beside the bytes of the outputs ``hs``, which is what a
    backward that replays the forward (the JAX package's custom VJP)
    would keep instead."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import ssm as SSM
    from repro_torch.models.params import initialize

    cfg = get_config(TRAIN_ARCH)
    if reduced:
        cfg = cfg.reduced()
    nh, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    bsz = SLSTM_BS[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    p = initialize(SSM.slstm_specs(cfg), gen, dev)
    r = p["r_gates"].float()
    bias = torch.randn(4 * cfg.d_model, generator=gen, device=dev) * 0.5
    on_card = dev.type == "cuda"

    def inputs(s):
        x = torch.randn(bsz, s, cfg.d_model, generator=gen, device=dev)
        xw = (x @ p["w_gates"].float()).reshape(bsz, s, nh, 4 * hd)
        return xw, torch.randn(bsz, s, nh, hd, generator=gen, device=dev)

    def grads(xw, g_hs, dtype=torch.float32):
        leaves = [t.detach().to(dtype).requires_grad_() for t in (r, bias, xw)]
        hs = SSM._slstm_scan(leaves[0], leaves[1].reshape(nh, -1), leaves[2])[0]
        return torch.autograd.grad(hs, leaves, g_hs.to(dtype))

    xw, g_hs = inputs(SLSTM_BS[1])
    errs = {}
    for name, got, want in zip(("dr", "db", "dxw"), grads(xw, g_hs),
                               grads(xw, g_hs, torch.float64)):
        scale = float(want.abs().max())
        errs[name] = compare(f"phase 10 (c): sLSTM backward {name} (float32 vs float64)",
                             got.double() / scale, want / scale, SLSTM_BWD_REL)
    runs = {}
    for s in (SLSTM_BS[1], SLSTM_LONG_S[reduced]):
        xw, g_hs = inputs(s)
        grads(xw, g_hs)
        times, graph_gb = [], 0.0
        for _ in range(2):
            if on_card:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = grads(xw, g_hs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            if on_card:
                graph_gb = max(graph_gb, (torch.cuda.max_memory_allocated() - base) / 1e9)
            del out
        hs_gb = bsz * s * cfg.d_model * 4 / 1e9
        runs[s] = {"ms": times, "graph_gb": graph_gb, "hs_gb": hs_gb}
        print(f"phase 10 (c): sLSTM scan forward + backward at B = {bsz}, S = {s}, "
              f"d = {cfg.d_model}, float32: {times} ms; the backward's graph peaked "
              f"{graph_gb:.4f} GB above the inputs (hs {hs_gb:.4f} GB)", flush=True)
    print(f"phase 10 (c): largest error against float64 over each gradient's largest value "
          f"{errs} (limit {SLSTM_BWD_REL})", flush=True)
    return {"rel_err": errs, "runs": runs, "b": bsz, "d": cfg.d_model}


def on_device(batch: dict, dev, rows: int) -> dict:
    """The first ``rows`` sequences of a ``TokenPipeline`` batch on ``dev``,
    as ``CodedDPStep`` moves a microbatch."""
    from repro_torch.runtime.train_loop import _to_device

    return _to_device({k: v[:rows] for k, v in batch.items()}, dev)


def microbatch_profile(label: str, model, mb: dict) -> dict:
    """One coded microbatch ``mb`` of ``model`` as ``CodedDPStep`` runs it
    (``loss_fn`` and ``torch.autograd.grad`` over every parameter) under
    ``torch.profiler``: its kernels' device time, launches and the device's
    idle share of the host's time."""
    import torch

    params = list(model.parameters())

    def step():
        return torch.autograd.grad(model.loss_fn(mb), params)

    step()
    got = device_kernel_ms(step, PROFILED_MICROBATCHES)
    del params
    if got is None:
        print(f"{label}: the profiler recorded no device time", flush=True)
        return {"kernel_ms": None}
    busy, host, launches, top = got
    rec = {"kernel_ms": busy, "host_ms": host, "launches": launches,
           "idle_share": 1 - busy / host, "top": top}
    print(f"{label}: a microbatch (B = {mb['tokens'].shape[0]}, S = {mb['tokens'].shape[1]}) "
          f"{host:.1f} ms on the host's clock, {busy:.2f} ms of kernels in {launches:.0f} "
          f"launches, idle {100 * rec['idle_share']:.1f} %; top {top}", flush=True)
    return rec


def family_config(arch: str, reduced: bool):
    """(f)'s config of ``arch``: full width (or the reduced config), at
    TRAIN_LAYERS' depth where it is cut there."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    if arch in TRAIN_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS[arch])
    return cfg


def slabs(t, size: int = 1 << 26) -> tuple:
    """``t`` flattened, in views of at most ``size`` elements: a float64
    temporary of gemma3-27b's 1.41 B-entry embedding gradient would take
    11.3 GB."""
    return t.reshape(-1).split(size)


def training_witness(model, mb: dict, label: str) -> dict:
    """(f) The loss and every gradient of ``model.loss_fn(mb)`` with the
    weights upcast in place to float32, then the same in float64 under
    :func:`float64_witness` (which fails if an op still returned float32),
    the float32 gradients kept on the host where the card could not hold
    both runs'.  Held: the loss and the gradient norm within MESH_TRAIN_TOL
    of the witness's, every leaf within MESH_TRAIN_UPDATE_TOL of the
    largest value of the witness's gradient of it.  For a MoE, the tokens
    whose experts differ between the two runs (layer 0's forward) are
    counted.  Leaves ``model`` in float64 for the caller to free; returns
    the record."""
    import dataclasses

    import torch

    dev = mb["tokens"].device
    cuda = dev.type == "cuda"
    moe = model.cfg.family == "moe"
    model.cfg = dataclasses.replace(model.cfg, dtype="float32")
    names = [n for n, _ in model.named_parameters()]
    runs = {}
    for dtype in ("float32", "float64"):
        witness = float64_witness() if dtype == "float64" else None
        if witness:
            model.double()
        else:
            model.float()
        routed = RoutedExperts() if moe else None
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        # a float input (seamless's frames) is made float64 outside the mode,
        # as the weights are: a .to() of its own dtype dispatches nothing
        batch = {k: v.double() if witness and v.is_floating_point() else v
                 for k, v in mb.items()}
        with witness or contextlib.nullcontext(), routed or contextlib.nullcontext():
            loss = model.loss_fn(batch)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        if cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if witness:
            float32_ops = dict(witness.float32)
            if float32_ops:
                raise RuntimeError(f"{label}: the float64 witness still made float32 tensors: "
                                   f"{float32_ops}")
        if not witness and cuda:
            size = sum(g.numel() * g.element_size() for g in grads)
            if torch.cuda.mem_get_info(dev)[0] < 4 * size + FREE_AFTER_BUILD:
                grads = [g.cpu() for g in grads]     # the float64 run's room
        runs[dtype] = {"loss": float(loss.detach()), "grads": grads, "s": secs,
                       "norm": math.sqrt(sum(float(torch.linalg.vector_norm(
                           c, dtype=torch.float64) ** 2) for g in grads for c in slabs(g))),
                       "experts": routed.experts[0] if routed else None}
        del loss, grads
    want, got = runs["float64"], runs["float32"]
    rel = {}
    for name, g32, g64 in zip(names, got["grads"], want["grads"]):
        top = float(g64.abs().max())
        diff = max(float((a.to(b.device, torch.float64) - b).abs().max())
                   for a, b in zip(slabs(g32), slabs(g64)))
        rel[name] = diff / top if top else (0.0 if diff == 0 else math.inf)
    failures = [f"{key} {got[key]!r} against the witness's {want[key]!r}"
                for key in ("loss", "norm")
                if not (math.isfinite(got[key])
                        and abs(got[key] - want[key]) <= MESH_TRAIN_TOL * abs(want[key]))]
    bad = {n: e for n, e in rel.items() if not e <= MESH_TRAIN_UPDATE_TOL}
    worst = max(rel, key=rel.get)
    rec = {"loss": got["loss"], "witness_loss": want["loss"], "grad_norm": got["norm"],
           "witness_grad_norm": want["norm"], "tol": MESH_TRAIN_TOL,
           "leaf_tol": MESH_TRAIN_UPDATE_TOL, "leaves": len(rel), "worst_leaf": worst,
           "worst_leaf_rel_err": rel[worst], "float32_s": got["s"], "float64_s": want["s"],
           "float32_ops": float32_ops, "tokens": mb["tokens"].numel()}
    if moe:
        rec["routed_otherwise"] = int((got["experts"].to(dev) != want["experts"]).any(-1).sum())
    runs.clear()
    print(f"{label}: the float64 witness on one sequence of the first batch "
          f"({mb['tokens'].shape[1]} tokens): loss {rec['loss']:.9f} against "
          f"{rec['witness_loss']:.9f}, gradient norm {rec['grad_norm']:.9f} against "
          f"{rec['witness_grad_norm']:.9f} (limit {MESH_TRAIN_TOL} of the witness's); the "
          f"worst of {len(rel)} leaves {worst} at {rel[worst]:.3e} of its largest witness "
          f"value (limit {MESH_TRAIN_UPDATE_TOL}); float32 {got['s']:.3f} s, float64 "
          f"{want['s']:.3f} s; no float32 tensor under the witness"
          + (f"; tokens routed otherwise in float32 than in float64: "
             f"{rec['routed_otherwise']} of {rec['tokens']}" if moe else ""), flush=True)
    if bad:
        failures.append(f"{len(bad)} leaves past {MESH_TRAIN_UPDATE_TOL} of their largest "
                        "witness value: " + ", ".join(
                            f"{n} {e:.2e}" for n, e in sorted(bad.items(),
                                                              key=lambda kv: -kv[1])[:8]))
    if failures:
        raise RuntimeError(f"{label}: " + "; ".join(failures))
    return rec


def train_family(arch: str, dev, tmp: str, reduced: bool) -> dict:
    """(f) ``arch`` built at ``family_config``'s depth from seed 0, first
    checked to fit (its in-place reckoning and FREE_AFTER_BUILD within the
    card's free memory; seamless falls back to TRAIN_FALLBACK_GROUPS, the
    others fail, none shrinks), trained for BIG_STEPS steps through
    ``launch.train.run`` with TRAIN_FLAGS, then one coded microbatch of
    the run's first batch under the profiler, and the float64 witness
    (:func:`training_witness`) on that batch's first sequence with the
    weights the run started from (drawn again from seed 0).  Returns the
    record."""
    import gc
    import shutil

    import torch

    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model

    label = f"phase 10 (f) {arch}"
    cuda = dev.type == "cuda"
    t_start = time.perf_counter()
    cfg = family_config(arch, reduced)
    flags = list((TRAIN_FLAGS_REDUCED if reduced else TRAIN_FLAGS)[arch])
    meta = build_model(cfg, device="meta")
    n_params = sum(p.numel() for p in meta.parameters())
    gc.collect()
    if cuda:        # the allocator's cache of earlier phases is not free to the device
        torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0] if cuda else math.inf
    held = torch.cuda.memory_allocated(dev) / 1e9 if cuda else 0.0
    for groups, tolerate in [(int(flags[flags.index("--groups") + 1]),
                              int(flags[flags.index("--tolerate") + 1]))] + (
                                  [TRAIN_FALLBACK_GROUPS[arch]]
                                  if arch in TRAIN_FALLBACK_GROUPS else []):
        reckoned = coded_training_reckoning(meta, groups)
        if reckoned["in_place"] * 1e9 + FREE_AFTER_BUILD <= free:
            break
        print(f"{label}: {groups} groups reckon {reckoned['in_place']:.2f} GB in place, "
              f"more than the card's {free / 1e9:.2f} GB free less "
              f"{FREE_AFTER_BUILD / 2**30:.0f} GiB ({held:.2f} GB still allocated)", flush=True)
    else:
        raise RuntimeError(f"{label} does not fit the card at any of its groups")
    flags[flags.index("--groups") + 1] = str(groups)
    flags[flags.index("--tolerate") + 1] = str(tolerate)
    del meta
    layers = (f"{cfg.enc_layers} + {cfg.num_layers}" if cfg.is_encdec else str(cfg.num_layers))
    print(f"{label}: {layers} layers, d_model {cfg.d_model}, {n_params:,} parameters, flags "
          f"{' '.join(flags)}; reckoned {reckoned['total']:.2f} GB, in place "
          f"{reckoned['in_place']:.2f} GB, the card's free memory "
          f"{free / 1e9 if cuda else 0.0:.2f} GB ({held:.2f} GB still allocated)", flush=True)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    if cuda:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ckpt = os.path.join(tmp, arch)
    argv = flags + ["--steps", str(BIG_STEPS), "--ckpt-dir", ckpt]
    t0 = time.perf_counter()
    metrics, step_s, _, peak = run_train_main(argv, dev, label, model=model)
    run_s = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    expect(f"{label}: steps run", len(metrics["losses"]), BIG_STEPS)
    print(f"{label}: peak memory {peak:.2f} GB; reckoned {reckoned['total']:.2f} GB, in place "
          f"{reckoned['in_place']:.2f} GB (" + ", ".join(
              f"{k} {v:.2f}" for k, v in reckoned.items() if k not in ("total", "in_place"))
          + f"); build {build_s:.2f} s, run {run_s:.2f} s", flush=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    args = launch_train.parse_args(argv + ["--device", dev.type])
    first = launch_train.make_pipeline(cfg, args).next_batch()
    profile = microbatch_profile(label, model, on_device(first, dev, args.batch // groups))
    # the witness on the weights the run's first batch met: drawn again
    del model
    gc.collect()
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    witness = training_witness(model, on_device(first, dev, 1), label)
    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rec = {"arch": arch, "layers": cfg.num_layers, "enc_layers": cfg.enc_layers,
           "d_model": cfg.d_model, "parameters": n_params, "flags": flags, "groups": groups,
           "tolerate": tolerate, "steps": BIG_STEPS, "losses": metrics["losses"],
           "step_s": step_s, "build_s": build_s, "run_s": run_s, "peak_gb": peak,
           "free_gb": free / 1e9 if cuda else None, "reckoned_gb": reckoned,
           "microbatch": profile, "witness": witness,
           "phase_s": time.perf_counter() - t_start}
    print(f"{label}: {rec['phase_s']:.1f} s", flush=True)
    return rec


def train_phase(dev, compare, reduced: bool = False) -> tuple:
    """Phase 10: train on the card through ``launch.train``: (a)
    xlstm-125m whole, coded DP over 8 groups with group 3 dead from step
    10, then a restart that resumes from its checkpoint; (b) zamba2-1.2b
    whole, BIG_STEPS coded AdamW steps, its peak memory beside the reckoning; (c)
    the sLSTM scan's backward at full width against float64, timed and its
    graph's memory read at S = 64 and SLSTM_LONG_S; (d) every kernel
    counter at 0 over (a)-(f); (e) one microbatch of each under the
    profiler; (f) TRAIN_FAMILIES at full width (:func:`train_family`),
    each through ``launch.train.run`` and held to a float64 witness.
    ``reduced`` runs the reduced configs and fewer steps, as the CPU test
    does.  Returns the kernels' launches over (a)-(f) by record name, and
    the phase's record."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    steps, more, batch, seq = TRAIN_STEPS_REDUCED if reduced else TRAIN_STEPS
    small = ["--reduced"] if reduced else []
    record = {}
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        # (a) xlstm-125m: the example's flags at full width, then a restart
        flags = ["--arch", TRAIN_ARCH, "--coded-dp", "--groups", "8", "--tolerate", "2",
                 "--fail-group", "3", "--batch", str(batch), "--seq", str(seq),
                 "--ckpt-dir", os.path.join(tmp, "xlstm")] + small
        t0 = time.perf_counter()
        first, step_s, out, peak = run_train_main(flags + ["--steps", str(steps)], dev,
                                                  "phase 10 (a) xlstm-125m")
        first_s = time.perf_counter() - t0
        if "[train] loss_improved=True" not in out.splitlines():
            raise RuntimeError("phase 10 (a): launch.train.main did not print "
                               "loss_improved=True")
        if "dead=[3]" not in out:
            raise RuntimeError("phase 10 (a): group 3 was not dead at step 10")
        expect("phase 10 (a): steps run", len(first["losses"]), steps)
        expect("phase 10 (a): the steps with group 3 dead",
               [i for i, d in enumerate(first["dead_groups"]) if d],
               list(range(10, min(10 + DEAD_STEPS, steps))))
        expect("phase 10 (a): the dead group", {tuple(d) for d in first["dead_groups"] if d},
               {(3,)})
        resumed, resumed_step_s, _, _ = run_train_main(flags + ["--steps", str(more)], dev,
                                                       "phase 10 (a) xlstm-125m, restarted")
        # resumed from the last checkpoint (step steps - 1) with the cursor
        expect("phase 10 (a): steps run after the restart", len(resumed["losses"]),
               more - steps)
        record["xlstm"] = {
            "arch": TRAIN_ARCH, "steps": steps, "restart_steps": more, "batch": batch,
            "seq": seq, "groups": 8, "tolerate": 2, "fail_group": 3,
            "losses": first["losses"], "final_loss": first["final_loss"],
            "restart_losses": resumed["losses"], "loss_improved": True,
            "dead_steps": DEAD_STEPS,
            "step_s": step_s, "median_step_s": statistics.median(step_s),
            "restart_step_s": resumed_step_s, "run_s": first_s, "peak_gb": peak,
            "microbatches_per_step": 8 * 3}

        # (b) zamba2-1.2b whole: BIG_STEPS coded AdamW steps, 8 groups
        meta = build_model(get_config(TRAIN_BIG) if not reduced
                           else get_config(TRAIN_BIG).reduced(), device="meta")
        reckoned = coded_training_reckoning(meta, 8)
        del meta
        big, big_step_s, _, big_peak = run_train_main(
            ["--arch", TRAIN_BIG, "--coded-dp", "--groups", "8", "--tolerate", "2",
             "--batch", str(batch), "--seq", str(seq), "--steps", str(BIG_STEPS),
             "--ckpt-dir", os.path.join(tmp, "zamba2")] + small, dev, "phase 10 (b) zamba2-1.2b")
        expect("phase 10 (b): steps run", len(big["losses"]), BIG_STEPS)
        print(f"phase 10 (b): zamba2-1.2b peak memory {big_peak:.2f} GB; reckoned "
              f"{reckoned['total']:.2f} GB, in place {reckoned['in_place']:.2f} GB (" + ", ".join(
                  f"{k} {v:.2f}" for k, v in reckoned.items() if k not in ("total", "in_place"))
              + ")", flush=True)
        shutil.rmtree(os.path.join(tmp, "zamba2"), ignore_errors=True)
        record["zamba2"] = {"arch": TRAIN_BIG, "steps": BIG_STEPS, "losses": big["losses"],
                            "step_s": big_step_s, "peak_gb": big_peak,
                            "reckoned_gb": reckoned}
    # (c) the sLSTM scan's backward at full width
    record["slstm_backward"] = slstm_backward_at_width(dev, compare, reduced)
    # (e) where a step's time goes: one microbatch of each under the profiler
    for key, arch in (("xlstm", TRAIN_ARCH), ("zamba2", TRAIN_BIG)):
        cfg = get_config(arch).reduced() if reduced else get_config(arch)
        model = build_model(cfg, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(0))
        mb = on_device(TokenPipeline(vocab_size=cfg.vocab_size, batch=2, seq_len=seq,
                                     seed=0).next_batch(), dev, 2)
        record[key]["microbatch"] = microbatch_profile(f"phase 10 (e) {arch}", model, mb)
        del model, mb
    # (f) the four families never trained on the card before, at full width
    print(f"phase 10 (f): TRAIN_FAMILIES {TRAIN_FAMILIES}, TRAIN_LAYERS {TRAIN_LAYERS}, "
          f"TRAIN_FLAGS {TRAIN_FLAGS_REDUCED if reduced else TRAIN_FLAGS}, BIG_STEPS "
          f"{BIG_STEPS}", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_families_") as tmp:
        record["families"] = {arch: train_family(arch, dev, tmp, reduced)
                              for arch in TRAIN_FAMILIES}
    launches = ops.launch_counts()
    designs = ops.design_counts()
    # (d) the training path reaches no kernel, as the JAX package's reaches
    # no Pallas kernel: every counter reads 0 across (a)-(f)
    expect("phase 10 (d): kernel launches while training", launches,
           dict.fromkeys(launches, 0))
    expect("phase 10 (d): designs launched while training", designs,
           {k: dict.fromkeys(v, 0) for k, v in designs.items()})
    print(f"phase 10 (d): launches over (a)-(f): {launches}", flush=True)
    record["launches"] = launches
    return launches, record


# -- 11. the worker mesh and the step builders ------------------------------

def mesh_memory_reckoning(rows: int, cols: int, n: int, k: int, chunks: int) -> dict:
    """What phase 11 (a)'s ranks allocate on the card in all (GB), by the
    port's code: each rank's coded partition, one chunk's k row slabs and
    the encode's output for them, its padded partials, the gathered
    partials of all n, y, and the decode's tables (CUDA contexts aside)."""
    part_rows = -(-rows // (k * chunks)) * chunks
    rpc = part_rows // chunks
    per_rank = {"partition": part_rows * cols * 4, "slab": k * rpc * cols * 4,
                "encoded_slab": rpc * cols * 4, "partials": chunks * rpc * 4,
                "gathered": n * chunks * rpc * 4, "y": k * part_rows * 4}
    out = {name: n * b / 1e9 for name, b in per_rank.items()}
    # the slab and its encode are freed once the partition is whole
    out["peak_per_rank"] = (per_rank["partition"] + per_rank["slab"]
                            + per_rank["encoded_slab"]) / 1e9
    out["total"] = n * out["peak_per_rank"]
    return out


def mesh_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of phase 11 (a), in a process of its own: a gloo group of
    ``world`` ranks sharing one card (NCCL refuses two ranks on one
    device), the worker mesh, this rank's partition encoded from the host's
    A, and the iterations of ``spec.json``'s allocations; writes
    ``rank<rank>.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import coded_matmul as CM
    from repro_torch.core.coding import MDSCode
    from repro_torch.core.s2c2 import general_allocation
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_worker_mesh

    tmp = Path(tmp)
    spec = json.loads((tmp / "spec.json").read_text())
    dev = torch.device(spec["device"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'rendezvous'}", rank=rank,
                            world_size=world)
    try:
        mesh = make_worker_mesh(world, device_type=dev.type)
        cm = CM.CodedMatvec(MDSCode(spec["n"], spec["k"]), spec["chunks"], device=dev,
                            mesh=mesh)
        combine: list = []
        gather = CM._all_gather

        def timed_gather(*args):
            """The combine alone: the partials finished before, y's decode after."""
            sync()
            t0 = time.perf_counter()
            out = gather(*args)
            sync()
            combine.append(time.perf_counter() - t0)
            return out

        CM._all_gather = timed_gather
        a = torch.from_numpy(np.load(tmp / "a.npy", mmap_mode="c"))   # the host's one copy
        xs = torch.from_numpy(np.load(tmp / "xs.npy")).to(dev)
        yref = np.load(tmp / "yref.npy", mmap_mode="r")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        dist.barrier()
        t0 = time.perf_counter()
        part = cm.shard(a)
        sync()
        encode_s = time.perf_counter() - t0
        iter_s, errors = [], []
        for it, speeds in enumerate(spec["speeds"]):
            x = xs[:, it].contiguous()
            dist.barrier()
            t0 = time.perf_counter()              # plan (host) and apply
            tables = cm.plan_tables(general_allocation(speeds, spec["k"], spec["chunks"]))
            y = cm.apply(part, x, *tables)
            sync()
            iter_s.append(time.perf_counter() - t0)
            want = yref[:, it]
            got = y[:want.shape[0]].double().cpu().numpy()
            if not np.isfinite(got).all():
                raise RuntimeError(f"rank {rank}, iteration {it}: y is not finite")
            errors.append(float(np.abs(got - want).max() / np.abs(want).max()))
        dist.barrier()                       # every rank's memory is in place
        card_used = None
        if dev.type == "cuda" and rank == 0:
            card_used = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
        peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0
        dist.barrier()
        (tmp / f"rank{rank}.json").write_text(json.dumps({
            "launches": ops.launch_counts(), "designs": ops.design_counts(),
            "encode_s": encode_s, "iter_s": iter_s, "combine_s": combine, "rel_err": errors,
            "peak_gb": peak, "card_used_mib": card_used, "rows": part.shape[0]}))
    finally:
        dist.destroy_process_group()


def mesh_iterations(dev, reduced: bool) -> tuple[dict, dict]:
    """Phase 11 (a): the main path across a worker mesh of n = 12 ranks
    that share the card over gloo, spawned here.  A is made once in host memory
    (a file-backed array every rank maps), with its float64 products on the
    card; the allocations are phase 4's (the predictor on the card over
    ``controlled_traces(12, 30, 2, seed=7)``).  Returns the launches by
    kernel (the ranks' summed, the predictor's in this process) and the
    record."""
    import multiprocessing
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.convert import load_params
    from repro_torch.core.predictor import SpeedPredictor
    from repro_torch.core.traces import controlled_traces
    from repro_torch.kernels import ops

    n, k, chunks, rows, cols, iters = (MESH_SIZE_REDUCED if reduced
                                       else (N, K, CHUNKS, ROWS, COLS, MESH_ITERS))
    reckoned = mesh_memory_reckoning(rows, cols, n, k, chunks)
    print("phase 11 (a): memory reckoned on the card: " + ", ".join(
        f"{k} {v:.3f} GB" for k, v in reckoned.items()), flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    procs: list = []
    try:
        t0 = time.perf_counter()
        a = np.lib.format.open_memmap(tmp / "a.npy", mode="w+", dtype=np.float32,
                                      shape=(rows, cols))
        gen = torch.Generator(device=dev).manual_seed(11)
        xs = torch.randn(cols, iters, generator=gen, device=dev)
        yref = torch.empty(rows, iters, dtype=torch.float64, device=dev)
        slab = 60_000
        for r0 in range(0, rows, slab):
            blk = torch.randn(min(slab, rows - r0), cols, generator=gen, device=dev)
            a[r0:r0 + blk.shape[0]] = blk.cpu().numpy()
            yref[r0:r0 + blk.shape[0]] = blk.double() @ xs.double()
        a.flush()
        del a, blk
        np.save(tmp / "xs.npy", xs.cpu().numpy())
        np.save(tmp / "yref.npy", yref.cpu().numpy())
        del xs, yref
        ops.reset_launch_counts()
        predictor = SpeedPredictor(n, load_params(device=dev), device=dev)
        traces = controlled_traces(n, ITERS, n_stragglers=2, seed=7)
        speeds = []
        for it in range(iters):
            speeds.append(np.asarray(predictor.predict(), dtype=np.float64).tolist())
            predictor.observe(traces[it])
        predictor_launches = ops.launch_counts()
        del predictor
        (tmp / "spec.json").write_text(json.dumps({"device": dev.type, "n": n, "k": k,
                                                   "chunks": chunks, "speeds": speeds}))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        made_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=mesh_rank, args=(r, n, str(tmp))) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + MESH_TIMEOUT
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0))
        ranks_s = time.perf_counter() - t0
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        if alive:
            raise RuntimeError(f"phase 11 (a): ranks {alive} still running after "
                               f"{MESH_TIMEOUT} s")
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
        if failed:
            raise RuntimeError(f"phase 11 (a): ranks exited with {failed}")
        results = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    worst = max(max(r["rel_err"]) for r in results)
    if worst > REL_ERR_LIMIT:
        raise RuntimeError(f"phase 11 (a): relative error {worst:.3e} > {REL_ERR_LIMIT}")
    for r, res in enumerate(results):
        got = res["launches"]
        print(f"phase 11 (a) rank {r}: launches {got}; coded_matvec designs "
              f"{res['designs']['coded_matvec']}; encode {res['encode_s'] * 1e3:.1f} ms; "
              f"peak {res['peak_gb']:.3f} GB", flush=True)
        if dev.type == "cuda":
            expect(f"phase 11 (a) rank {r}: mds_encode launches (one a chunk)",
                   got["mds_encode"], chunks)
            expect(f"phase 11 (a) rank {r}: mds_decode launches (one an iteration)",
                   got["mds_decode"], iters)
            if not 0 < got["coded_matvec"] <= iters:
                raise RuntimeError(f"phase 11 (a) rank {r}: coded_matvec launched "
                                   f"{got['coded_matvec']} times in {iters} iterations")
            expect(f"phase 11 (a) rank {r}: coded_matvec designs",
                   res["designs"]["coded_matvec"],
                   {"stream": got["coded_matvec"], "split": 0, "multi": 0, "general": 0})
    launches = {name: sum(r["launches"][name] for r in results) for name in KERNELS}
    launches["lstm_cell"] += predictor_launches["lstm_cell"]
    first = results[0]
    iter_med = statistics.median(first["iter_s"])
    combine_med = statistics.median(first["combine_s"])
    card_gb = (int(first["card_used_mib"]) * 2**20 / 1e9 if first["card_used_mib"] is not None
               else None)
    alloc_gb = sum(r["peak_gb"] for r in results)
    print(f"phase 11 (a): {n} ranks over gloo on one card, {rows:,} x {cols:,}, {iters} "
          f"iterations: rank 0's median {iter_med * 1e3:.3f} ms (min "
          f"{min(first['iter_s']) * 1e3:.3f}, max {max(first['iter_s']) * 1e3:.3f}), the "
          f"combine {combine_med * 1e3:.3f} ms ({combine_med / iter_med:.1%}); worst relative "
          f"error {worst:.3e}; encode (rank 0) {first['encode_s']:.2f} s; the ranks' peak "
          f"allocations {alloc_gb:.3f} GB in all against {reckoned['total']:.3f} reckoned; the "
          f"card's memory in use {card_gb} GB with the {n} contexts; A made in {made_s:.1f} s, "
          f"the ranks ran {ranks_s:.1f} s", flush=True)
    record = {"ranks": n, "k": k, "chunks": chunks, "rows": rows, "cols": cols, "iters": iters,
              "rank0_iter_ms": [t * 1e3 for t in first["iter_s"]],
              "rank0_median_ms": iter_med * 1e3, "rank0_combine_median_ms": combine_med * 1e3,
              "combine_share": combine_med / iter_med,
              "iter_median_ms_by_rank": [statistics.median(r["iter_s"]) * 1e3 for r in results],
              "encode_s_by_rank": [r["encode_s"] for r in results], "worst_rel_err": worst,
              "peak_gb_by_rank": [r["peak_gb"] for r in results], "peak_gb_sum": alloc_gb,
              "card_used_gb": card_gb, "reckoned_gb": reckoned,
              "launches_by_rank": [r["launches"] for r in results], "made_s": made_s,
              "ranks_s": ranks_s}
    return launches, record


def step_train(dev, reduced: bool) -> dict:
    """Phase 11 (b): ``build_train_step`` on zamba2-1.2b whole at
    ``train_4k``'s sequence, the global batch cut to STEP_TRAIN_BATCH,
    ``grad_accum_for``'s microbatches, ``cfg.optimizer``; STEP_TRAIN_STEPS
    steps, every loss and gradient norm finite."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, shape_by_name
    from repro_torch.convert import group
    from repro_torch.launch.steps import build_train_step, grad_accum_for
    from repro_torch.models import build_model
    from repro_torch.optim.optimizer import make_optimizer

    cfg = get_config(STEP_TRAIN_ARCH)
    shape = dataclasses.replace(shape_by_name("train_4k"), global_batch=STEP_TRAIN_BATCH)
    if reduced:
        cfg = cfg.reduced()
        shape = dataclasses.replace(shape, seq_len=64, global_batch=4)
    accum = grad_accum_for(cfg, shape)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev)
    opt = make_optimizer(cfg.optimizer, lr=1e-4)      # build_train_step's default
    state = opt.init(group(dict(model.named_parameters()), model))
    step = build_train_step(cfg, shape, opt=opt)
    gen = torch.Generator(device=dev).manual_seed(5)
    losses, norms, step_s = [], [], []
    for i in range(STEP_TRAIN_STEPS_REDUCED if reduced else STEP_TRAIN_STEPS):
        toks = torch.randint(0, cfg.vocab_size, (shape.global_batch, shape.seq_len),
                             generator=gen, device=dev, dtype=torch.int32)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(model, state, i, {"tokens": toks, "labels": toks})
        losses.append(float(metrics["loss"]))          # synchronises
        norms.append(float(metrics["grad_norm"]))
        step_s.append(time.perf_counter() - t0)
    if not all(math.isfinite(v) for v in losses + norms):
        raise RuntimeError(f"phase 11 (b): losses {losses}, grad norms {norms} not all finite")
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0
    print(f"phase 11 (b): build_train_step on {cfg.name}, {shape.global_batch} x "
          f"{shape.seq_len} tokens in {accum} microbatches, {opt.name}: losses "
          f"{[round(v, 4) for v in losses]}, grad norms {[round(v, 4) for v in norms]}, steps "
          f"{[round(t, 3) for t in step_s]} s; peak memory {peak:.2f} GB", flush=True)
    del model, state
    return {"arch": cfg.name, "batch": shape.global_batch, "seq": shape.seq_len,
            "accum": accum, "optimizer": opt.name, "losses": losses, "grad_norms": norms,
            "step_s": step_s, "peak_gb": peak}


def step_serve(dev, reduced: bool) -> dict:
    """Phase 11 (c): ``build_prefill_step`` and ``build_decode_step`` on
    mistral-nemo-12b whole in bfloat16, STEP_SERVE_BATCH prompts of
    STEP_SERVE_PROMPT tokens and STEP_SERVE_STEPS greedy steps: bit for bit
    ``LM.prefill`` and ``LM.decode_step`` called directly; then the same
    with the parameters placed by ``param_shardings`` on a (1, 1) mesh over
    a world-size-1 NCCL group (gloo on the CPU), whose tokens must be the
    unplaced run's."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_decode_step, build_prefill_step, shard_model
    from repro_torch.models import build_model

    cfg = get_config(STEP_SERVE_ARCH)
    b, prompt, steps = STEP_SERVE_BATCH, STEP_SERVE_PROMPT, STEP_SERVE_STEPS
    if reduced:
        cfg, prompt, steps = cfg.reduced(), 32, 4
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen, device=dev,
                           dtype=torch.int32)
    max_seq = prompt + steps
    prefill, decode = build_prefill_step(cfg), build_decode_step(cfg)

    def greedy(run_prefill, run_decode) -> tuple:
        """(the prefill's logits, the tokens of every step, the prefill's
        seconds, each step's seconds)."""
        sync()
        t0 = time.perf_counter()
        logits, caches = run_prefill()
        sync()
        prefill_s = time.perf_counter() - t0
        full = logits.full_tensor() if hasattr(logits, "full_tensor") else logits
        tok = torch.argmax(full, -1).to(torch.int32)[:, None]
        toks, step_s = [tok], []
        for i in range(steps):
            t0 = time.perf_counter()
            tok, caches = run_decode(tok, caches, prompt + i)
            tok = tok.full_tensor() if hasattr(tok, "full_tensor") else tok
            sync()
            step_s.append(time.perf_counter() - t0)
            toks.append(tok)
        return full, torch.cat(toks, 1), prefill_s, step_s

    def direct_decode(tok, caches, pos):
        logits, caches = model.decode_step(tok, caches, pos)
        return torch.argmax(logits, -1).to(torch.int32)[:, None], caches

    def step_decode(tok, caches, pos):
        return decode(model, {"token": tok, "caches": caches, "pos": pos})

    direct = greedy(lambda: model.prefill(tokens, max_seq=max_seq), direct_decode)
    built = greedy(lambda: prefill(model, {"tokens": tokens}, max_seq=max_seq), step_decode)
    if not torch.equal(built[0], direct[0]):
        raise RuntimeError("phase 11 (c): build_prefill_step's logits are not LM.prefill's")
    if not torch.equal(built[1], direct[1]):
        raise RuntimeError("phase 11 (c): build_decode_step's tokens are not LM.decode_step's")
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0
    # the parameters placed on a (1, 1) mesh
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/rendezvous", rank=0, world_size=1)
        try:
            mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
            shard_model(model, mesh)
            placed = greedy(lambda: prefill(model, {"tokens": tokens}, max_seq=max_seq),
                            step_decode)
        finally:
            dist.destroy_process_group()
    if not torch.equal(placed[1], direct[1]):
        raise RuntimeError("phase 11 (c): the tokens on the (1, 1) mesh are not the unplaced "
                           "run's")
    placed_logits_err = float((placed[0].float() - direct[0].float()).abs().max())
    print(f"phase 11 (c): build_prefill_step + build_decode_step on {cfg.name}, {b} x {prompt} "
          f"tokens then {steps} greedy steps: bit for bit LM.prefill and LM.decode_step; "
          f"prefill {built[2]:.3f} s (direct {direct[2]:.3f}), a step's median "
          f"{statistics.median(built[3]) * 1e3:.3f} ms (direct "
          f"{statistics.median(direct[3]) * 1e3:.3f}); on the (1, 1) mesh the same tokens, "
          f"the prefill's logits within {placed_logits_err:.3e}, prefill {placed[2]:.3f} s, a "
          f"step's median {statistics.median(placed[3]) * 1e3:.3f} ms; peak memory "
          f"{peak:.2f} GB", flush=True)
    del model
    return {"arch": cfg.name, "batch": b, "prompt": prompt, "steps": steps,
            "tokens_equal": True, "prefill_s": built[2], "direct_prefill_s": direct[2],
            "step_ms": [t * 1e3 for t in built[3]], "direct_step_ms": [t * 1e3 for t in direct[3]],
            "mesh_prefill_s": placed[2], "mesh_step_ms": [t * 1e3 for t in placed[3]],
            "mesh_prefill_logits_max_abs_err": placed_logits_err, "peak_gb": peak}


def mesh_serve_inputs(cfg, b: int, prompt: int, dev) -> dict:
    """Phase 11 (d)'s prompts: B x P tokens (and B x P frames for the
    encoder-decoder, drawn in bfloat16), from seed 13."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(13)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen, device=dev,
                                   dtype=torch.int32)}
    if cfg.is_encdec:
        out["frames"] = torch.randn(b, prompt, cfg.frontend_dim, generator=gen, device=dev,
                                    dtype=torch.bfloat16)
    return out


def mesh_config(arch: str, reduced: bool, layers: int = 0):
    """Phase 11 (d)'s and (e)'s config of ``arch``: its reduced float32
    smoke config when ``reduced``, else the whole config at ``layers``
    where given, or at MESH_SERVE_LAYERS' depth where that names the
    arch."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if reduced:
        return cfg.reduced()
    layers = layers or MESH_SERVE_LAYERS.get(arch, 0)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def mesh_serve_model(arch: str, reduced: bool, dtype: str, dev, layers: int = 0):
    """Phase 11 (d)'s and (e)'s model of ``arch`` (``mesh_config``) in
    ``dtype``, its weights drawn from seed 0 in bfloat16
    and, for float32, upcast: both dtypes serve the same weights.  Returns
    (config, model)."""
    import dataclasses

    import torch

    from repro_torch.models import build_model

    cfg = mesh_config(arch, reduced, layers)
    drawn = dataclasses.replace(cfg, dtype="bfloat16")
    model = build_model(drawn, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    if dtype == "bfloat16":
        return drawn, model
    cfg = dataclasses.replace(cfg, dtype=dtype)
    model.cpu()              # the card holds one whole copy at a time, the float32 one
    wide = build_model(cfg, device="meta").to_empty(device=dev)
    with torch.no_grad():
        for w, p in zip(wide.parameters(), model.parameters()):
            w.copy_(p)
    return cfg, wide


def mesh_serve_run(model, cfg, batch: dict, steps: int, feed=None, check=None) -> dict:
    """``build_prefill_step`` with room for ``steps`` tokens, then ``steps``
    calls of ``build_decode_step``: each step decodes ``feed[:, t]`` (the
    unsharded run's greedy tokens) or, without ``feed``, the last greedy
    token.  Returns the prefill's and every step's logits (gathered,
    float32, on the host), the prefill's greedy token (``steps.greedy``, the
    sampler ``build_decode_step`` calls) and each step's, the tokens fed,
    the prefill's and each step's seconds, ``check(caches)`` after the
    prefill and after every step, and the caches after the last step."""
    import torch

    from repro_torch.launch.partition import place_local
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.launch.steps import greedy as pick

    tokens = batch["tokens"]
    dev = tokens.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t   # noqa: E731
    prompt = tokens.shape[1] + (cfg.frontend_tokens if "image_embeds" in batch else 0)
    seen: list = []
    decode = model.decode_step

    def probe(token, caches, pos):
        logits, caches = decode(token, caches, pos)
        seen.append(whole(logits).float().cpu())
        return logits, caches

    model.decode_step = probe
    checked: list = []
    try:
        sync()
        t0 = time.perf_counter()
        logits, caches = build_prefill_step(cfg)(model, batch, max_seq=prompt + steps)
        sync()
        prefill_s = time.perf_counter() - t0
        first = tok = whole(pick(logits)).cpu()
        logits = whole(logits).float().cpu()
        checked.append(check(caches) if check else True)
        step, step_s, greedy, fed = build_decode_step(cfg), [], [], []
        for t in range(steps):
            tok = feed[:, t:t + 1] if feed is not None else tok
            fed.append(tok)
            token = tok.to(dev).contiguous()
            if hasattr(tokens, "device_mesh"):
                token = place_local(token, tokens.device_mesh, tokens.placements)
            sync()
            t0 = time.perf_counter()
            nxt, caches = step(model, {"token": token, "caches": caches,
                                       "pos": torch.tensor(prompt + t)})
            tok = whole(nxt).cpu()
            sync()
            step_s.append(time.perf_counter() - t0)
            greedy.append(tok)
            checked.append(check(caches) if check else True)
    finally:
        del model.decode_step        # the class's method again (a bound one would hold a cycle)
    return {"prefill": logits, "logits": torch.stack(seen), "first": first,
            "greedy": torch.cat(greedy, 1), "fed": torch.cat(fed, 1), "prefill_s": prefill_s,
            "step_s": step_s, "placed": checked, "caches": caches}


def caches_placed(mesh, caches) -> bool:
    """Whether every cache and recurrent state in ``caches`` is a DTensor
    placed as ``cache_sharding_rules`` places it on ``mesh``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import sharding as SH

    want = SH.cache_sharding_rules(mesh, caches)
    return all(isinstance(c, DTensor) and tuple(c.placements) == w.placements
               for entry, went in zip(caches, want) for kind, state in entry.items()
               for (_, c), w in zip(state.items(), went[kind].values()))


def stage_gloo_collectives() -> list:
    """Route DTensor's all-gathers, reduce-scatters and all-to-alls of CUDA
    tensors through host memory, for ranks that share one card over gloo:
    gloo all-reduces CUDA tensors but crashes gathering them into one
    tensor (torch 2.11 on the card), and has no all-to-all; NCCL refuses
    two ranks on one device.  Phase 11 (a)'s combine stages through the host
    for the same reason.  Each wrapped function is replaced wherever
    ``torch.distributed`` holds it; returns the names wrapped."""
    import torch
    import torch.distributed._functional_collectives as funcol

    def staged(fn):
        def run(t, *args, **kwargs):
            if not t.is_cuda:
                return fn(t, *args, **kwargs)
            out = fn(t.cpu(), *args, **kwargs)
            return (out.wait() if hasattr(out, "wait") else out).to(t.device)
        return run

    def gather(t, gather_dim: int, mesh, dim: int):
        """An all-gather along ``gather_dim`` over the mesh dim ``dim``, as
        a sum of zero-padded copies (gloo's CUDA all-reduce)."""
        rank, world, n = mesh.get_local_rank(dim), mesh.size(dim), t.shape[gather_dim]
        shape = list(t.shape)
        shape[gather_dim] *= world
        out = t.new_zeros(shape)
        out.narrow(gather_dim, rank * n, n).copy_(t)
        done = funcol.all_reduce(out, "sum", (mesh, dim))
        return done.wait() if hasattr(done, "wait") else done

    replaced = {}             # id of the original -> (original, wrapper)
    for op in ("all_gather", "reduce_scatter"):
        for form in ("tensor", "single", "tensor_autograd", "single_autograd"):
            fn = getattr(funcol, f"{op}_{form}", None)
            if fn is not None:
                replaced[id(fn)] = (fn, staged(fn))

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim, *rest, **kw):
        full = gather(input, gather_dim, mesh, mesh_dim)
        return full.chunk(mesh.size(mesh_dim), dim=shard_dim)[mesh.get_local_rank(mesh_dim)]

    import torch.distributed.tensor._collective_utils as cu
    if hasattr(cu, "shard_dim_alltoall"):
        replaced[id(cu.shard_dim_alltoall)] = (cu.shard_dim_alltoall, alltoall)
    names = set()
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("torch.distributed"):
            for attr, value in list(vars(mod).items()):
                if id(value) in replaced and replaced[id(value)][0] is value:
                    setattr(mod, attr, replaced[id(value)][1])
                    names.add(f"{mod.__name__}.{attr}")
    return sorted(names)


def mesh_serve_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of phase 11 (d), in a process of its own: a gloo group of
    ``world`` ranks sharing the card (as phase 11 (a)'s), the (2, 2) mesh,
    and for each arch the model whole from seed 0, its weights placed by
    ``shard_model`` with ``serve_rules`` (as the dry-run places a serving
    cell's), the prompts by ``batch_shardings``; after the prefill and after
    every step each cache must be a DTensor placed by
    ``cache_sharding_rules``.  Writes ``rank<rank>.pt``."""
    import faulthandler

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import serve_rules, shard_model

    faulthandler.enable()               # a crash in a collective shows its stack
    tmp = Path(tmp)
    spec = json.loads((tmp / "spec.json").read_text())
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'rendezvous'}", rank=rank,
                            world_size=world)
    out: dict = {}
    try:
        mesh = init_device_mesh(dev.type, tuple(spec["shape"]), mesh_dim_names=("data", "model"))
        if dev.type == "cuda":
            out["staged"] = stage_gloo_collectives()
        b, prompt, steps = spec["traffic"]
        for arch in spec["archs"]:
            for dtype in MESH_SERVE_DTYPES:
                cfg, model = mesh_serve_model(arch, spec["reduced"], dtype, dev)
                shard_model(model, mesh, serve_rules(cfg, tp=mesh.size(1)) or None)
                batch = mesh_serve_inputs(cfg, b, prompt, dev)
                batch = SH.place(batch, SH.batch_shardings(mesh, batch))
                feed = torch.load(tmp / f"feed_{arch}_{dtype}.pt")
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                with mesh:
                    run = mesh_serve_run(model, cfg, batch, steps, feed,
                                         lambda caches: caches_placed(mesh, caches))
                del run["caches"]
                run["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
                                  else 0.0)
                out[arch, dtype] = run
                del model, batch
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
        dist.barrier()
        torch.save(out, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def mesh_serve_reckoning(cfg, b: int, prompt: int, steps: int) -> dict:
    """The dry-run's per-rank peak (GB) of phase 11 (d)'s prefill and of a
    decode step at its last position, on a (2, 2) mesh of a ``fake`` group
    of 4 ranks, ``meta`` tensors placed as the ranks place theirs."""
    from repro_torch.configs.base import ShapeConfig

    # the encoder-decoder's cells split one length into frames and tokens
    # (steps.enc_len_for): its decode cell's self cache is 2P long, not P + S
    seq = 2 * prompt if cfg.is_encdec else prompt
    return mesh_reckoning(cfg, [ShapeConfig(f"mesh_{kind}", length, b, kind) for kind, length in
                                (("prefill", seq),
                                 ("decode", seq if cfg.is_encdec else prompt + steps))])


def mesh_reckoning(cfg, cells) -> dict:
    """The dry-run's per-rank peak (GB) of each cell (a ``ShapeConfig``) on a
    MESH_SERVE_SHAPE mesh of a ``fake`` group of 4 ranks, ``meta`` tensors
    placed as phase 11 (d)'s and (e)'s ranks place theirs; by the cell's
    kind."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun import fake_group, run_cell

    out = {}
    with fake_group(4):
        mesh = init_device_mesh("cpu", MESH_SERVE_SHAPE, mesh_dim_names=("data", "model"))
        for cell in cells:
            rec = run_cell(cfg, cell, mesh, "2x2", verbose=False)
            out[cell.kind] = rec["memory"]["peak_resident_bytes"] / 1e9
    return out


def rel_by_step(run: dict, ref: dict) -> list:
    """The prefill's and each step's largest logit error of ``run`` against
    ``ref``, over ``ref``'s largest logit."""
    scale = max(float(ref["prefill"].abs().max()), float(ref["logits"].abs().max()))
    return [float((run["prefill"] - ref["prefill"]).abs().max()) / scale] + [
        float((a - b).abs().max()) / scale for a, b in zip(run["logits"], ref["logits"])]


def token_rows(rank: int, run: dict, ref: dict) -> list:
    """Each batch row where ``run``'s first step's greedy token is not
    ``ref``'s: the rank, the row, both tokens (``ref``'s first), ``ref``'s
    logit gap between them (its token's logit less the other's) and the
    row's largest |``run`` - ``ref``| logit difference at that step."""
    mine, theirs = run["greedy"][:, 0], ref["greedy"][:, 0]
    out = []
    for i in (mine != theirs).nonzero().flatten().tolist():
        lg = ref["logits"][0, i]
        out.append({"rank": rank, "row": i, "tokens": [int(theirs[i]), int(mine[i])],
                    "gap": float(lg[theirs[i]] - lg[mine[i]]),
                    "max_diff": float((run["logits"][0, i] - lg).abs().max())})
    return out


def mesh_serve(dev, reduced: bool) -> dict:
    """Phase 11 (d): each of MESH_SERVE_ARCHS served unsharded on the card
    (``mesh_serve_run``) in bfloat16 (its own greedy tokens) and in float32
    (the same weights, fed the bfloat16 run's tokens), then in both dtypes
    on a MESH_SERVE_SHAPE mesh of ranks spawned here that share the card
    over gloo (``mesh_serve_rank``), fed the same tokens.  Every rank's
    float32 prefill and step logits within F32_HANDOFF_REL of the
    unsharded float32 run's largest logit; its bfloat16 ones, at the
    prefill and at each step, within HANDOFF_REL of the unsharded float32
    run's or no farther from them than MESH_BF16_RATIO times the unsharded
    bfloat16 run's (bfloat16's own rounding); every greedy token a rank
    picks, the prefill's and each step's, the argmax of the logits it
    holds there; in float32 the first step's greedy tokens the unsharded
    run's, and in bfloat16, where they differ, the unsharded run's logit
    gap between the two tokens and the row's largest difference from it,
    printed side by side (``token_rows``); every cache placed by
    ``cache_sharding_rules`` after the prefill and each step; each rank's
    peak allocation beside the dry-run's reckoning."""
    import dataclasses
    import multiprocessing
    import shutil
    import tempfile

    import torch

    b, prompt, steps = MESH_SERVE_TRAFFIC_REDUCED if reduced else MESH_SERVE_TRAFFIC
    world = MESH_SERVE_SHAPE[0] * MESH_SERVE_SHAPE[1]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_serve_"))
    procs: list = []
    record: dict = {"shape": list(MESH_SERVE_SHAPE), "batch": b, "prompt": prompt,
                    "steps": steps}
    try:
        refs, reckoned, cfgs = {}, {}, {}
        for arch in MESH_SERVE_ARCHS:
            feed = None
            for dtype in ("bfloat16", "float32"):        # float32 decodes bfloat16's tokens
                cfg, model = mesh_serve_model(arch, reduced, dtype, dev)
                refs[arch, dtype] = run = mesh_serve_run(
                    model, cfg, mesh_serve_inputs(cfg, b, prompt, dev), steps, feed)
                feed = run["fed"]
                del run["caches"]
                torch.save(feed, tmp / f"feed_{arch}_{dtype}.pt")
                del model
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            cfgs[arch] = dataclasses.replace(cfg, dtype="bfloat16")
        (tmp / "spec.json").write_text(json.dumps({
            "device": dev.type, "shape": list(MESH_SERVE_SHAPE), "archs": list(MESH_SERVE_ARCHS),
            "traffic": [b, prompt, steps], "reduced": reduced}))
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=mesh_serve_rank, args=(r, world, str(tmp)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + MESH_SERVE_TIMEOUT
        for arch, cfg in cfgs.items():        # on the host, while the ranks serve
            reckoned[arch] = mesh_serve_reckoning(cfg, b, prompt, steps)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0))
        ranks_s = time.perf_counter() - t0
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        if alive:
            raise RuntimeError(f"phase 11 (d): ranks {alive} still running after "
                               f"{MESH_SERVE_TIMEOUT} s")
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
        if failed:
            raise RuntimeError(f"phase 11 (d): ranks exited with {failed}")
        ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    record["ranks_s"] = ranks_s
    for arch in MESH_SERVE_ARCHS:
        f32 = refs[arch, "float32"]
        # each step's bfloat16 limit: against the float32 run, MESH_BF16_RATIO
        # times the unsharded bfloat16 run's distance from it, or HANDOFF_REL
        own = rel_by_step(refs[arch, "bfloat16"], f32)
        limits = {"float32": [F32_HANDOFF_REL] * (steps + 1),
                  "bfloat16": [max(HANDOFF_REL, MESH_BF16_RATIO * e) for e in own]}
        record[arch] = {"reckoned_peak_gb": reckoned[arch], "bf16_from_f32_by_step": own,
                        "layers": cfgs[arch].num_layers}
        for dtype in MESH_SERVE_DTYPES:
            ref = refs[arch, dtype]
            by_step = [0.0] * (steps + 1)    # the prefill's, then each step's, worst of the ranks
            rows: list = []
            for r, out in enumerate(ranks):
                run = out[arch, dtype]
                mine = rel_by_step(run, f32)
                by_step = [max(x, y) for x, y in zip(by_step, mine)]
                if not (torch.isfinite(run["logits"]).all()
                        and all(e <= lim for e, lim in zip(mine, limits[dtype]))):
                    raise RuntimeError(
                        f"phase 11 (d) {arch} {dtype}, rank {r}: logits from the unsharded "
                        f"float32 run's, over its largest, {mine} (the prefill's, then each "
                        f"step's) past the limits {limits[dtype]} (the unsharded bfloat16 run "
                        f"is {own} from it)")
                held = torch.cat([run["prefill"][None], run["logits"]]).argmax(-1).T.int()
                if not torch.equal(torch.cat([run["first"], run["greedy"]], 1), held):
                    raise RuntimeError(f"phase 11 (d) {arch} {dtype}, rank {r}: a greedy "
                                       "token is not the argmax of the logits the rank holds")
                if dtype == "float32" and not torch.equal(run["greedy"][:, 0],
                                                          ref["greedy"][:, 0]):
                    raise RuntimeError(f"phase 11 (d) {arch} {dtype}, rank {r}: the first "
                                       "step's tokens are not the unsharded run's")
                rows += token_rows(r, run, ref)
                if not all(run["placed"]):
                    raise RuntimeError(f"phase 11 (d) {arch} {dtype}, rank {r}: a cache left "
                                       f"its cache_sharding_rules placement ({run['placed']})")
            first = ranks[0][arch, dtype]
            rec = {"rel_err_by_step": by_step, "limit_by_step": limits[dtype],
                   "peak_gb_by_rank": [o[arch, dtype]["peak_gb"] for o in ranks],
                   "prefill_s": first["prefill_s"], "step_ms": [t * 1e3 for t in first["step_s"]],
                   "ref_prefill_s": ref["prefill_s"],
                   "ref_step_ms": [t * 1e3 for t in ref["step_s"]],
                   "first_tokens_equal": bool(torch.equal(first["greedy"][:, 0],
                                                          ref["greedy"][:, 0])),
                   "tokens_agree": int((first["greedy"] == ref["greedy"]).sum()),
                   "tokens": int(ref["greedy"].numel()), "token_rows": rows}
            record[arch][dtype] = rec
            what = "frames and tokens" if cfgs[arch].is_encdec else "tokens"
            print(f"phase 11 (d): {arch} ({cfgs[arch].num_layers} layers) in {dtype} on a "
                  f"{MESH_SERVE_SHAPE} mesh of {world} "
                  f"gloo ranks, {b} x {prompt} {what}, {steps} steps: logits from the unsharded "
                  "float32 run's, over its largest (the prefill's, then each step's): "
                  + ", ".join(f"{e:.2e}" for e in by_step) + " (limits "
                  + ", ".join(f"{e:.2e}" for e in limits[dtype])
                  + "; the unsharded bfloat16 run's: " + ", ".join(f"{e:.2e}" for e in own)
                  + "); the "
                  f"first step's tokens equal: {rec['first_tokens_equal']}, "
                  f"{rec['tokens_agree']} of {rec['tokens']} greedy tokens equal; every cache "
                  f"placed by cache_sharding_rules after the prefill and each step; rank 0's "
                  f"prefill {first['prefill_s']:.3f} s, a step's median "
                  f"{statistics.median(first['step_s']) * 1e3:.3f} ms (unsharded "
                  f"{ref['prefill_s']:.3f} s, {statistics.median(ref['step_s']) * 1e3:.3f} ms); "
                  "the ranks' peak allocations "
                  + ", ".join(f"{g:.3f}" for g in rec["peak_gb_by_rank"])
                  + f" GB (the dry-run's bfloat16 reckoning {reckoned[arch]['prefill']:.3f} "
                  f"for the prefill, {reckoned[arch]['decode']:.3f} for a decode step)",
                  flush=True)
            for row in rows:
                print(f"phase 11 (d): {arch} {dtype}, rank {row['rank']}, row {row['row']}: "
                      f"first token {row['tokens'][1]} where the unsharded run's is "
                      f"{row['tokens'][0]}; the unsharded logit gap between them "
                      f"{row['gap']:.6g} beside the row's largest logit difference "
                      f"{row['max_diff']:.6g}", flush=True)
    return record


def float64_witness():
    """A ``TorchDispatchMode`` under which the port computes in float64
    where it asks for float32: every float32 ``dtype`` an op is given
    (``Tensor.float()``, ``.to``, ``zeros_like(..., dtype=)``, ...) is
    float64, and so is the default dtype while it is on.  It works under
    autograd, so a checkpointed block's recompute in the backward is
    float64 too.  Its ``float32`` attribute counts, by op and the port's
    line that called it, the calls that still returned a float32 tensor: a
    witness wants none.  The parameters are made float64 outside the mode
    (the draw must not change)."""
    import collections
    import traceback

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten, tree_map

    f32, f64 = torch.float32, torch.float64

    class Witness(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.float32 = collections.Counter()

        def __enter__(self):
            self.default = torch.get_default_dtype()
            torch.set_default_dtype(f64)
            return super().__enter__()

        def __exit__(self, *exc):
            torch.set_default_dtype(self.default)
            return super().__exit__(*exc)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            args, kwargs = tree_map(lambda a: f64 if a is f32 else a, (args, kwargs or {}))
            out = func(*args, **kwargs)
            if any(isinstance(t, torch.Tensor) and t.dtype == f32 for t in tree_flatten(out)[0]):
                port = [f for f in traceback.extract_stack() if "repro_torch" in f.filename]
                self.float32[f"{func} at " + (f"{Path(port[-1].filename).name}:"
                                              f"{port[-1].lineno}" if port else "?")] += 1
            return out

    return Witness()


def mesh_train_inputs(cfg, reduced: bool, dev, seq: int = 0):
    """Phase 11 (e)'s cell: ``train_4k`` cut to MESH_TRAIN_TRAFFIC, or to
    ``seq`` tokens where given (the ``ShapeConfig``), and its B x S tokens
    from seed 7 (the labels too)."""
    import dataclasses

    import torch

    from repro_torch.configs import shape_by_name

    b, cut = MESH_TRAIN_TRAFFIC_REDUCED if reduced else MESH_TRAIN_TRAFFIC
    seq = seq or cut
    shape = dataclasses.replace(shape_by_name("train_4k"), seq_len=seq, global_batch=b)
    tokens = torch.randint(0, cfg.vocab_size, (b, seq), device=dev, dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(7))
    return shape, tokens


def mesh_train_unsharded(dev, reduced: bool, dtype: str, tokens, shape, accum: int,
                         start: dict | None = None, layers: int = 0) -> tuple:
    """One SGDM step (MESH_TRAIN_LR) of ``build_train_step`` with no mesh on
    the card, on MESH_TRAIN_ARCH drawn as phase 11 (d) draws it (at
    ``layers``, where given), at ``accum`` microbatches; in ``dtype``,
    "float32", or "float64" under
    :func:`float64_witness` (which fails if an op still returned float32).
    ``start``, where given, receives each parameter as drawn, in bfloat16
    on the host (exact: bfloat16 draws and the constants 0 and 1).  Returns the
    model after the step, the loss and gradient norm, the step's seconds
    (the card synchronised) and its peak allocation (GB)."""
    import dataclasses

    import torch

    from repro_torch.convert import group
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim.optimizer import make_optimizer

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, model = mesh_serve_model(MESH_TRAIN_ARCH, reduced, dtype, dev, layers)
    cfg = dataclasses.replace(cfg, grad_accum_train=accum)
    witness = float64_witness() if dtype == "float64" else None
    if start is not None:
        start.update((n, p.detach().to(torch.bfloat16).cpu())
                     for n, p in model.named_parameters())
        inexact = [n for n, p in model.named_parameters()
                   if not torch.equal(start[n].to(p.device, p.dtype), p.detach())]
        if inexact:
            raise RuntimeError(f"phase 11 (e): leaves not exact in bfloat16: {inexact[:4]}")
    if witness:
        model.double()             # its float32 norms, gates and SSM leaves too
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with witness or contextlib.nullcontext():
        opt = make_optimizer("sgdm", lr=MESH_TRAIN_LR)
        state = opt.init(group(dict(model.named_parameters()), model))
        metrics = build_train_step(cfg, shape, opt=opt)(model, state, 0,
                                                         {"tokens": tokens, "labels": tokens})
        metrics = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}
    sync()
    secs = time.perf_counter() - t0
    if witness and witness.float32:
        raise RuntimeError(f"phase 11 (e): the float64 witness still made float32 tensors: "
                           f"{dict(witness.float32)}")
    return model, metrics, secs, torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0


def held_to_witness(name: str, got, start: dict, update: dict) -> tuple:
    """Parameter ``name`` after a step (``got``, whole) against the float64
    witness's, ``start[name] + update[name]`` (the parameter as drawn, in
    bfloat16, and the witness's update, rounded to float32, on the host;
    the sum is not rounded).  Returns the largest error, the witness's largest update
    and largest value (in float64), and whether ``got`` is finite."""
    import torch

    dev = got.device
    step = update[name].to(dev, torch.float64)
    want = start[name].to(dev, torch.float64) + step
    return (float((got.detach().double() - want).abs().max()), float(step.abs().max()),
            float(want.abs().max()), bool(torch.isfinite(got).all()))


def update_rel_err(held: tuple) -> float:
    """A parameter's error after the step (:func:`held_to_witness`) over
    the witness's largest update of it, less the half float32 ulp that
    storing its largest value in float32 may cost: a float32 step is held
    to the witness's gradient step, not to the rounding of the weights."""
    diff, step, value, _ = held
    return max(diff - 2.0 ** -24 * value, 0.0) / max(step, 1e-300)


def mesh_train_run(model, cfg, mesh, batch: dict, lr: float, each_param=None) -> dict:
    """One rank's sharded train step, as phase 11 (e)'s ranks and
    ``tests/_torch_ranks.py train`` take it.  ``model`` holds the whole
    weights and ``batch`` the whole batch, the same on every rank.  The
    SGDM state (``lr``) is made on the whole parameters and placed by
    ``train_state_shardings``, the parameters by ``shard_model`` (the train
    rules), the batch by ``batch_shardings``: each rank keeps its shards,
    with no collective.  Then one ``build_train_step`` step under ``with
    mesh:``.  After it each parameter is gathered (``full_tensor``) and
    handed to ``each_param(name, whole)``.
    Returns the loss and gradient norm (floats), the step's seconds (the
    card synchronised) and the peak allocation over the step and over the
    placing before it (bytes, 0 on the CPU)."""
    import dataclasses

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import group
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import build_train_step, shard_model, train_state_shardings
    from repro_torch.optim.optimizer import make_optimizer

    dev = batch["tokens"].device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    opt = make_optimizer("sgdm", lr=lr)
    _, state_sh = train_state_shardings(dataclasses.replace(cfg, optimizer=opt.name), mesh)
    state = SH.place(opt.init(group(dict(model.named_parameters()), model)), state_sh)
    shard_model(model, mesh)
    placed = SH.place(batch, SH.batch_shardings(mesh, batch))
    shape = ShapeConfig("mesh_train", batch["tokens"].shape[1], batch["tokens"].shape[0],
                        "train")
    step = build_train_step(cfg, shape, mesh=mesh, opt=opt)
    out: dict = {}
    with mesh:
        sync()
        out["setup_peak"] = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = step(model, state, 0, placed)
        out["loss"] = float(metrics["loss"])              # synchronises
        out["grad_norm"] = float(metrics["grad_norm"])
        sync()
        out["step_s"] = time.perf_counter() - t0
        out["step_peak"] = torch.cuda.max_memory_allocated() if cuda else 0
        del metrics, state
        t0 = time.perf_counter()
        for name, p in model.named_parameters() if each_param else ():
            each_param(name, p.detach().full_tensor())
        out["held_s"] = time.perf_counter() - t0
    return out


def mesh_train_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of phase 11 (e), in a process of its own: a gloo group of
    ``world`` ranks sharing the card (as phase 11 (d)'s), the (2, 2) mesh,
    MESH_TRAIN_ARCH at MESH_TRAIN_LAYERS in float32 from seed 0 (``mesh_serve_model``),
    the parent's tokens, one step of ``mesh_train_run``.  Each gathered
    parameter is held on the card to the float64 witness's
    (:func:`held_to_witness`; ``start.pt`` and ``update.pt``, read a leaf
    at a time from memory maps).  Writes ``rank<rank>.pt``."""
    import faulthandler

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    faulthandler.enable()               # a crash in a collective shows its stack
    tmp = Path(tmp)
    spec = json.loads((tmp / "spec.json").read_text())
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'rendezvous'}", rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh(dev.type, tuple(spec["shape"]), mesh_dim_names=("data", "model"))
        out: dict = {"staged": stage_gloo_collectives() if dev.type == "cuda" else []}
        t0 = time.perf_counter()
        cfg, model = mesh_serve_model(spec["arch"], spec["reduced"], "float32", dev,
                                      spec["layers"])
        drawn_s = time.perf_counter() - t0
        tokens = torch.load(tmp / "tokens.pt").to(dev)
        start = torch.load(tmp / "start.pt", mmap=True)
        update = torch.load(tmp / "update.pt", mmap=True)
        errs: dict = {}

        def held(name, whole):
            errs[name] = held_to_witness(name, whole, start, update)

        out.update(mesh_train_run(model, cfg, mesh, {"tokens": tokens, "labels": tokens},
                                  spec["lr"], each_param=held))
        out["errs"] = errs
        out["phase_s"] = {"draw": drawn_s, "after_draw": time.perf_counter() - t0 - drawn_s,
                          "step": out["step_s"], "gather_and_hold": out["held_s"]}
        dist.barrier()
        torch.save(out, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def mesh_train(dev, reduced: bool) -> dict:
    """Phase 11 (e): MESH_TRAIN_ARCH at MESH_TRAIN_LAYERS (``mesh_serve_model``: the
    bfloat16 draw of seed 0, upcast) takes one SGDM step of
    ``build_train_step`` on B x S tokens from seed 7
    (:func:`mesh_train_inputs`), first with no mesh on the card in float64
    (the witness, :func:`mesh_train_unsharded`; the parameters as drawn and
    its update are written to the host and the model freed) and in float32
    (the unsharded step, timed and held to the witness as the ranks are),
    each at the sharded step's microbatches.  Then ranks spawned here on a
    MESH_SERVE_SHAPE mesh sharing the card over gloo (``mesh_train_rank``)
    take the same step sharded in float32, while the parent reckons the
    cell with the dry-run on a ``fake`` group of 4.  Every float32 run's
    loss and gradient norm within MESH_TRAIN_TOL of the witness's, and
    every parameter after the step within MESH_TRAIN_UPDATE_TOL of the
    witness's largest update of it (:func:`update_rel_err`), all finite."""
    import dataclasses
    import multiprocessing
    import shutil
    import tempfile

    import torch

    from repro_torch.launch.steps import grad_accum_for

    world = MESH_SERVE_SHAPE[0] * MESH_SERVE_SHAPE[1]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_train_"))
    procs: list = []
    try:
        cfg = dataclasses.replace(mesh_config(MESH_TRAIN_ARCH, reduced, MESH_TRAIN_LAYERS),
                                  dtype="float32")
        shape, tokens = mesh_train_inputs(cfg, reduced, dev)
        accum = grad_accum_for(cfg, shape, dict(zip(("data", "model"), MESH_SERVE_SHAPE)))
        start: dict = {}
        model, witness, wit_s, wit_peak = mesh_train_unsharded(
            dev, reduced, "float64", tokens, shape, accum, start, MESH_TRAIN_LAYERS)
        with torch.no_grad():
            update = {n: (p - start[n].to(dev, torch.float64)).float().cpu()
                      for n, p in model.named_parameters()}
        n_params = sum(p.numel() for p in model.parameters())
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        model, ref, ref_s, ref_peak = mesh_train_unsharded(dev, reduced, "float32", tokens,
                                                           shape, accum, layers=MESH_TRAIN_LAYERS)
        with torch.no_grad():
            ref["errs"] = {n: held_to_witness(n, p, start, update)
                           for n, p in model.named_parameters()}
        del model
        torch.save(start, tmp / "start.pt")
        torch.save(update, tmp / "update.pt")
        torch.save(tokens.cpu(), tmp / "tokens.pt")
        del start, update, tokens
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        (tmp / "spec.json").write_text(json.dumps({
            "device": dev.type, "shape": list(MESH_SERVE_SHAPE), "arch": MESH_TRAIN_ARCH,
            "reduced": reduced, "lr": MESH_TRAIN_LR, "layers": MESH_TRAIN_LAYERS}))
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=mesh_train_rank, args=(r, world, str(tmp)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + MESH_TRAIN_TIMEOUT
        reckoned = mesh_reckoning(dataclasses.replace(cfg, optimizer="sgdm"), [shape])["train"]
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0))
        ranks_s = time.perf_counter() - t0
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        if alive:
            raise RuntimeError(f"phase 11 (e): ranks {alive} still running after "
                               f"{MESH_TRAIN_TIMEOUT} s")
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
        if failed:
            raise RuntimeError(f"phase 11 (e): ranks exited with {failed}")
        ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    failures, worst = [], {}
    for label, run in [("unsharded", ref)] + [(f"rank {r}", o) for r, o in enumerate(ranks)]:
        errs = run["errs"]
        if len(errs) != len(ref["errs"]):
            failures.append(f"{label} held {len(errs)} of {len(ref['errs'])} parameters")
            continue
        for key in ("loss", "grad_norm"):
            got, want = run[key], witness[key]
            if not (math.isfinite(got) and abs(got - want) <= MESH_TRAIN_TOL * abs(want)):
                failures.append(f"{label}: {key} {got!r} against the witness's {want!r} "
                                f"(limit {MESH_TRAIN_TOL} of it)")
        rel = {n: update_rel_err(e) for n, e in errs.items()}
        bad = {n: rel[n] for n, e in errs.items()
               if not (rel[n] <= MESH_TRAIN_UPDATE_TOL and e[3])}
        if bad:
            failures.append(f"{label}: {len(bad)} parameters after the step past "
                            f"{MESH_TRAIN_UPDATE_TOL} of the witness's largest update or not "
                            "finite: "
                            + ", ".join(f"{n} {e:.2e}" for n, e in
                                        sorted(bad.items(), key=lambda kv: -kv[1])[:8]))
        name = max(rel, key=rel.get)
        worst[label] = {"update": (rel[name], name),
                        "value": max(e[0] / max(e[2], 1e-300) for e in errs.values())}
    b, seq = shape.global_batch, shape.seq_len
    record = {"arch": cfg.name, "layers": cfg.num_layers, "parameters": n_params,
              "shape": list(MESH_SERVE_SHAPE), "batch": b, "seq": seq, "accum": accum,
              "optimizer": "sgdm", "lr": MESH_TRAIN_LR, "tol": MESH_TRAIN_TOL,
              "update_tol": MESH_TRAIN_UPDATE_TOL, "witness": witness,
              "witness_step_s": wit_s, "witness_peak_gb": wit_peak,
              "unsharded": {"loss": ref["loss"], "grad_norm": ref["grad_norm"]},
              "unsharded_step_s": ref_s, "unsharded_peak_gb": ref_peak,
              "ranks_s": ranks_s, "staged": ranks[0]["staged"],
              "rank0_s": ranks[0]["phase_s"], "params_held": len(ref["errs"]),
              "loss_by_rank": [o["loss"] for o in ranks],
              "grad_norm_by_rank": [o["grad_norm"] for o in ranks],
              "update_rel_err": {k: w["update"][0] for k, w in worst.items()},
              "update_worst_leaf": {k: w["update"][1] for k, w in worst.items()},
              "value_rel_err": {k: w["value"] for k, w in worst.items()},
              "step_s": ranks[0]["step_s"], "step_s_by_rank": [o["step_s"] for o in ranks],
              "step_peak_gb_by_rank": [o["step_peak"] / 1e9 for o in ranks],
              "setup_peak_gb_by_rank": [o["setup_peak"] / 1e9 for o in ranks],
              "reckoned_peak_gb": reckoned}
    print(f"phase 11 (e): build_train_step on {cfg.name} ({cfg.num_layers} layers, "
          f"{n_params:,} parameters) on a {MESH_SERVE_SHAPE} mesh of {world} gloo ranks in "
          f"float32, {b} x {seq} tokens in {accum} microbatches, SGDM lr {MESH_TRAIN_LR}, held "
          f"to the same step unsharded in float64 (loss {witness['loss']:.9f}, gradient norm "
          f"{witness['grad_norm']:.9f}, {wit_s:.3f} s, peak {wit_peak:.3f} GB): losses "
          + ", ".join(f"{v:.9f}" for v in record["loss_by_rank"])
          + f" (unsharded float32 {ref['loss']:.9f}), gradient norms "
          + ", ".join(f"{v:.9f}" for v in record["grad_norm_by_rank"])
          + f" (unsharded float32 {ref['grad_norm']:.9f}; limit {MESH_TRAIN_TOL} of the "
          f"witness's); each run's largest error over the witness's largest update, of the "
          f"{len(ref['errs'])} parameters (limit {MESH_TRAIN_UPDATE_TOL}): " + "; ".join(
              f"{k} {w['update'][0]:.3e} ({w['update'][1]}; over the largest value "
              f"{w['value']:.3e})" for k, w in worst.items())
          + f"; rank 0's step {record['step_s']:.3f} s (unsharded float32 {ref_s:.3f} s), its "
          f"parts {record['rank0_s']}; the ranks' peak allocations over the step "
          + ", ".join(f"{g:.3f}" for g in record["step_peak_gb_by_rank"])
          + f" GB (the dry-run's reckoning {reckoned:.3f} GB; the unsharded float32 step "
          f"{ref_peak:.3f} GB), over the placing before it "
          + ", ".join(f"{g:.3f}" for g in record["setup_peak_gb_by_rank"])
          + f" GB; collectives staged through the host: {record['staged']}", flush=True)
    if failures:
        raise RuntimeError("phase 11 (e): " + "; ".join(failures))
    return record


def mesh_steps_phase(dev, reduced: bool = False) -> tuple:
    """Phase 11: (a) the worker mesh (:func:`mesh_iterations`); (b)-(e)
    the step builders at full width (:func:`step_train`,
    :func:`step_serve`, :func:`mesh_serve`, :func:`mesh_train`), which
    launch none of the four kernels, as the JAX package's reach no Pallas
    kernel: their counters must stay at 0 (the spawned ranks of (d) and (e)
    launch none either: they build no kernel).
    Returns (a)'s launches by record name, and the phase's record."""
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    launches, record = mesh_iterations(dev, reduced)
    record = {"mesh": record, "mesh_s": time.perf_counter() - t0}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    record["train_step"] = step_train(dev, reduced)
    record["train_step_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["serve_steps"] = step_serve(dev, reduced)
    record["serve_steps_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["mesh_serve"] = mesh_serve(dev, reduced)
    record["mesh_serve_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    record["mesh_train"] = mesh_train(dev, reduced)
    record["mesh_train_s"] = time.perf_counter() - t0
    counts, designs = ops.launch_counts(), ops.design_counts()
    expect("phase 11 (b)-(e): kernel launches of the step builders", counts,
           dict.fromkeys(counts, 0))
    expect("phase 11 (b)-(e): designs launched by the step builders", designs,
           {k: dict.fromkeys(v, 0) for k, v in designs.items()})
    record["step_launches"] = counts
    return launches, record


def dryrun_start(cells, out_dir: Path) -> list:
    """Phase 12 (a): one ``python -m repro_torch.launch.dryrun`` subprocess
    per cell, all started at once on the CPU (the card hidden from them),
    each with its own output directory; returns (cell, process, start),
    and stops them when the script exits, however it exits."""
    started = []
    for arch, shape, mesh, accum in cells:
        out = out_dir / f"{arch}__{shape}__{mesh}"
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
               "CUDA_VISIBLE_DEVICES": ""}
        if accum:
            env["REPRO_GRAD_ACCUM"] = str(accum)
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                                 arch, "--shape", shape, "--mesh", mesh, "--out", str(out)],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, cwd=ROOT)
        started.append(((arch, shape, mesh, accum), proc, time.perf_counter()))
    atexit.register(dryrun_stop, started)
    return started


def dryrun_stop(started) -> None:
    """Kill each of ``dryrun_start``'s processes that still runs."""
    for _, proc, _ in started:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dryrun_finish(started, out_dir: Path) -> list:
    """Phase 12 (a): wait for each dry-run (DRYRUN_TIMEOUT from its start),
    print its record, and fail unless it ended ``ok`` with every key the JAX
    package's record has."""
    records = []
    try:
        for (arch, shape, mesh, accum), proc, t0 in started:
            left = max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0))
            log = proc.communicate(timeout=left)[0]
            path = out_dir / f"{arch}__{shape}__{mesh}" / f"{arch}__{shape}__{mesh}.json"
            if proc.returncode != 0 or not path.exists():
                raise RuntimeError(f"phase 12 (a): the dry-run of {arch} x {shape} x {mesh} "
                                   f"exited {proc.returncode}:\n{log[-3000:]}")
            rec = json.loads(path.read_text())
            keys = {"arch", "shape", "mesh", "chips", "compile_s", "memory", "cost",
                    "roofline", "status"}
            memory = {"argument_bytes", "output_bytes", "temp_bytes", "generated_code_bytes",
                      "peak_resident_bytes"}
            if rec.get("status") != "ok" or not keys <= set(rec) or set(rec["memory"]) != memory:
                raise RuntimeError(f"phase 12 (a): {arch} x {shape} x {mesh}: {rec}")
            rec["collected_s"] = time.perf_counter() - t0
            rec["grad_accum_override"] = accum
            rl = rec["roofline"]
            print(f"phase 12 (a): dry-run {arch} x {shape} x {mesh} ({rec['chips']} ranks of a "
                  f"fake group{f', REPRO_GRAD_ACCUM={accum}' if accum else ''}): its step "
                  f"{rec['compile_s']} s, collected {rec['collected_s']:.1f} s after its start; "
                  f"per chip {rl['flops_per_chip']:.4e} FLOPs, "
                  f"{rl['bytes_per_chip']:.4e} dot bytes, {rl['coll_bytes_per_chip']:.4e} "
                  f"collective bytes {rl['coll_breakdown']}; t_compute {rl['t_compute']:.4e} s, "
                  f"t_memory {rl['t_memory']:.4e} s, t_collective {rl['t_collective']:.4e} s: "
                  f"{rl['dominant']}; useful FLOPs {rl['useful_flops_fraction']:.4e}, "
                  f"roofline fraction {rl['roofline_fraction']:.4e}; memory {rec['memory']}",
                  flush=True)
            records.append(rec)
    finally:
        dryrun_stop(started)
    return records


def roofline_of_step(label: str, fn, cfg, shape, measured_s: float, dev) -> dict:
    """Phase 12 (b): ``fn()`` once under ``roofline.StepCounter`` on this
    card's tensors (one rank: no collective), its ``RooflineResult`` with
    the H100's data-sheet constants beside the measured step time."""
    import torch

    from repro_torch.launch.roofline import H100, RooflineResult, StepCounter, model_flops

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepCounter(memory=False) as counter:
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    rl = RooflineResult(arch=cfg.name, shape=shape.name, mesh="one card", chips=1,
                        flops_per_chip=counter.flops, bytes_per_chip=counter.dot_bytes,
                        coll_bytes_per_chip=0.0, coll_breakdown={}, peak_mem_per_chip=peak,
                        model_flops_total=model_flops(cfg, shape))
    ratio = measured_s / rl.bound_time
    print(f"phase 12 (b): roofline of {label} on one card ({H100.name}): {rl.flops_per_chip:.4e} "
          f"FLOPs, {rl.bytes_per_chip:.4e} dot bytes; t_compute {rl.t_compute * 1e3:.4f} ms, "
          f"t_memory {rl.t_memory * 1e3:.4f} ms: {rl.dominant}-bound at "
          f"{rl.bound_time * 1e3:.4f} ms; phase 11's median {measured_s * 1e3:.3f} ms is "
          f"{ratio:.2f}x the bound; useful FLOPs {rl.useful_flops_fraction:.4f}; the counted "
          f"step {counted_s:.3f} s, peak memory {peak / 1e9:.2f} GB", flush=True)
    if not (rl.flops_per_chip > 0 and rl.bytes_per_chip > 0 and math.isfinite(ratio)):
        raise RuntimeError(f"phase 12 (b): {label}: no FLOPs or bytes counted")
    return {**rl.to_dict(), "bound_time": rl.bound_time, "measured_s": measured_s,
            "measured_over_bound": ratio, "counted_s": counted_s, "peak_gb": peak / 1e9}


def step_rooflines(dev, measured: dict, reduced: bool) -> dict:
    """Phase 12 (b): phase 11 (b)'s train step and (c)'s decode step, each
    once under the counter beside phase 11's median; then the dry-run of
    the decode step's cell on a (1, 1) mesh of a ``fake`` group of one rank
    beside the card's peak over the same step."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, shape_by_name
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import group
    from repro_torch.launch.dryrun import fake_group, run_cell
    from repro_torch.launch.steps import build_decode_step, build_prefill_step, build_train_step
    from repro_torch.models import build_model
    from repro_torch.optim.optimizer import make_optimizer

    out = {}
    # phase 11 (b)'s cell: zamba2-1.2b whole, train_4k cut to STEP_TRAIN_BATCH sequences
    cfg = get_config(STEP_TRAIN_ARCH)
    shape = dataclasses.replace(shape_by_name("train_4k"), global_batch=STEP_TRAIN_BATCH)
    if reduced:
        cfg, shape = cfg.reduced(), dataclasses.replace(shape, seq_len=64, global_batch=4)
    model = build_model(cfg, device=dev)
    opt = make_optimizer(cfg.optimizer, lr=1e-4)
    state = opt.init(group(dict(model.named_parameters()), model))
    step = build_train_step(cfg, shape, opt=opt)
    gen = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (shape.global_batch, shape.seq_len), generator=gen,
                         device=dev, dtype=torch.int32)
    out["train"] = roofline_of_step(
        f"build_train_step on {cfg.name}, {shape.global_batch} x {shape.seq_len}", lambda: float(
            step(model, state, 0, {"tokens": toks, "labels": toks})["loss"]),
        cfg, shape, statistics.median(measured["train_step"]["step_s"]), dev)
    del model, state, opt
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # phase 11 (c)'s cell: mistral-nemo-12b whole, one decode step after a
    # prompt of STEP_SERVE_PROMPT tokens
    cfg = get_config(STEP_SERVE_ARCH)
    b, prompt = STEP_SERVE_BATCH, STEP_SERVE_PROMPT
    if reduced:
        cfg, prompt = cfg.reduced(), 32
    shape = ShapeConfig(f"decode at {prompt}", prompt + 1, b, "decode")
    model = build_model(cfg, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen, device=dev,
                           dtype=torch.int32)
    logits, caches = build_prefill_step(cfg)(model, {"tokens": tokens}, max_seq=prompt + 1)
    batch = {"token": torch.argmax(logits, -1).to(torch.int32)[:, None], "caches": caches,
             "pos": prompt}
    del logits
    decode = build_decode_step(cfg)
    out["decode"] = roofline_of_step(
        f"build_decode_step on {cfg.name}, B = {b} at position {prompt}",
        lambda: decode(model, batch)[0].cpu(), cfg, shape,
        statistics.median(measured["serve_steps"]["step_ms"]) / 1e3, dev)
    del model, caches, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the same decode cell reckoned by the dry-run on a (1, 1) mesh
    with fake_group(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        rec = run_cell(cfg, shape, mesh, "(1, 1)", verbose=False)
    reckoned = rec["memory"]["peak_resident_bytes"] / 1e9
    card = out["decode"]["peak_gb"]
    print(f"phase 12 (b): the dry-run of the same decode cell on a (1, 1) mesh: peak resident "
          f"{reckoned:.3f} GB (arguments {rec['memory']['argument_bytes'] / 1e9:.3f} GB, "
          f"temporaries {rec['memory']['temp_bytes'] / 1e9:.3f} GB) against the card's "
          f"{card:.3f} GB over the step (torch.cuda.max_memory_allocated)", flush=True)
    out["decode_dryrun_memory"] = {**rec["memory"], "card_peak_gb": card,
                                   "reckoned_over_card": reckoned / card if card else None}
    return out


def cluster_demo_on_card(dev, compare) -> tuple:
    """Phase 12 (c): ``examples/torch_cluster_demo.py`` on ``dev`` with its
    launches counted from 0; the first ``coded_matvec`` launch of each
    design and the first ``lstm_sequence`` launch are kept, then held
    against their plain versions on the same tensors, the largest error
    within DEMO_HELD_REL of the plain result's largest value.  Returns (the
    launches by record name, the designs, the phase's record)."""
    import importlib.util

    import torch

    from repro_torch.kernels import coded_matvec as cmv
    from repro_torch.kernels import lstm_cell as lstm
    from repro_torch.kernels import ops

    spec = importlib.util.spec_from_file_location("torch_cluster_demo",
                                                  ROOT / "examples" / "torch_cluster_demo.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    kept, lock = {}, threading.Lock()
    real_cmv, real_seq = ops.coded_matvec, ops.lstm_sequence

    def keep(key, args):
        with lock:
            if key not in kept:
                kept[key] = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)

    def counted_cmv(a, x, block_ids, block_rows):
        keep(cmv.design_of(a, x), (a, x, block_ids, block_rows))
        return real_cmv(a, x, block_ids, block_rows)

    def counted_seq(*args):
        keep("sequence", args)
        return real_seq(*args)

    ops.reset_launch_counts()
    ops.coded_matvec, ops.lstm_sequence = counted_cmv, counted_seq
    t0 = time.perf_counter()
    try:
        code = demo.main(["--device", dev.type])
    finally:
        ops.coded_matvec, ops.lstm_sequence = real_cmv, real_seq
    demo_s = time.perf_counter() - t0
    counts, designs = ops.launch_counts(), ops.design_counts()
    print(f"phase 12 (c): examples/torch_cluster_demo.py on {dev}: exit {code} in {demo_s:.1f} s; "
          f"launches {counts}; by design {designs}; kept {sorted(kept)}", flush=True)
    if code != 0:
        raise RuntimeError(f"phase 12 (c): the demo exited {code}")
    if dev.type == "cuda":
        for name, want in (("coded_matvec", "stream"), ("coded_matvec", "multi"),
                           ("lstm_cell", "sequence")):
            if designs[name][want] == 0 or want not in kept:
                raise RuntimeError(f"phase 12 (c): the demo launched no {name} on the {want} "
                                   f"design: {designs}")
        expect("phase 12 (c): the demo's launches off its path",
               (counts["mds_encode"], counts["mds_decode"], designs["lstm_cell"]["cell"]),
               (0, 0, 0))
    errs, scales = {}, {}
    for key, args in sorted(kept.items()):
        if key == "sequence":
            label = "phase 12 (c) lstm_sequence (a predictor window)"
            got, want = ops.lstm_sequence(*args), lstm.lstm_sequence_plain(*args)
        else:
            label = (f"phase 12 (c) coded_matvec {key} {tuple(args[0].shape)} x "
                     f"{tuple(args[1].shape)}")
            got, want = ops.coded_matvec(*args), cmv.coded_matvec_plain(*args)
        scales[key] = max(float(w.abs().max()) for w in
                          (want if isinstance(want, tuple) else (want,)))
        limit = DEMO_HELD_REL * scales[key]
        errs[key] = compare(label, got, want, limit)
        if errs[key] > limit:
            raise RuntimeError(f"{label}: max abs err {errs[key]:.3e} > {limit:.3e} "
                               f"({DEMO_HELD_REL} of the plain result's largest value)")
    print(f"phase 12 (c): the demo's launches against their plain versions, max abs err "
          f"{errs}, the plain results' largest values {scales} (limit {DEMO_HELD_REL} of "
          "each)", flush=True)
    return counts, designs, {"demo_s": demo_s, "launches": counts, "designs": designs,
                             "held_max_abs_err": errs, "held_max_abs_plain": scales}


def roofline_phase(dev, compare, measured: dict, dryruns: tuple,
                   reduced: bool = False) -> tuple:
    """Phase 12: (b) the roofline of phase 11's steps on the card, (c) the
    cluster demo on the card with its kernels held, then (a) the dry-run's
    cells collected: ``dryruns`` is ``dryrun_start``'s processes and their
    output directory.  ``measured``: phase 11's record.  Returns (the
    demo's launches by record name, the phase's record)."""
    started, out_dir = dryruns
    record = {}
    try:
        t0 = time.perf_counter()
        record["steps"] = step_rooflines(dev, measured, reduced)
        record["steps_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        counts, designs, record["demo"] = cluster_demo_on_card(dev, compare)
        record["demo_s"] = time.perf_counter() - t0
    finally:
        t0 = time.perf_counter()
        record["dryrun"] = dryrun_finish(started, out_dir)
        record["dryrun_wait_s"] = time.perf_counter() - t0
    launches = dict(counts)
    launches["coded_matvec (multi design)"] = designs["coded_matvec"]["multi"]
    return launches, record


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2

    import numpy as np

    from repro_torch.convert import load_params
    from repro_torch.core.coded_matmul import CodedMatvec
    from repro_torch.core.coding import MDSCode
    from repro_torch.core.predictor import SpeedPredictor, predict_next
    from repro_torch.core.s2c2 import general_allocation
    from repro_torch.core.traces import controlled_traces
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import coded_matvec as cmv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. card and build ----------------------------------------------------
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s ({len(_build.SOURCES)} sources, one nvcc "
          "each, in parallel; less if build/kernels/ already held the library)", flush=True)
    print(ptxas_summary((_build.build().parent / "build.log").read_text()), flush=True)

    def call_ms(fn) -> float:
        """Median of single calls, each from the host's enqueue to its end."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    # cycles of torch.cuda._sleep per millisecond, to queue work behind it
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    sleep_cycles_per_ms = 10_000_000 / start.elapsed_time(end)

    def device_ms(fn, per_call_ms: float) -> float:
        """Launches back to back on the device: they are queued behind a
        sleep long enough for the host to enqueue all of them first.

        An event recorded just after the sleep says whether it was: where
        the sleep had ended before the host enqueued the last call (a slow
        host, or more launches than the device's queue holds, as in a loop
        of small launches), the window would time the host, so it is timed
        again with a quarter of the calls and twice the sleep.
        """
        n = int(min(200, max(5, DEVICE_WINDOW_MS / per_call_ms)))
        margin = 1.5
        while True:
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(int(margin * n * per_call_ms * sleep_cycles_per_ms) + 1000)
            slept = torch.cuda.Event()
            slept.record()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            host_ahead = not slept.query()
            end.synchronize()
            if host_ahead:
                return start.elapsed_time(end) / n
            if margin >= 48:
                raise RuntimeError(f"device_ms: the host did not get ahead of the device "
                                   f"with {n} call(s) behind a {margin}x sleep")
            n, margin = max(1, n // 4), margin * 2

    def timed(fn) -> dict:
        c = call_ms(fn)
        return {"device_ms": device_ms(fn, c), "call_ms": c}

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def compare(name, got, want, tol) -> float:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for g, w in zip(got, want):
            g32, w32 = g.float(), w.float()
            if g.shape != w.shape or not torch.isfinite(g32).all():
                raise RuntimeError(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} "
                                   "or non-finite values")
            if not torch.allclose(g32, w32, rtol=tol, atol=tol):
                raise RuntimeError(f"{name}: kernel and plain version disagree, max abs "
                                   f"err {float((g32 - w32).abs().max()):.3e} > {tol}")
            err = max(err, float((g32 - w32).abs().max()))
        return err

    records = {}

    def record(name, kernel, plain, library, n_bytes, flops, tol, library_name):
        err = compare(f"{name} (main shape)", kernel(), plain(), tol)
        k_t, p_t, l_t = timed(kernel), timed(plain), timed(library)
        b_ms, b_by = bound_ms(n_bytes, flops)
        records[name] = dict(name=name, route="cuda",
                             source=f"src/repro_torch/kernels/csrc/{name}.cu",
                             replaces=KERNELS[name], launches=0, max_abs_err=err,
                             ms=k_t["device_ms"], plain_ms=p_t["device_ms"],
                             bound_ms=b_ms, bound_by=b_by, library_ms=l_t["device_ms"],
                             device_ms=k_t["device_ms"], call_ms=k_t["call_ms"],
                             plain_device_ms=p_t["device_ms"], plain_call_ms=p_t["call_ms"],
                             library_device_ms=l_t["device_ms"],
                             library_call_ms=l_t["call_ms"], library=library_name)
        print(f"{name}: device ms: kernel {k_t['device_ms']:.4f}, plain "
              f"{p_t['device_ms']:.4f}, library {l_t['device_ms']:.4f}; call ms: kernel "
              f"{k_t['call_ms']:.4f}, plain {p_t['call_ms']:.4f}, library "
              f"{l_t['call_ms']:.4f}; bound {b_ms:.4f} ms ({b_by}), max abs err "
              f"{err:.3e} (tol {tol})", flush=True)

    turns = {}

    def in_turns(label, fns: dict, order: list[str]) -> dict:
        """Time several versions of one function in turns on this card."""
        times = {name: [] for name in fns}
        for name in order:
            times[name].append(timed(fns[name]))
        turns[label] = {name: {"device_ms": [t["device_ms"] for t in ts],
                               "call_ms": [t["call_ms"] for t in ts]}
                        for name, ts in times.items()}
        for name, ts in turns[label].items():
            print(f"in turns, {label}: {name}: device ms "
                  f"{', '.join(f'{v:.4f}' for v in ts['device_ms'])}; call ms "
                  f"{', '.join(f'{v:.4f}' for v in ts['call_ms'])}", flush=True)
        return turns[label]

    def cell_loop(xs_, w_ih, w_hh, b, w_out, b_out):
        """The window step by step: one lstm_cell launch per step, the head
        after each (the predictor's loop before the sequence kernel)."""
        h = xs_.new_zeros((xs_.shape[1], w_hh.shape[1]))
        c = xs_.new_zeros((xs_.shape[1], w_hh.shape[1]))
        ys = []
        for x_ in xs_:
            h, c = ops.lstm_cell(x_.contiguous(), h, c, w_ih, w_hh, b)
            ys.append(h @ w_out.T + b_out)
        return torch.stack(ys)

    tol = {torch.float32: F32_TOL, torch.bfloat16: 5e-2}
    rows_w = ROWS // K                   # rows of one coded partition
    rpc = rows_w // CHUNKS               # rows of one chunk

    # -- 2 and 3. every kernel against its plain version; in turns ------------
    # coded_matvec: the main path's launch reads k·C assigned chunks out of
    # the n·C chunks of the (n·rows, d) coded tensor
    a = randn(N * rows_w, COLS)
    x = randn(COLS)
    ids = torch.randperm(N * CHUNKS, generator=gen, device=dev)[: K * CHUNKS]
    ids = ids.to(torch.int32)
    nb = ids.numel()
    sel = a.view(N * CHUNKS, rpc, COLS)[ids.long()].reshape(-1, COLS)
    record("coded_matvec",
           lambda: ops.coded_matvec(a, x, ids, rpc),
           lambda: ref.coded_matvec_ref(a, x, ids, rpc),
           lambda: torch.matmul(sel, x),
           n_bytes=4 * (nb * rpc * COLS + COLS + nb + nb * rpc),
           flops=2 * nb * rpc * COLS, tol=tol[torch.float32],
           library_name="torch.matmul on pre-gathered rows")
    if cmv.design_of(a, x) != "stream":
        raise RuntimeError("the main shape does not take coded_matvec's stream design")
    records["coded_matvec"]["design"] = "stream"
    # the two designs, each reached directly, and cuBLAS's GEMV on the rows
    # gathered beforehand, in turns at the main shape
    compare("coded_matvec stream vs general (main shape)",
            cmv.coded_matvec_stream(a, x, ids, rpc), cmv.coded_matvec_general(a, x, ids, rpc),
            tol[torch.float32])
    versions = {
        "stream": lambda: cmv.coded_matvec_stream(a, x, ids, rpc),
        "general (warp per row)": lambda: cmv.coded_matvec_general(a, x, ids, rpc),
        "torch.matmul on pre-gathered rows": lambda: torch.matmul(sel, x),
    }
    in_turns("coded_matvec", versions, list(versions) + list(versions)[::-1])
    del a, sel
    for chunks, br, d, nvec, dt in [(12, 16, 300, 3, torch.float32),
                                    (5, 8, 130, 2, torch.bfloat16),
                                    (6, 32, 512, 8, torch.bfloat16),
                                    (4, 64, 2048, 16, torch.float32),
                                    (7, 100, 1024, 1, torch.bfloat16)]:
        a_r, x_r = randn(chunks * br, d, dtype=dt), randn(d, nvec, dtype=dt)
        ids_r = torch.randperm(chunks, generator=gen, device=dev)[: max(2, chunks // 2)]
        ids_r = ids_r.to(torch.int32)
        compare(f"coded_matvec {(chunks, br, d, nvec, dt)}",
                ops.coded_matvec(a_r, x_r, ids_r, br),
                ref.coded_matvec_ref(a_r, x_r, ids_r, br), tol[dt])
    # the stream design at ragged shapes: nb of 1, under the grid and many
    # times it; br not a multiple of the tile's rows; d up to 32 KB a row
    for blocks_r, nb_r, br, d, dt in [(4, 1, 37, 2048, torch.float32),
                                      (64, 40, 11, 4096, torch.bfloat16),
                                      (600, 1500, 6, 2048, torch.float32),
                                      (50, 300, 130, 1024, torch.bfloat16),
                                      (6, 9, 5, 8192, torch.float32)]:
        a_r, x_r = randn(blocks_r * br, d, dtype=dt), randn(d, dtype=dt)
        ids_r = torch.randint(0, blocks_r, (nb_r,), generator=gen, device=dev,
                              dtype=torch.int32)
        compare(f"coded_matvec stream {(blocks_r, nb_r, br, d, dt)}",
                cmv.coded_matvec_stream(a_r, x_r, ids_r, br),
                ref.coded_matvec_ref(a_r, x_r, ids_r, br), tol[dt])
    # the split-row stream at ragged shapes: nb·br under the 132 SMs; rows
    # just over 32 KB; a last slice narrower than the others (16,392
    # bfloat16); a share of rows over a pass of 512 (nb·br = 2,000 × 60);
    # an id outside A; and the general design reached directly at rows over
    # 32 KB, a ragged d and an unaligned base
    for blocks_r, nb_r, br, d, dt in [(9, 1, 3, 8200, torch.float32),
                                      (9, 7, 1, 32768, torch.bfloat16),
                                      (40, 30, 11, 16392, torch.bfloat16),
                                      (2100, 2000, 60, 8200, torch.float32),
                                      (240, 200, 82, 16384, torch.float32)]:
        a_r, x_r = randn(blocks_r * br, d, dtype=dt), randn(d, dtype=dt)
        ids_r = torch.randint(0, blocks_r, (nb_r,), generator=gen, device=dev,
                              dtype=torch.int32)
        if nb_r > 1:
            ids_r[nb_r // 2] = -1
        got, want = cmv.coded_matvec_split(a_r, x_r, ids_r, br), ref.coded_matvec_ref(
            a_r, x_r, ids_r, br)
        keep = ids_r >= 0
        if not torch.isnan(got[~keep].float()).all():
            raise RuntimeError(f"coded_matvec split {(blocks_r, nb_r, br, d, dt)}: an id "
                               "outside A did not give NaN rows")
        compare(f"coded_matvec split {(blocks_r, nb_r, br, d, dt)}", got[keep], want[keep],
                tol[dt])
    del a_r
    flat_r = randn(7 * 13 * 8200 + 1)
    for blocks_r, nb_r, br, a_r, dt in [
            (7, 5, 13, flat_r[1:].view(7 * 13, 8200), torch.float32),
            (6, 9, 5, randn(30, 8201), torch.float32),
            (9, 7, 3, randn(27, 16392, dtype=torch.bfloat16), torch.bfloat16)]:
        x_r = randn(a_r.shape[1], dtype=dt)
        ids_r = torch.randint(0, blocks_r, (nb_r,), generator=gen, device=dev,
                              dtype=torch.int32)
        compare(f"coded_matvec general {(blocks_r, nb_r, br, a_r.shape[1], dt)}",
                cmv.coded_matvec_general(a_r, x_r, ids_r, br),
                ref.coded_matvec_ref(a_r, x_r, ids_r, br), tol[dt])
    del a_r, flat_r

    # mds_encode: the whole matrix, once
    g = torch.as_tensor(MDSCode(N, K).generator, dtype=torch.float32, device=dev)
    blocks = randn(K, rows_w, COLS)
    plane = rows_w * COLS
    record("mds_encode",
           lambda: ops.mds_encode(g, blocks),
           lambda: ref.mds_encode_ref(g, blocks),
           lambda: torch.einsum("nk,krd->nrd", g, blocks),
           n_bytes=4 * (N * K + K * plane + N * plane),
           flops=2 * N * K * plane, tol=tol[torch.float32], library_name="torch.einsum")
    del blocks
    torch.cuda.empty_cache()
    for n, k, r, d, dt in [(12, 10, 100, 260, torch.bfloat16), (5, 3, 63, 130, torch.float32),
                           (5, 3, 63, 130, torch.bfloat16), (4, 4, 16, 640, torch.float32),
                           (40, 32, 10, 8, torch.float32)]:
        g_r = randn(n, k, dtype=dt)
        b_r = randn(k, r, d, dtype=dt)
        compare(f"mds_encode {(n, k, r, d, dt)}", ops.mds_encode(g_r, b_r),
                ref.mds_encode_ref(g_r, b_r), tol[dt])

    # mds_decode: one round's decode as the main path launches it, from the
    # k·C partials that coded_matvec leaves, (k·C, rpc), through a (C, k)
    # position table (each partial used once), into y's final layout
    w = randn(CHUNKS, K, K)
    parts = randn(K * CHUNKS, rpc)
    table = torch.randperm(K * CHUNKS, generator=gen, device=dev).view(CHUNKS, K)
    table_long, table = table, table.to(torch.int32)
    gathered = parts[table_long]

    def y_view():
        return torch.empty(K * rows_w, device=dev).view(K, CHUNKS, rpc).transpose(0, 1)

    record("mds_decode",
           lambda: ops.mds_decode_into(w, parts, table, y_view()),
           lambda: ref.mds_decode_into_ref(w, parts, table, y_view()),
           lambda: torch.bmm(w, gathered),
           n_bytes=4 * (CHUNKS * K * K + CHUNKS * K + 2 * CHUNKS * K * rpc),
           flops=2 * CHUNKS * K * K * rpc, tol=tol[torch.float32],
           library_name="torch.bmm on pre-gathered partials")
    composition = {
        "fused": lambda: ops.mds_decode_into(w, parts, table, y_view()).transpose(0, 1),
        "gather, mds_decode, transpose":
            lambda: ops.mds_decode(w, parts[table_long].float()).transpose(0, 1).reshape(
                K * rows_w),
        "gather, torch.bmm, transpose":
            lambda: torch.bmm(w, parts[table_long]).transpose(0, 1).reshape(K * rows_w),
    }
    for name, fn in composition.items():
        compare(f"mds_decode: {name} vs plain", fn().reshape(K * rows_w),
                ref.mds_decode_into_ref(w, parts, table, y_view()).transpose(0, 1).reshape(
                    K * rows_w), tol[torch.float32])
    names = list(composition)
    in_turns("mds_decode", composition, names + names[::-1])
    for c, k, m, r in [(4, 3, 5, 128), (6, 7, 10, 200), (1, 2, 2, 512), (3, 32, 32, 1000)]:
        w_r, y_r = randn(c, k, m), randn(c, m, r)
        compare(f"mds_decode {(c, k, m, r)}", ops.mds_decode(w_r, y_r),
                ref.mds_decode_ref(w_r, y_r), tol[torch.float32])
    # the table-addressed, strided entry at ragged r, with repeated rows
    for c, k, m, r, n_parts in [(7, 32, 32, 1001, 300), (3, 5, 7, 37, 9), (20, 10, 10, 2999, 200)]:
        w_r, p_r = randn(c, k, m), randn(n_parts, r)
        t_r = torch.randint(0, n_parts, (c, m), generator=gen, device=dev, dtype=torch.int32)
        got = torch.empty(k * c * r, device=dev)
        want = torch.empty(k * c * r, device=dev)
        ops.mds_decode_into(w_r, p_r, t_r, got.view(k, c, r).transpose(0, 1))
        ref.mds_decode_into_ref(w_r, p_r, t_r, want.view(k, c, r).transpose(0, 1))
        compare(f"mds_decode table-addressed {(c, k, m, r, n_parts)}", got, want,
                tol[torch.float32])
    del parts, gathered

    # lstm_cell: what the main path calls, one window of T = 32 steps over the
    # n workers with the trained params, through the sequence kernel
    params = load_params(device=dev)
    hid, out_dim = params.w_hh.shape[1], params.w_out.shape[0]
    seq_w = tuple(p.detach() for p in (params.w_ih, params.w_hh, params.b, params.w_out,
                                       params.b_out))
    wts = seq_w[:3]
    window = torch.as_tensor(controlled_traces(N, WINDOW, n_stragglers=2, seed=7),
                             dtype=torch.float32, device=dev)[:, :, None].contiguous()
    lstm = torch.nn.LSTM(1, hid, device=dev)
    cell = torch.nn.LSTMCell(1, hid, device=dev)
    with torch.no_grad():
        for mod, (w_ih, w_hh, b_ih, b_hh) in [
                (lstm, (lstm.weight_ih_l0, lstm.weight_hh_l0, lstm.bias_ih_l0, lstm.bias_hh_l0)),
                (cell, (cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh))]:
            w_ih.copy_(wts[0])
            w_hh.copy_(wts[1])
            b_ih.copy_(wts[2])
            b_hh.zero_()

    def lstm_and_head(xs_):
        return lstm(xs_)[0] @ seq_w[3].T + seq_w[4]

    with torch.no_grad():
        record("lstm_cell",
               lambda: ops.lstm_sequence(window, *seq_w),
               lambda: ref.lstm_sequence_ref(window, *seq_w),
               lambda: lstm_and_head(window),
               n_bytes=4 * (WINDOW * N + WINDOW * N * out_dim + 4 * hid + 4 * hid * hid
                            + 4 * hid + out_dim * hid + out_dim),
               flops=2 * WINDOW * N * (4 * hid * (1 + hid) + out_dim * hid), tol=1e-5,
               library_name="torch.nn.LSTM(1, 4) over the window, then the head's matmul "
                            "and add")
        records["lstm_cell"]["design"] = "sequence"
        compare("lstm_sequence vs torch.nn.LSTM and the head", ops.lstm_sequence(window, *seq_w),
                lstm_and_head(window), 1e-5)
        compare("lstm_sequence vs the per-step loop", ops.lstm_sequence(window, *seq_w),
                cell_loop(window, *seq_w), 1e-5)
        # the launch floor, and the per-step cell at its main shape
        one = torch.zeros(1, device=dev)
        floor = timed(lambda: one.add_(1))
        xs, hs, cs = randn(N, 1), randn(N, hid), randn(N, hid)
        compare("lstm_cell (main shape)", ops.lstm_cell(xs, hs, cs, *wts),
                ref.lstm_cell_ref(xs, hs, cs, *wts), 1e-5)
        compare("lstm_cell vs torch.nn.LSTMCell", ops.lstm_cell(xs, hs, cs, *wts),
                cell(xs, (hs, cs)), 1e-5)
        cell_t = timed(lambda: ops.lstm_cell(xs, hs, cs, *wts))
    records["lstm_cell"].update(launch_floor_device_ms=floor["device_ms"],
                                launch_floor_call_ms=floor["call_ms"],
                                cell_device_ms=cell_t["device_ms"],
                                cell_call_ms=cell_t["call_ms"])
    print(f"launch floor (a one-element in-place add): device ms {floor['device_ms']:.4f}, "
          f"call ms {floor['call_ms']:.4f}", flush=True)
    print(f"lstm_cell, the per-step cell at ({N}, 1, {hid}): device ms "
          f"{cell_t['device_ms']:.4f}, call ms {cell_t['call_ms']:.4f}", flush=True)
    for b_, i_, h_ in [(100, 3, 8), (7, 2, 16)]:
        args = (randn(b_, i_), randn(b_, h_), randn(b_, h_), randn(4 * h_, i_),
                randn(4 * h_, h_), randn(4 * h_))
        compare(f"lstm_cell {(b_, i_, h_)}", ops.lstm_cell(*args), ref.lstm_cell_ref(*args),
                1e-5)
    # the window at ragged shapes (T, B, I, H, O), weights at init_lstm's
    # 1/sqrt(H) scale: one step, 256 steps, 2,048 rows, xs staged in several
    # chunks, every register bucket, groups with idle lanes, the
    # shared-memory path (H > 8) with O = 4H
    for shape in [(1, N, 1, 4, 1), (256, N, 1, 4, 1), (32, 2048, 1, 4, 1), (10, 100, 3, 8, 2),
                  (7, 7, 2, 16, 1), (1000, 40, 1, 4, 1), (600, 9, 3, 16, 2), (9, 13, 1, 3, 2),
                  (4, 5, 1, 9, 36), (33, 5, 5, 32, 3)]:
        t_, b_, i_, h_, o_ = shape
        sc = h_ ** -0.5
        args = (randn(t_, b_, i_), randn(4 * h_, i_) * sc, randn(4 * h_, h_) * sc,
                randn(4 * h_) * sc, randn(o_, h_) * sc, randn(o_) * sc)
        compare(f"lstm_sequence {shape}", ops.lstm_sequence(*args),
                ref.lstm_sequence_ref(*args), 1e-5)
    # the window in turns: the sequence kernel, the per-step loop, nn.LSTM and head
    with torch.no_grad():
        versions = {
            "sequence kernel": lambda: ops.lstm_sequence(window, *seq_w),
            f"per-step loop ({WINDOW} x lstm_cell, head, stack)":
                lambda: cell_loop(window, *seq_w),
            "torch.nn.LSTM and the head": lambda: lstm_and_head(window),
        }
        in_turns("lstm_cell", versions, list(versions) + list(versions)[::-1])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 4. the main path at full size --------------------------------------
    a_full = torch.randn(ROWS, COLS, generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    code = MDSCode(N, K)
    cm = CodedMatvec(code, CHUNKS)
    predictor = SpeedPredictor(N, load_params())
    traces = controlled_traces(N, ITERS, n_stragglers=2, seed=7)
    x_gen = torch.Generator(device=dev).manual_seed(2)
    # the last prediction's 29-step window: the sequence kernel against
    # the per-step loop, once, before the counters are zeroed
    hist = torch.as_tensor(traces[:ITERS - 1], dtype=torch.float32, device=dev)
    compare(f"predictor on the {ITERS - 1}-step trace window: sequence kernel vs per-step loop",
            predict_next(predictor.params, hist),
            cell_loop(hist[:, :, None].contiguous(), *seq_w)[-1, :, 0], 1e-5)
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coded = cm.shard(a_full)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    a64 = a_full.double()
    iter_s, worst = [], 0.0
    phase_s = {"predict": [], "plan": [], "apply": []}
    for it in range(ITERS):
        x_it = torch.randn(COLS, generator=x_gen, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        speeds = predictor.predict()            # returns on the host: synchronised
        t1 = time.perf_counter()
        alloc = general_allocation(speeds, K, CHUNKS)
        tables = cm.plan_tables(alloc)
        t2 = time.perf_counter()
        y_it = cm.apply(coded, x_it, *tables)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        iter_s.append(t3 - t0)
        for name, dt in zip(phase_s, (t1 - t0, t2 - t1, t3 - t2)):
            phase_s[name].append(dt)
        if y_it.shape != (ROWS,) or not torch.isfinite(y_it).all():
            raise RuntimeError(f"iteration {it}: y has shape {tuple(y_it.shape)} "
                               "or non-finite values")
        want = a64 @ x_it.double()
        err = float((y_it.double() - want).abs().max() / want.abs().max())
        if err > REL_ERR_LIMIT:
            raise RuntimeError(f"iteration {it}: relative error {err:.3e} > {REL_ERR_LIMIT}")
        worst = max(worst, err)
        predictor.observe(traces[it])
    # encode again into the freed tensor's cached memory: the first encode
    # also pays for allocating the 5.9 GB of coded partitions
    del coded
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coded = cm.shard(a_full)
    torch.cuda.synchronize()
    encode_again_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    designs = ops.design_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print(f"main path: encode {encode_s * 1e3:.3f} ms (again, memory cached: "
          f"{encode_again_s * 1e3:.3f} ms); {ITERS} iterations, median "
          f"{statistics.median(iter_s) * 1e3:.3f} ms (min {min(iter_s) * 1e3:.3f}, max "
          f"{max(iter_s) * 1e3:.3f}); worst relative error {worst:.3e}; peak memory "
          f"{peak_gb:.1f} GB", flush=True)
    print("median per phase: " + ", ".join(
        f"{name} {statistics.median(v) * 1e3:.3f} ms" for name, v in phase_s.items()),
        flush=True)
    print(f"last allocation: counts {alloc.count.tolist()} from predicted speeds "
          f"{np.round(speeds, 3).tolist()}", flush=True)
    apply_less_matvec = (statistics.median(phase_s["apply"]) * 1e3
                         - records["coded_matvec"]["device_ms"])
    print(f"apply less coded_matvec's device time: {apply_less_matvec:.4f} ms", flush=True)
    print(f"launches on the main path: {counts}; by design: {designs}", flush=True)
    need = {"mds_encode": 1, "coded_matvec": ITERS, "mds_decode": ITERS}
    short = {k: (counts[k], v) for k, v in need.items() if counts[k] < v}
    if short:
        raise RuntimeError(f"the main path did not run through every kernel: {short}")
    if designs["coded_matvec"] != {"stream": counts["coded_matvec"], "split": 0, "multi": 0,
                                   "general": 0}:
        raise RuntimeError(f"coded_matvec launches on the main path left the stream "
                           f"design: {designs['coded_matvec']}")
    # one sequence launch per prediction with history (iteration 0 has none)
    if designs["lstm_cell"] != {"sequence": ITERS - 1, "cell": 0}:
        raise RuntimeError(f"the predictor did not launch the sequence kernel once per "
                           f"prediction with history: {designs['lstm_cell']}")
    if counts["coded_matvec"] != ITERS or counts["mds_decode"] != ITERS:
        raise RuntimeError(f"apply launched coded_matvec {counts['coded_matvec']} and "
                           f"mds_decode {counts['mds_decode']} times in {ITERS} iterations")
    for name, rec in records.items():
        rec["launches"] = counts[name]
    del a_full, coded, a64
    torch.cuda.empty_cache()

    # -- 5. the cluster engine on the card ----------------------------------
    t0 = time.perf_counter()
    cluster_counts, multi_record = cluster_phase(dev, call_ms, timed, compare, in_turns, ROWS)
    print(f"cluster phase: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, rec in records.items():
        rec["cluster_launches"] = cluster_counts.get(name, 0)
    # the cluster's fault paths, phase 5's last part
    t0 = time.perf_counter()
    chaos_counts, chaos = chaos_part(dev)
    chaos["part_s"] = time.perf_counter() - t0
    print(f"cluster fault scenarios: {chaos['part_s']:.1f} s", flush=True)

    # -- 6. the paper's workloads ---------------------------------------------
    t0 = time.perf_counter()
    split_records, workload_counts, workloads = workloads_phase(dev, call_ms, compare,
                                                                in_turns)
    print(f"workloads phase: {time.perf_counter() - t0:.1f} s", flush=True)
    for rec in list(records.values()) + [multi_record]:
        rec["workload_launches"] = workload_counts[rec["name"]]
    for rec in split_records:
        rec["workload_launches"] = rec["launches"]

    # -- 7. serving a dense LM at full width ----------------------------------
    t0 = time.perf_counter()
    serve_counts, head_record, served = serve_phase(dev, call_ms, timed, compare, in_turns)
    print(f"serve phase: {time.perf_counter() - t0:.1f} s", flush=True)
    for rec in list(records.values()) + [multi_record] + split_records + [head_record]:
        rec["serve_launches"] = serve_counts.get(rec["name"], 0)

    # -- 8. serving the other decoder families ---------------------------------
    t0 = time.perf_counter()
    family_counts, families = families_phase(dev, compare, in_turns)
    print(f"families phase: {time.perf_counter() - t0:.1f} s", flush=True)
    for rec in list(records.values()) + [multi_record] + split_records + [head_record]:
        rec["families_launches"] = family_counts.get(rec["name"], 0)

    # -- 9. serving the encoder-decoder ----------------------------------------
    t0 = time.perf_counter()
    encdec_counts, encdec = encdec_phase(dev, compare, in_turns)
    encdec["phase_s"] = time.perf_counter() - t0
    print(f"encdec phase: {encdec['phase_s']:.1f} s", flush=True)
    for rec in list(records.values()) + [multi_record] + split_records + [head_record]:
        rec["encdec_launches"] = encdec_counts.get(rec["name"], 0)

    # -- 12 (a), started here: the dry-run's cells on the host's cores, the
    # card hidden from them, beside phases 10 and 11; collected in 12
    dryrun_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_")
    dryruns = (dryrun_start(DRYRUN_CELLS, Path(dryrun_dir.name)), Path(dryrun_dir.name))

    # -- 10. training on the card ----------------------------------------------
    t0 = time.perf_counter()
    train_counts, trained = train_phase(dev, compare)
    trained["phase_s"] = time.perf_counter() - t0
    print(f"train phase: {trained['phase_s']:.1f} s", flush=True)
    for rec in list(records.values()) + [multi_record] + split_records + [head_record]:
        rec["train_launches"] = train_counts.get(rec["name"], 0)

    # -- 11. the worker mesh and the step builders -----------------------------
    t0 = time.perf_counter()
    mesh_counts, meshed = mesh_steps_phase(dev)
    meshed["phase_s"] = time.perf_counter() - t0
    print(f"mesh and steps phase: {meshed['phase_s']:.1f} s", flush=True)
    for rec in list(records.values()) + [multi_record] + split_records + [head_record]:
        rec["mesh_launches"] = mesh_counts.get(rec["name"], 0)

    # -- 12. the dry-run, the roofline and the cluster demo --------------------
    t0 = time.perf_counter()
    demo_counts, rooflined = roofline_phase(dev, compare, meshed, dryruns)
    dryrun_dir.cleanup()
    rooflined["phase_s"] = time.perf_counter() - t0
    print(f"dry-run, roofline and demo phase: {rooflined['phase_s']:.1f} s", flush=True)
    for rec in list(records.values()) + [multi_record] + split_records + [head_record]:
        rec["demo_launches"] = demo_counts.get(rec["name"], 0)

    for rec in list(records.values()) + [multi_record] + split_records + [head_record]:
        rec["chaos_launches"] = (None if rec["name"].startswith("coded_matvec")
                                 else chaos_counts.get(rec["name"], 0))
    print(json.dumps({"roofline": rooflined}))
    print(json.dumps({"mesh_steps": meshed}))
    print(json.dumps({"train": trained}))
    print(json.dumps({"encdec": encdec}))
    print(json.dumps({"families": families}))
    print(json.dumps({"serve": served}))
    print(json.dumps({"workloads": workloads}))
    print(json.dumps({"chaos": chaos}))
    print(json.dumps({"in_turns": turns, "apply_less_coded_matvec_ms": apply_less_matvec}))
    print(json.dumps({"kernels": [records[name] for name in KERNELS] + [multi_record]
                      + split_records + [head_record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
