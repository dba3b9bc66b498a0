#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths, MAG-BERT (at S=50,
at long sequences, tensor-parallel over two ranks sharing the card,
pipelined over two stages, fully sharded, over two driver processes, and
with the QKV projection inside the attention kernels) and MAG-XLNet, once
on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N]

(``--mp_driver '<argv as JSON>'`` runs one driver process of phase 6q,
``--phase 6p`` or ``--phase 6r/6s`` one phase in a process of its own;
the script starts those itself.)

Phases, in order (6p and 6r/6s beside 6l-6o, 6q last); any failure
raises and the script exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), CUDA version.
2. Build: compile ``csrc/*.cu`` with nvcc (into ``build/torch_kernels/``).
3. Serving kernel against its plain PyTorch version on the card, on seeded
   ragged masks with one fully padded row: bf16 at B=128 S=50 (the serving
   shape), bf16 at B=8 S=512, fp32 at B=4 S=77, and bf16 at the edges of
   #1's tensor-core plans (``FULL_TC_SERVE_EDGES``: a ragged S=33, Dh=128,
   Dh=40); then both timed at the serving shape, beside
   ``scaled_dot_product_attention`` on the same inputs (the library call
   that computes the same function at rate 0).
3b. Training kernels against their plain versions on the card, bf16 at
   B=256 S=50 (the training shape of the bench) and fp32 at B=4 S=77, at
   rate 0.1 and 0: #1 with dropout and saved probs (its keep mask equal to
   the plain Philox mask bit for bit, the keep rate within 5σ), #3 (saved
   probs) and #2 (recompute) against the plain backward and against
   torch.autograd through the plain forward, #2 against #3, and the same
   bits from the same seed twice; the same at the edges of bf16 #1's and
   #3's tensor-core plans (``FULL_TC_EDGES``: B=128 at S=50, S=64 and 65
   either side of the forward's register plan, #3's longest S at Dh=64
   and 128, Dh=128 and 40 at S=50, a ragged S=33) and #1's training modes
   alone at S=512 (``FULL_TC_FWD_EDGES``); then the three timed at B=256
   S=50, #1 at the driver's S=512 evaluation (B=48, rate 0) beside SDPA,
   and the full-H pair #1′ + #3 against the head-blocked pair #4′ + #5′
   at B=256 S=50 rate 0.1.
3c. The fused MAG gate's kernels (#25 forward, #26 backward chain) against
   their plain versions on the card: bf16 and fp32 text at N=12800 (B=256,
   S=50), D=768, MOSI's 47/74, beta 1e-3, 1 and 1e6; a ragged B=3 S=33;
   MOSEI's 35/74 once; bf16 #25's and #26's tensor-core plans at their
   edges (``MAG_TC_EDGES``: N = 1, 15, 99, bert-large's D = 1024 with 47
   and 35, a D of 100 off the 8-wide copies), three betas each. #26's six
   outputs, and the final gradients built from them, against the plain
   chain's. Then both timed against their plain versions at N = 2400,
   6400 and 12800 (bf16), their bound for bf16 activations three bf16
   passes of the fp32-precision products on the tensor cores
   (``mag_bound``), and the gate's whole backward a call (#26, then
   ``grads_from_chain``'s fp32 products) beside #26 alone.
3d. The rel-attention kernels (#11 forward, #13 saved-probs backward, #12
   recompute backward) against their plain versions, on an ebias assembled
   as the XLNet model does (rel-shifted bd + segment ef, −1e30 on the
   masked keys of left-padded rows): bf16 at B=256 Q=K=50 (rates 0.1 and
   0) and fp32 at B=4 Q=50 K=77 (rate 0.1). #11's keep mask equal to the
   plain Philox mask bit for bit, the keep rate within 5σ; #13 and #12
   against the plain backward and torch.autograd through the plain
   forward, debias included; #12 against #13; the same bits twice. The
   same at the edges of bf16 #11's, #13's and #12's tensor-core plans
   (``REL_TC_EDGES``: the serving shape B=128 at rate 0, the memory's
   Q=50 K=100, Q=33 K=141, Dh=128 at K=50 and 100, K=64 and 65, Q=K=141,
   a query row masked whole, which must come out uniform). Then the three
   timed at B=256
   rate 0.1, #11 at the serving shape (rate 0, B=128) beside
   ``scaled_dot_product_attention`` with the ebias as its mask, #11′ and
   #13 at B=256 Q=50 K=100, and the card's time per launch of each.
3d+. The rel family's counter offsets: #11 (saved probs), #12, #20
   (saved probs), #21, #23 and #24 at rate 0.1, bf16 and fp32, H=12
   Dh=64 B=4: the call on rows 2.. and heads 6.. at (b_off, h_off) =
   (2, 6) gives the full call's slice of every output bit for bit, and at
   (0, 0) another mask; then one TP rank's (H=6) #11′, #13, #20′, #22
   (B=256 S=50) and #23′, #24 (B=48 S=1024) timed.
3e. The long-sequence kernels (#4 head-blocked forward, #5 its recompute
   backward, #6 flash-streamed forward with lse, #7 its backward in two
   launches) against their plain versions: bf16 at B=8, S=512, 640
   (#4/#5 and #6/#7) and 1024 (#6/#7), rates 0.1 and 0; fp32 at B=2,
   S=600 and a ragged S=700. #6 also against the whole-row plain forward
   within a stated bf16 bound, and in fp32 #7 against the whole-row
   backward on the rows with a real token; the bf16 tensor-core plans'
   edges (``FS_EDGES``, ``HB_EDGES``: Dh=40, Dh=128 at S=640, S ragged off
   16, 700 for #7; ``HB_BWD_EDGES``: S=141, the first S that takes #5
   with a gradient); #4 against #1 (S=128, 512) and #5 against #2 (S=128)
   bit for bit in fp32, within the forward bound and ``dqkv_bf16_bound`` in
   bf16; #4's, #6's and #5's keep masks against the plain Philox mask bit
   for bit (Q = K = 0, V the identity; #5's dV with g the identity); the
   same bits twice. Then the four timed at
   the driver's shapes (bf16 B=48; #4 and #5 at S=512, #6 and #7 at
   S=1024) at rate 0 beside ``scaled_dot_product_attention`` (forward; its
   autograd backward) and at rate 0.1, #5's two launches also apart.
3f. The long-sequence rel kernels (#14/#15 head-blocked, #23/#24 the
   ingredients flash-streamed tier) against their plain versions, with the
   bf16 tensor-core plans' edges (``RELIK_FS_EDGES``: Dh=40 and 128, S
   ragged off 16 and 64, Q ≠ K); #14 against #11 within the forward bound
   in bf16 and bit for bit in fp32, #15 against #12 within
   ``rel_grads_bf16_bound`` in bf16 and bit for bit in fp32; #23's keep
   mask; their times at B=48 beside SDPA with the assembled ebias, #15's
   two bf16 launches and #24's three timed apart.
3g. The rel flash-streamed kernels (#16 forward with lse, #17 its
   backward in two launches, debias from the dQ pass) against their plain
   versions on the ebias the model assembles: fp32 B=2 at a ragged Q=70
   K=131, bf16 B=2 at Q=K=1024 and at Q=512 K=1024 (the memory's K ≠ Q),
   and the edges of bf16 #16's and #17's tensor-core plans
   (``REL_FS_EDGES``: Q=70 K=131, Q=512 K=562, Q=136 K=200 at Dh=128,
   Dh=40, each with a key block and a query row masked whole), rates 0.1
   and 0; #17 within ``rel_fs_grads_bf16_bound``; where K ≤ 640 #15 on
   the same case within ``rel_grads_bf16_bound``; the same bits twice. #16's and #14's keep masks equal to the plain Philox mask
   bit for bit at Q=K=512 (q = 0, v the identity on a rotating key
   window), #16's output against #14's within a stated bf16 bound; #15's
   and #17's keep masks through their dV (q = k = 0, g the identity, Q =
   Dh = 128, K = 200). Then both timed at bf16 B=48 Q=K=1024 at rate 0
   (beside SDPA with the ebias as a float mask, and its autograd backward)
   and at rate 0.1, #17's two launches also apart.
3h. The full-H ingredients kernels (``rel_bias_impl="inkernel"``: #20
   forward, #22 saved-probs backward, #21 recompute backward, the last two
   two launches a call) against their plain versions: bf16 B=256 Q=K=50 at
   rates 0.1 and 0, bf16 B=48 Q=50 K=100 P=150 (the 50-row memory), fp32
   B=4 Q=50 K=77 (ragged, K ≠ Q), on XLNet-like ingredients with left
   padding; #20's keep mask against the plain Philox mask; #21 against #22;
   the same bits twice (dr deterministic); #20 against #11 fed the
   assembled ebias; then timed at B=256 (rate 0.1; at rate 0 beside SDPA
   with the assembled ebias as a float mask and its autograd backward), #20
   at the serving shape B=128.
3i. The split-layout kernels (#8 forward, #10 saved-probs backward, #9
   recompute backward; q, k, v [B, H, S, Dh], the layout of a
   tensor-parallel rank's heads) against their plain versions: bf16 B=256
   S=50 at H=12 (rates 0.1 and 0) and at H=6 with the batch-row and head
   offsets of a data-rank-1, model-rank-1 shard, fp32 B=4 S=77 with
   offsets; #8's keep mask against the plain Philox mask of the shard's
   global rows and heads, #8 = #1 on the packed q|k|v bit for bit, the
   backwards against torch.autograd and each other, the same bits twice;
   then timed at H=12 and H=6: #8 at the serving shape (B=128, rate 0)
   beside SDPA, the three at B=256 rate 0.1, #9 at rate 0 beside SDPA's
   autograd backward.
3j. The QKV-projection kernels (#18 forward with the projection x·W + b
   inside, #19 its saved-probs backward with dx = dqkv·Wᵀ inside, two
   launches a call) against their plain versions: bf16 B=256 S=50 at
   bert-base width (rates 0.1 and 0), fp32 B=4 at a ragged S=77 with a
   fully padded row, bf16 B=8 S=50 at bert-large width (D=1024, H=16);
   saved probs and the emitted qkv, #1 on its emitted qkv (bit for bit in
   fp32 and, to S = 64, where both run #1's register plan, in bf16; past
   it within the phase-3 bound with the same keep mask) and on the plain
   projection's qkv, #18's keep masks
   (saved, and read off the output of the mode that saves nothing), #19
   re-projecting from x = #19 reading the emitted qkv bit for bit, bf16
   #19's dqkv = #3's on the same (p, pd, qkv, g) bit for bit (one compute
   half), both against the plain backward and against torch.autograd
   through the plain forward, the same bits twice; then timed at the
   serving shape (B=128, rate 0) and the training shape (B=256, rate 0.1)
   beside the split structure they replace (``F.linear`` + #1, #3 + the dx
   matmul) and, at rate 0, ``F.linear`` + SDPA (forward; its autograd
   backward); #19's dx launch alone beside ``torch.matmul(dqkv, w_rows)``.
   The same checks at bf16 #18's edges (``QKVPROJ_EDGES``: S = 64, 65 and
   122, the reach with a gradient) and the forward at its reach without
   one (S = 468).
3k. Kernel T (``csrc/threefry_dropout.cu``, Flax dropout on JAX's
   threefry2x32 stream) against its plain version on the card, bit for
   bit: bf16 [256, 50, 768] (the hidden dropout's shape at the bench's
   batch), fp32 [4, 77, 768] and bf16 [256, 12, 50, 50] (the einsum
   probs); a column slice (dim −1 from 384) and a row slice (rows 128..)
   equal the full draw's slices; the backward's regenerated mask on a
   cotangent; the keep rate within 5σ of 0.9. Then timed beside its plain
   version (``F.dropout``'s time printed as context: it draws torch's
   Philox mask, not JAX's, so it is no library column).
4. Serving path: ``MagBertForSequenceClassification`` at bert-base width
   with MOSI modality dims, bf16 compute, ``attention_impl="fused"``,
   random weights from a seeded generator. ``Predictor.score_split`` over
   a 685-example split (the MOSI test split's size) at batch 128, then
   ``predict_requests`` over 4 requests of 256. Checks: the kernel ran
   once per layer per batch, every prediction is finite, and the fused
   predictions agree with the same weights on ``attention_impl="einsum"``.
4b. Training path: the same model with its default dropouts,
   ``Trainer.train`` for one epoch over seeded splits of MOSI's sizes
   (1281/229/685) at ``driver.py``'s batch sizes (48 train, 128 dev/test):
   26 full steps and the ragged tail of 33 through the masked step.
   Checks: finite losses, the JAX trainer's record keys, the kernels'
   launch counts (#1 once per layer per batch of all three splits, #3
   once per layer per train step), then one step under
   ``FUSED_ATTN_SAVE=0`` through #2; and at dropout 0, from one copy of
   the weights, 5 steps on fused (saved), fused (recompute) and einsum
   attention: losses within a stated bound, and the first step's gradients
   leaf by leaf within a stated bf16 bound of einsum's, a bound that the
   same step with dK zeroed in #3 must break.
4c. XLNet serving: ``MagXLNetForSequenceClassification`` at
   xlnet-base-cased width, MOSI dims, bf16, ``attention_impl="fused"``,
   seeded random weights, over XLNet-packed splits (left padding,
   segments 0/2/3): ``Predictor.score_split`` over 685 examples at batch
   128 and ``predict_requests`` over 4 requests of 256. Checks: #11 once
   per layer per batch, finite predictions, fused against einsum.
4d. Long-sequence serving: ``Predictor.predict_split`` at bert-base
   width with a 1024-row position table over 256 examples at batch 128,
   at S=640 (#4 once per layer per batch) and S=1024 (#6), against einsum.
4e. XLNet long-sequence serving: ``predict_split`` at xlnet-base-cased
   width at S=640 and 1024 (#23 once per layer per batch), against einsum.
4f. XLNet serving through the rel fs tier: ``predict_split`` with
   ``rel_bias_impl="stream"`` at S=1024 (#16 once per layer per batch),
   and ``Predictor(mem_len=512)`` at S=512 under "stream" (Q=512, K=1024:
   #16), the memory chained through the batches; each against einsum.
4g. XLNet serving under ``rel_bias_impl="inkernel"``: ``serving_path`` at
   S=50, batch 128 (#20 once per layer per batch and nothing else, against
   einsum), no ``rel_shift`` call, and one batch's profile (#20 runs, #11
   does not).
4h. Tensor-parallel serving: two ranks sharing the card over gloo
   (``parallel/mesh.py::run_ranks``), each with the head-sharded fused
   bert-base model, ``Predictor(mesh=)`` over 256 examples at batch 128:
   #8 once per layer per batch on each rank and nothing else, both ranks'
   gathered predictions equal, within 5e-2 of the one-card einsum model's.
4j. Tensor-parallel MAG-XLNet serving: two ranks sharing the card
   serve 256 XLNet-packed examples through ``Predictor(mesh=)`` at
   xlnet-base-cased width, bf16, H=6 a rank: #11 once a layer a batch and
   nothing else, the ranks' predictions equal and within ``PRED_ATOL`` of
   the one-card einsum model's. (After 4i in the run.)
4k. ``attention_impl="flash"`` serving: bert-base bf16 at S=512, batch
   48: #6 once a layer a batch and nothing else, the predictions within
   ``PRED_ATOL`` of the einsum model's; then #6 at B=48 S=512 timed beside
   ``scaled_dot_product_attention`` with the [B, 1, 1, S] mask.
4i. Serving with ``qkv_fusion``: ``serving_path`` at bert-base bf16, batch
   128: #18 once per layer per batch and nothing else, against einsum.
5. Serving profile: one batch's serial latency, its device time by kernel
   and the card's busy share (torch.profiler).
5b. Training speed at the bench's geometry, B=256 S=50: examples/s over
   20 steps after 3 warm-up steps, the per-step median and spread, the
   peak memory, and one step's device time by kernel and busy share.
6. The driver on the card: ``driver.main`` in this process with
   ``--model bert-base-uncased --dataset mosi --synthetic
   --synthetic_sizes 1281 229 685 --n_epochs 1 --use_fused_mag
   --attention_impl fused --compute_dtype bfloat16``. Checks: exit 0,
   finite losses, #25 once per forward batch (27 train + 2 dev + 6 test),
   #26 once per train step, #1 and #3 as in 4b. Then at dropout 0, over six
   seeded weights and batches, one step with the fused gate against the
   plain gate in fp32 (every leaf's gradient within a stated bound, which
   the same step with dpv zeroed in #26's output must break) and in bf16
   (each gap within the plain gate's own drift from the fp32 step); and
   the device time of the gate's forward and backward alone against a
   whole training step's, fused and plain.
6b. The XLNet driver: ``driver.main`` with ``--model xlnet-base-cased
   --dataset mosi --synthetic --synthetic_sizes 1281 229 685 --n_epochs 1
   --attention_impl fused --compute_dtype bfloat16``: exit 0, finite
   losses, #11 once per layer per batch (12 x (27 + 2 + 6) = 420), #13
   once per layer per train step (324); one step under
   ``FUSED_ATTN_SAVE=0`` through #12 (12), and one profiled B=256 step
   with the probs recomputed (#12) and saved (#13); at dropout 0, from one copy of
   the weights, one step fused against einsum leaf by leaf within a stated
   bound, which the same step with debias, then dK, zeroed in #13's output
   must break; then XLNet train examples/s at B=256 S=50 (20 steps after 3
   warm-up), the median and quartiles, the peak memory and one step's
   device time by kernel.
6c. The driver at long sequences: ``driver.main ... --attention_impl
   fused --max_seq_length 512`` and ``1024`` over synthetic splits of
   96/48/48: exit 0, finite losses; at 512 training takes #4 and #5 (two
   launches a call) and evaluation #1; at 1024 training takes #6 and #7
   and evaluation #6.
   Then one training step at B=48, S=512 and 1024, by device time.
6d. The XLNet driver at long sequences: ``--max_seq_length 512`` and
   ``1024`` (#23/#24 in training), ``--rel_bias_impl stream`` at 512
   (#14/#15, #15 two launches a call in bf16); the S=512 gradient checks
   under auto (planted zero dr and ded in #24) and under stream (planted
   zero debias in #15); profiled B=48 steps at S=1024 (auto) and S=512
   (stream).
6e. The XLNet driver through the rel fs tier and with the memory:
   ``--rel_bias_impl stream --max_seq_length 1024`` (#16, #17),
   ``--mem_len 512 --max_seq_length 512`` under "stream" (#16, #17 at
   Q=512, K=1024) and under "auto" (#23, #24 at K ≠ Q), ``--mem_len 50``
   at S=50 (#11, #13 at K=100): exit 0, finite losses, the launches, each
   run's peak device memory; then at dropout 0 one S=1024 stream step at
   batch 4, fused against einsum leaf by leaf, which the same step with
   debias zeroed in #17's output must break; one profiled B=48 S=1024
   stream step.
6f. The XLNet driver under ``--rel_bias_impl inkernel`` at S=50 over
   96/48/48: as written (#20, #22), with ``--mem_len 50`` (K = 100) and
   under ``FUSED_ATTN_SAVE=0`` (#21): exit 0, finite losses, the launches;
   the dropout-0 gradient check against einsum with planted zero dr and
   ded; one profiled B=256 S=50 step under "inkernel" and under "auto",
   and the device time the ebias assembly costs.
6g. The tensor-parallel driver: ``driver.main --model_parallel 2
   --tp_shard_attention --attention_impl fused`` at bert-base over
   96/48/48 (two ranks sharing the card): exit 0, finite losses equal on
   both ranks, #8 once per layer per batch and #10 once per layer per
   train step on each rank; then two dropout-0 steps of the two-rank
   model (fp32 head-sharded with the saved-probs backward, with the
   recompute backward #9 under ``FUSED_ATTN_SAVE=0``, and the FFN split
   alone on #1/#3; bf16 head-sharded) against the one-card model's losses
   within a stated bound.
6h. The driver with the QKV projection inside the kernels: ``driver.main
   --attention_impl fused --qkv_fusion`` and ``... --qkv_residual`` at
   bert-base over 96/48/48: exit 0, finite losses, #18 = 48 and #19 = 48
   launches (24 calls) each; one step under ``FUSED_ATTN_SAVE=0`` (#1, #2,
   no #18/#19); at dropout 0 from one copy of the weights the first step's
   gradients leaf by leaf against the split fused step (#1/#3) in fp32
   within 1e-4, which the same step with dx, then dK, zeroed in #19's
   output must break, and in bf16 both fused steps' gaps to einsum; one
   profiled B=256 S=50 step with and without ``qkv_fusion``.
6i. Checkpoint, resume and warm start through ``driver.main`` at
   bert-base, S=50, bf16, ``--attention_impl fused --use_fused_mag``
   (#1, #3, #25, #26), over 144/48/48 (3 steps an epoch, 2 epochs), in a
   temporary directory deleted afterwards: two uninterrupted runs end at
   the same params, moments, count, generator state and step bit for bit;
   so do a run stopped mid-epoch (``--save_every_steps 1 --max_steps 2``)
   and one stopped at epoch 0's end (``--max_steps 3``), each then
   ``--resume``d; ``--export_hf`` writes the encoder as .bin (the second
   straight run) and .safetensors (the epoch resume), and a fresh run
   warm-started from each (``--pretrained_checkpoint``, one step at
   learning rate 0, saved) holds the file's encoder bit for bit and the
   fresh draw's MAG and classifier; ``--predict_only --wire_dtype
   bfloat16`` prints finite test scores; a MAG-XLNet run (#11, #13, #25,
   #26) stopped after one step and resumed. Every run's launches are
   checked. Then a bert-base checkpoint (vocabulary 30522) after one step:
   its bytes, its save and restore wall times (the read warm in the page
   cache), and a B=48 train step's wall time with and without a save
   after it, printed as a ``{"checkpoint": ...}`` line.
6j. The serving artifact (``serving.py``) at bert-base and xlnet-base
   width, S=50, bf16, over 685 synthetic rows at batch 128, each saved,
   loaded with ``device="cuda"`` and served by ``predict_batches``: the
   portable artifact of a fused model (a copy on the einsum path, no
   kernel launched; within ``PRED_ATOL`` of the eager fused predictions;
   the symbolic batch at 1 and 5 rows), the fused artifact at
   ``batch_size=128`` (#1 twelve times a batch, nothing else) and the fused
   XLNet artifact with the fused gate (#11 twelve times and #25 once a
   batch), each against the eager ``Predictor`` and its ex/s beside the
   ``Predictor``'s, printed as an ``{"artifact": ...}`` line.
6k. ``driver.main`` with ``--remat`` and ``--remat --remat_policy dots``
   at bert-base (S=50, bf16, fused attention and gate, 144/48/48) against
   the same run without: the printed losses and the final checkpoint bit
   for bit, #1 twice a layer a step; MAG-XLNet ``--remat`` likewise with
   #11. Then peak memory and step time with and without remat at B=48:
   BERT S=512, XLNet S=1024 under stream and under auto, printed as a
   ``{"remat_memory": ...}`` line.
6t. ``driver.main --rng_impl threefry2x32`` at bert-base (S=50, bf16,
   fused attention and gate, 96/48/48, two train steps): exit 0, finite
   losses, the native tokenizer taken (``{"native_tokenizer": ...}``),
   and the launches predicted: #1′ and #3 once a layer a step (their
   Philox seeded with JAX's ``randint`` of each layer's key), #25/#26,
   and kernel T 54 times a step (27 sites: embeddings, MAG, the attention
   output and the FFN of each layer, the pooled output; forward and
   backward). Then one fp32 einsum threefry step of bert-base and of
   xlnet-base at B=8 S=50 on the card against the port's CPU step from the
   same weights (drawn on the card from ``PRNGKey``) and key: the loss
   within ``TF_STEP_LOSS_RTOL`` relative, each gradient within
   ``TF_STEP_GRAD_TOL`` of its leaf's scale, T launched for every mask
   site (78 and 105 a step), and a step from another key moving the loss
   by far more; printed as a ``{"threefry_steps": ...}`` line.
6l. The tensor-parallel MAG-XLNet driver: ``driver.run --model
   xlnet-base-cased --model_parallel 2 --tp_shard_attention
   --attention_impl fused`` over 96/48/48 on two ranks sharing the card
   over gloo (#11 once a layer a batch, #13 once a layer a train step, on
   each rank), then with ``--rel_bias_impl inkernel`` (#20, #22); exit 0
   and the same epoch records on both ranks. Then, in one two-rank spawn:
   two dropout-0 steps (lr 1e-5) of the two-rank model against the
   one-card model from the same weights, fp32, bf16 and the FFN split
   alone (losses within ``TP_STEP_TOL``, every first-step gradient within
   ``TP_GRAD_TOL`` of its chunk of the one card's); the fp32 step at
   dropout 0.1 against the one-card fused step within the fp32 bounds,
   which forcing rank 1's head offset to 0 must break; one S=512 step
   (bf16, B=8) through #23 and #24 on each rank.
6m. ``attention_impl="flash"``: ``driver.main --attention_impl flash
   --max_seq_length 512`` over 96/48/48 (training at prob dropout 0.1
   runs einsum: no #6/#7; #6 once a layer an evaluation batch); then one
   dropout-0 step of bert-base (fp32, B=48, S=512) through #6/#7 against
   the einsum model, every gradient within ``FLASH_GRAD_TOL`` of its
   leaf's scale, which zeroing #7's dK must break.
6n. The pipelined MAG-BERT driver: ``driver.run --pipeline_parallel 2
   --pp_microbatches 4 --attention_impl fused --use_fused_mag`` over
   96/48/48 on two stages sharing the card over gloo: exit 0, the same
   finite records on both ranks, #1′ once a layer a microbatch (training
   and evaluation) and #3 once a layer a training microbatch on each
   stage's 6 layers, #25/#26 on stage 0 only. 6o. The same for MAG-XLNet
   (#11′/#13; the gate before layer 1, on stage 0). Then, in one two-rank
   spawn for both families: two dropout-0 steps (lr 1e-5, B=48, 4
   microbatches of 12) of the pipelined model against one card's
   grad_accum=4 steps from the same weights, fp32 (``PAR_FP32_TOL``) and
   bf16 (``PAR_BF16_FACTOR`` × one card's own bf16 drift from fp32, read
   in the same rank), every gradient leaf by leaf, with the planted fault
   (the prologue's and epilogue's gradients not summed over the stages)
   past the fp32 bound; the second step's wall beside one card's with the
   phase's other ranks waiting.
6p. PP×TP (``--pipeline_parallel 2 --model_parallel 2``, bert-base, four
   ranks: #1′/#3 on full heads) through the driver and its step check;
   ``--fsdp --model_parallel 2 --tp_shard_attention`` (#8/#10) and
   ``--fsdp`` (xlnet-base-cased, one process) through the driver; the
   FSDP step checks on two data ranks (both families) and FSDP×TP on
   2 × 2 (bert-base), the same bounds, with each FSDP rank's peak memory
   beside a plain data-parallel rank's, printed as a
   ``{"fsdp_peak_memory": ...}`` line. 6p runs in a process of its own
   (``--phase 6p``) beside 6l-6o, and 6r/6s (with 6q's ``--fsdp
   --model_parallel 2`` run) in another beside 6n/6o; their ranks share
   the card and the host's cores, so the walls of 6l-6p and 6r/6s are
   not clean, and 6q runs last, alone.
6q. Two driver processes (``--num_processes 2 --process_id {0,1}``
   over a loopback coordinator, each a subprocess under its own timeout),
   bert-base with the fused attention and gate in bf16 at 96 rows a step
   (48 a rank) over 192/96/96, both ranks on the card over gloo: exit 0,
   process 1 prints no epoch line, each process launches #1′/#3 and
   #25/#26 as predicted, and process 0's record equals, bit for bit, the
   same run through one process's two spawned ranks (the driver's rank
   function on a two-data-rank mesh); the second train step's wall beside
   the two ranks' and one card's (``{"multiprocess_step_ms": ...}``);
   and ``--fsdp --model_parallel 2`` over two processes of two ranks each
   (four ranks on the card, run beside 6r and 6s; ``--tp_shard_attention``
   is refused with ``--num_processes``, so #1′/#3 on full heads): exit 0,
   finite and equal records, the same launches a rank.
6r. The XLNet memory over two data ranks: xlnet-base-cased, mem_len 50
   (K = 100), two memory steps at B=48 and ``Predictor(mesh=,
   mem_len=50)`` over 96 rows, fp32 and bf16, against one card's from the
   same weights: fp32 within ``PAR_FP32_TOL``, bf16 within
   ``PAR_BF16_FACTOR`` × one card's drift read in the same rank (#11′,
   #13, #11 serving, #25/#26). 6s. ``make_shard_map_train_step`` on the
   same two data ranks, bert-base bf16 at dropout 0.1 (#1′/#3): two steps,
   bit for bit against the ``Trainer``'s data-parallel step (the same
   step under the JAX name, so this holds by construction; the phase
   drives #1′/#3 through that entry point).
7. The result: a ``{"phase_seconds": ...}`` line (each phase's wall
   seconds, from its start to the next phase's, and each process run
   beside others from its start to its result), a JSON line for the
   kernels (launches on the paths, max error against the plain version,
   times, the bound and the library call), then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

S_SERVE = 50
BATCH = 128
N_TEST = 685          # MOSI test split size
N_REQUESTS, REQUEST_SIZE = 4, 256
MOSI_SPLITS = (1281, 229, 685)
TRAIN_BATCH, EVAL_BATCH = 48, 128   # driver.py's defaults
BENCH_BATCH = 256                   # the bench's train-step batch
RATE = 0.1                          # attention_probs_dropout_prob
# bf16 kernel vs plain: both round the probs and the output to bf16 once,
# from fp32 sums taken in different orders. A rounding that lands the
# other way moves a prob by one bf16 ulp (2^-8 relative) and the output by
# one ulp of its magnitude, so the bound is 2^-7 relative plus 2^-6
# absolute for outputs near zero (Σ |Δp|·|v| with |v| ≲ 4).
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -6
# fp32: the same math in fp32, summed in a different order.
FP32_ATOL = 1e-5
# fp32 gradients: atol and rtol 1e-5, as the JAX package's kernel tests.
# bf16 gradients: fused_attention.dqkv_bf16_bound, one bf16 ulp of every
# rounded pd_c and ds_c element and of the output.
GRAD_FP32_TOL = 1e-5
# fused vs einsum predictions: the two branches do the same attention math
# but sum in different orders; a bf16 rounding flip in any of the 12 layers
# moves a logit by a few ulps of the activations (2^-8 relative). A wrong
# kernel moves logits by their own scale (≈ 0.4 at this init).
PRED_ATOL = 5e-2
# Training at dropout 0 from one copy of the weights, fused against einsum.
# The first step's gradients, per leaf (the packed qkv leaves split into
# their Q, K and V rows): ‖g − g_einsum‖ / ‖g_einsum‖, with the einsum
# branch's attention taking the fused branch's forward bits
# (``fused_value_plain_grad``: #1's value, the plain math's gradient), so
# that the two forwards are the same bits; the backwards round p, ds and
# the context gradients to bf16 at different points, which moves a leaf by
# a few bf16 ulps (2^-8 relative; the worst piece reads 1.2e-2 on the card).
# A wrong dQ, dK or dV moves its own piece by its whole norm (the planted
# fault below reads 1). Against the plain einsum branch, whose forward sums
# in cuBLAS's order where bf16 #1 sums on the tensor cores, the gaps are
# printed as a record: one-ulp differences in ~1e-4 of #1's outputs grow
# through the 12 layers and move the leaves that mostly cancel (the
# LayerNorm and dense biases) by up to 1.7e-1 (chip_ab.py on the H100).
GRAD_GAP_TOL = 5e-2
# The loss over 5 steps: the largest gap seen on the card is 3.7e-3 (PERF.md,
# Findings); the bound is about ten times that. Too coarse to see a wrong
# gradient at lr 1e-5: the gradient check above is the one with power.
LOSS_ATOL = 4e-2
# Phase 3c. #25 against its plain version: fp32 1e-5 relative plus 1e-5
# absolute (the same math summed in another order); bf16 one bf16 rounding
# of the output, 2^-7 relative, plus 1e-5 absolute.
MAG_FP32_TOL = 1e-5
MAG_BF16_RTOL, MAG_ATOL = 2.0 ** -7, 1e-5
# #26's six fp32 outputs, and the final gradients built from them: 2e-4
# relative and absolute, the band of the JAX package's own test of its
# backward kernel. An element whose pre-activation lies within MAG_TIE of 0
# may take the other side of the ReLU when the products sum in another
# order; such elements are counted and left out of the chain's check, and
# take the plain chain's values before the final gradients are built (a
# bias gradient sums 12800 rows that mostly cancel, so a few such elements
# move it past the band). Input gradients returned in bf16 are rounded
# once more: 2^-7 relative there.
MAG_BWD_TOL, MAG_TIE = 2e-4, 1e-5
# Phase 3c's edges of bf16 #25's and #26's tensor-core plans (B, S, D,
# Dv): one row, N = 15 and 99 off their 64-row block, bert-large's cluster
# of 8 blocks, and a D off the 8-wide copies (one block, a partial warp).
MAG_TC_EDGES = ((1, 1, 768, 47), (1, 15, 768, 47), (9, 11, 768, 35),
                (2, S_SERVE, 1024, 47), (3, 33, 1024, 35), (2, 7, 100, 47))
# Phase 6: one dropout-0 step with the fused gate against the plain gate,
# per leaf as in 4b, over GATE_SEEDS seeded weights and batches, in fp32.
# In bf16 the two gates round their outputs from fp32 sums taken in other
# orders, and the flipped roundings grow through the 12 layers: each bf16
# gate's step lies 3.1e-2 to 1.7e-1 from the fp32 step, and fused against
# plain reads 7.7e-3 to 4.1e-2 (5.5e-2 once), so no bf16 bound between the
# two has a margin (ROADMAP C.2). In fp32 the two agree to 2.1e-6-9.1e-6
# (the worst leaf, six seeds, on the card); the bound is ten times that.
# dpv zeroed moves the gate's W_hv leaves by their whole norm (1.0). In
# bf16 each seed's fused-vs-plain gap must stay within the plain gate's
# own drift from the fp32 step.
GATE_FP32_TOL = 1e-4
GATE_SEEDS = 6
# Phase 6b: one dropout-0 XLNet step, fused against einsum, per leaf as in
# 4b. Unlike BERT's two branches, whose forwards are the same bits,
# XLNet's differ: the einsum branch sums (ac + bd + ef) in fp32 where the
# fused branch rounds bd, ef and their sum (ebias) to bf16 in each of the
# 12 layers, and its backward rounds debias. The activations then differ
# by bf16 ulps that grow through the stack, and a leaf whose gradient is a
# sum over all 2400 rows that mostly cancels (the FFN and LayerNorm
# biases) reads up to 7.1e-2 on the card (4.0e-2 on the ebias-side leaves
# r_r_bias, r, seg_embed, r_s_bias). A zero debias takes those leaves'
# score gradient away (they read 1.0), a zero dK the k leaves' (1.0).
XLNET_GRAD_GAP_TOL = 0.25
# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W): device memory
# bytes/s, dense bf16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor
# cores. A kernel's bound is the larger of its bytes over the first and its
# operations over the rate of their type.
HBM_BYTES_S, BF16_FLOPS, FP32_FLOPS = 3.35e12, 989e12, 67e12
# Kernel-name substrings of #25 and #26 (each its fp32 CUDA-core kernel
# and its bf16 tensor-core plan).
MAG_KERNELS = ("mag_fwd_kernel", "mag_fwd_tc_kernel", "mag_bwd_kernel",
               "mag_bwd_tc_kernel")
# Kernel-name substrings that sort a profile into groups (the first match
# wins; the rest is "other elementwise").
PROFILE_GROUPS = (
    ("attention kernels (csrc)", ("attn_fwd_packed", "attn_bwd_packed",
                                  "attn_full_tc",
                                  "attn_fwd_split", "attn_bwd_split",
                                  "attn_fwd_qkvproj", "attn_bwd_qkvproj",
                                  "attn_fwd_rel", "attn_bwd_rel")),
    ("MAG gate kernels (csrc)", MAG_KERNELS),
    ("GEMMs (cuBLAS)", ("nvjet", "gemm")),
    ("AdamW _foreach", ("multi_tensor_apply",)),
    ("host copies, memsets", ("Memcpy", "Memset")),
    ("casts and copies", ("copy_kernel",)),
    ("reductions", ("reduce_kernel",)),
)


# Kernel-name substrings of #11 and #13 (their fp32 CUDA-core kernels and
# their bf16 tensor-core plans) that a profile's share line sums; #11's
# score-tile plan past K = 64 is also #14's bf16 kernel.
REL_FULL_KERNELS = (
    ("#11", ("attn_fwd_rel_kernel", "attn_fwd_rel_tc_reg_")),
    ("#11/#14 score tile", ("attn_fwd_rel_tc_smem_",)),
    ("#13", ("attn_bwd_rel_saved_kernel", "attn_bwd_rel_saved_tc_")),
    ("#12", ("attn_bwd_rel_kernel", "attn_bwd_rel_tc_")),
)
# Kernel-name substrings of #18 and #19's two launches (each dtype's
# kernels: `attn_bwd_qkvproj_heads_tc_kernel`, `..._dx_tc_kernel` in bf16).
QKVPROJ_KERNELS = (("#18", "attn_fwd_qkvproj"),
                   ("#19 (head, batch row) pass", "attn_bwd_qkvproj_heads"),
                   ("#19 dx", "attn_bwd_qkvproj_dx"))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def tc_ptxas_lines(log):
    """``-Xptxas -v``'s registers and spills of the tensor-core kernels
    (the bf16 instantiations of #4, #6, #14, #16, #23, the packed backward
    passes of #5 and #7, the rel backward passes of #15 and #17, #24's two
    passes, the full-H plans of #1/#8 and #3/#10 built into each of their
    sources, #2/#9's recompute plan, the rel full-H plans of #11, #13 and
    #12, the full-H ingredients plans of #20, #21 and #22, #18's register
    plan with its projection, #19's (head, batch row) pass and dx product
    and #25's and #26's three-plane plans), one line each, from the build
    log.
    Template arguments print in order: the packed and rel passes' are <n8
    tiles of Dh, own statistics (#5, #15 true; #7, #17 false), dropout>;
    the full-H, rel and ingredients register forwards' <n8 tiles of Dh,
    dropout, save>, their score-tile forwards' <dropout, save>, the full-H
    backward's <n8 key tiles, n8 tiles of Dh>, the recompute's <n8 tiles
    of Dh, dropout>, the rel backward's <n8 tiles of Dh>, #12's <n8 tiles
    of Dh, dropout, threads, blocks an SM>, #21's <n8 tiles of Dh,
    dropout, blocks an SM>, #22's <n8 tiles of Dh, blocks an SM>, #18's
    <n8 tiles of Dh, dropout, save, emit>, #19's pass <batch rows, n8 key
    tiles, n8 tiles of Dh, recompute>."""
    import re

    lines, name, spills, source = [], None, "", ""
    for line in log.splitlines():
        if line.startswith("$ "):
            source = line.split()[-1].rsplit("/", 1)[-1]
            continue
        m = re.search(r"Compiling entry function '\S*?((?:(?:attn_fwd_(?:"
                      r"packed|relik|rel)_fs|attn_fwd_(?:packed|rel)_hb|"
                      r"attn_bwd_(?:packed|rel|relik_fs)_(?:dkdv|dq))_tc|"
                      r"attn_full_tc_(?:fwd_reg|fwd_smem|bwd_saved|"
                      r"bwd_recompute)|attn_fwd_rel(?:ik)?_tc_(?:reg|smem)|"
                      r"attn_bwd_rel(?:_saved)?_tc|attn_bwd_relik(?:_saved)?_tc|"
                      r"attn_fwd_qkvproj_tc_reg|attn_bwd_qkvproj_heads_tc)"
                      r"_kernel)I((?:L[ib]\d+E)+)E", line)
        plain = re.search(r"Compiling entry function '\S*?("
                          r"attn_bwd_qkvproj_dx_tc_kernel|mag_fwd_tc_kernel|"
                          r"mag_bwd_tc_kernel)E",
                          line)
        if plain:
            name = plain.group(1)
            continue
        if m:
            args = ", ".join(
                v if k == "i" else ("true" if v == "1" else "false")
                for k, v in re.findall(r"L([ib])(\d+)E", m.group(2)))
            name = f"{m.group(1)}<{args}>"
            continue
        if name and "spill" in line:
            spills = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            lines.append(f"ptxas {name} (bf16, sm_90a, {source}): "
                         f"{m.group(1)} registers; {spills}")
            name = None
    return lines


def _ragged_mask(rng, b, s):
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = 0            # one fully padded row
    lengths[-1] = s           # one full row
    return (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)


def _time_ms(fn, iters):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _alternate(run_plain, run_kernel, iters):
    """Per-call ms of each, in rounds plain, kernel, kernel, plain after a
    warm-up; returns (kernel rounds, plain rounds)."""
    for fn in (run_plain, run_kernel):
        _time_ms(fn, 3)
    rounds = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        rounds[name].append(_time_ms(
            run_kernel if name == "kernel" else run_plain, iters))
    return rounds["kernel"], rounds["plain"]


def _wrappers(fa):
    from bert_multimodal_transformer_tpu_torch.ops import dropout as tfd
    from bert_multimodal_transformer_tpu_torch.ops import mag_fused as mf

    return {"attn_fwd_packed": fa.attn_fwd_packed_cuda,
            "attn_bwd_packed_saved": fa.attn_bwd_packed_saved_cuda,
            "attn_bwd_packed": fa.attn_bwd_packed_cuda,
            "mag_fwd": mf.mag_fwd_cuda, "mag_bwd": mf.mag_bwd_cuda,
            "attn_fwd_rel": fa.attn_fwd_rel_cuda,
            "attn_bwd_rel_saved": fa.attn_bwd_rel_saved_cuda,
            "attn_bwd_rel": fa.attn_bwd_rel_cuda,
            "attn_fwd_packed_hb": fa.attn_fwd_packed_hb_cuda,
            "attn_bwd_packed_hb": fa.attn_bwd_packed_hb_cuda,
            "attn_fwd_packed_fs": fa.attn_fwd_packed_fs_cuda,
            "attn_bwd_packed_fs": fa.attn_bwd_packed_fs_cuda,
            "attn_fwd_rel_hb": fa.attn_fwd_rel_hb_cuda,
            "attn_bwd_rel_hb": fa.attn_bwd_rel_hb_cuda,
            "attn_fwd_relik_fs": fa.attn_fwd_relik_fs_cuda,
            "attn_bwd_relik_fs": fa.attn_bwd_relik_fs_cuda,
            "attn_fwd_rel_fs": fa.attn_fwd_rel_fs_cuda,
            "attn_bwd_rel_fs": fa.attn_bwd_rel_fs_cuda,
            "attn_fwd_relik": fa.attn_fwd_relik_cuda,
            "attn_bwd_relik_saved": fa.attn_bwd_relik_saved_cuda,
            "attn_bwd_relik": fa.attn_bwd_relik_cuda,
            "attn_fwd_split": fa.attn_fwd_split_cuda,
            "attn_bwd_split_saved": fa.attn_bwd_split_saved_cuda,
            "attn_bwd_split": fa.attn_bwd_split_cuda,
            "attn_fwd_qkvproj": fa.attn_fwd_qkvproj_cuda,
            "attn_bwd_qkvproj": fa.attn_bwd_qkvproj_cuda,
            "threefry_dropout": tfd.threefry_dropout_cuda}


def _counts(fa):
    return {name: fn.launches for name, fn in _wrappers(fa).items()}


def _zero_counts(fa):
    for fn in _wrappers(fa).values():
        fn.launches = 0


def _want(fa, **launches):
    """The launch counts a path must show: those given, 0 for every other
    kernel."""
    return {name: launches.get(name, 0) for name in _wrappers(fa)}


def _bound(n_bytes, n_ops, op_rate):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over their type's peak rate."""
    mem_ms, ops_ms = n_bytes / HBM_BYTES_S * 1e3, n_ops / op_rate * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


def attn_bound(kind, b, s, h, dh, itemsize, rate=0.0, save=False):
    """The bound of attention kernel ``kind`` at [B, S, H, Dh]: each input
    read once, each output written once; the products on the bf16 tensor
    cores (2·B·H·S²·Dh operations each: QKᵀ and PV forward; dV, d(pd), dQ
    and dK backward, plus QKᵀ again for the recompute)."""
    d = h * dh
    qkv, ctx, mask = b * s * 3 * d * itemsize, b * s * d * itemsize, b * s * 4
    n_probs = 2 if rate > 0 else 1
    probs = b * h * s * s * itemsize * n_probs
    dot = 2 * b * h * s * s * dh
    if kind == "fwd":
        n_bytes, n_ops = qkv + mask + ctx + (probs if save else 0), 2 * dot
    elif kind == "bwd_saved":   # reads p, pd (the same tensor at rate 0)
        n_bytes, n_ops = probs + qkv + ctx + qkv, 4 * dot
    else:
        n_bytes, n_ops = qkv + mask + ctx + qkv, 5 * dot
    return _bound(n_bytes, n_ops, BF16_FLOPS)


def mag_bound(kind, n, d, dv, da, itemsize):
    """The bound of #25 (``fwd``) or #26 at N rows: the six products are
    2·N·D·(2D + 2Dv + 2Da) operations at fp32 precision (the TPU kernel's
    dots run at Precision.HIGHEST). With fp32 activations, at the fp32 rate
    outside the tensor cores; with bf16 activations the least time for the
    same precision is three bf16 passes on the tensor cores (the
    activations exact, each fp32 weight three bf16 planes: bf16 #25's
    plan), 3× the operations at the bf16 rate. The bytes are the
    activations read once, the fp32 weights once, and the outputs written
    once (y in the text dtype; six [N, D] fp32 for #26, which also reads
    dy)."""
    weights = 4 * (2 * d * d + 2 * (dv + da) * d + 6 * d)
    acts = n * (d + dv + da) * itemsize
    if kind == "fwd":
        n_bytes = acts + weights + n * d * itemsize
    else:
        n_bytes = acts + n * d * itemsize + weights + 6 * n * d * 4
    ops = 2 * n * d * (2 * d + 2 * dv + 2 * da)
    if itemsize == 2:
        return _bound(n_bytes, 3 * ops, BF16_FLOPS)
    return _bound(n_bytes, ops, FP32_FLOPS)


def check_kernel(rng, fa, dtype_name, b, s, h=12, dh=64):
    """Kernel vs plain version on one seeded case; returns max abs err."""
    import torch

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype_name]
    d = h * dh
    qkv = torch.from_numpy(
        rng.standard_normal((b, s, 3 * d), dtype=np.float32)).to(
        "cuda", dtype)
    mask = torch.from_numpy(_ragged_mask(rng, b, s)).cuda().float()
    scale = 1.0 / dh ** 0.5
    out = fa.attn_fwd_packed_cuda(qkv, mask, n_heads=h, scale=scale)
    ref = fa.attn_fwd_packed_reference(qkv, mask, n_heads=h, scale=scale)
    torch.cuda.synchronize()
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    max_err = float(err.max())
    if dtype_name == "bf16":
        bad = err > BF16_ATOL + BF16_RTOL * ref.abs()
    else:
        bad = err > FP32_ATOL
    print(f"kernel vs plain {dtype_name} B={b} S={s} H={h} Dh={dh}: "
          f"max_abs_err={max_err:.3e} finite={bool(torch.isfinite(out).all())}")
    if bool(bad.any()) or not bool(torch.isfinite(out).all()):
        raise AssertionError(
            f"kernel disagrees with plain version ({dtype_name} B={b} "
            f"S={s}): max_abs_err={max_err}, {int(bad.sum())} elements "
            "out of tolerance")
    return max_err, (qkv, mask, scale, h)


def _forward_err(name, got, want, dtype_name):
    """Max abs err of a forward tensor; raises past the phase-3 bound."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    if dtype_name == "bf16":
        bad = err > BF16_ATOL + BF16_RTOL * want.abs()
    else:
        bad = err > FP32_ATOL
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements out of "
                             f"tolerance, max_abs_err={float(err.max())}")
    return float(err.max())


def _grad_err(name, got, want, dtype_name, bound_args, fa):
    """Max abs err of a dqkv; raises past the stated bound."""
    import torch

    err = (got.float() - want.float()).abs()
    if dtype_name == "bf16":
        p, pd, qkv, g, kw = bound_args
        bound = fa.dqkv_bf16_bound(want, p, pd, qkv, g, **kw)
    else:
        bound = GRAD_FP32_TOL + GRAD_FP32_TOL * want.float().abs()
    bad = err > bound
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements out of "
                             f"tolerance, max_abs_err={float(err.max())}")
    return float(err.max())


def _check_keep(fa, name, seed, p, pd, rate, tag, offs=(0, 0)):
    """At rate > 0: the kernel's keep mask (pd > 0 where p > 0) equals the
    plain Philox mask of [B, H, Q, K] (its batch rows and heads from
    ``offs``) bit for bit, and the keep rates of the stream and of the
    kernel lie within 5σ of 1 − rate; at rate 0 the saved pd is p. Returns
    the line's tail."""
    import torch

    if rate <= 0:
        if pd is not p:
            raise AssertionError(f"{name}: at rate 0 the saved pd must be p")
        return ""
    keep = fa.dropout_keep_mask(seed, *p.shape, rate, p.device, b0=offs[0],
                                h0=offs[1])
    live = p > 0
    kernel_keep = (pd > 0)[live]
    if not torch.equal(kernel_keep, keep[live]):
        raise AssertionError(f"{name} keep mask differs from the plain "
                             f"Philox mask ({tag})")
    rates = []
    for kept in (keep, kernel_keep):
        n = kept.numel()
        got = float(kept.double().mean())
        sigma = math.sqrt(rate * (1 - rate) / n)
        if abs(got - (1 - rate)) >= 5 * sigma:
            raise AssertionError(f"{name} keep rate {got} not within 5σ "
                                 f"({sigma:.2e}) of {1 - rate}")
        rates.append(f"{got:.6f} over {n} (5σ={5 * sigma:.1e})")
    return (f"; keep mask = plain Philox mask bit for bit on the "
            f"{int(live.sum())} live probs; keep rate: stream {rates[0]}, "
            f"kernel {rates[1]}")


def check_training_kernels(rng, fa, dtype_name, b, s, rate, h=12, dh=64):
    """Phase 3b on one seeded case: #1 with save (and dropout at rate > 0),
    #3 and #2, each against its plain version and the backward also
    against torch.autograd through the plain forward. Returns the max
    errors and the case's tensors."""
    import torch

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype_name]
    d = h * dh
    qkv = torch.from_numpy(rng.standard_normal(
        (b, s, 3 * d), dtype=np.float32)).to("cuda", dtype)
    g = torch.from_numpy(rng.standard_normal(
        (b, s, d), dtype=np.float32)).to("cuda", dtype)
    mask = torch.from_numpy(_ragged_mask(rng, b, s)).cuda().float()
    seed = int(rng.integers(0, 2 ** 63 - 1))
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5)
    tag = f"{dtype_name} B={b} S={s} H={h} Dh={dh} rate={rate}"

    out, p, pd = fa.attn_fwd_packed_cuda(qkv, mask, rate=rate, seed=seed,
                                         save=True, **kw)
    r_out, r_p, r_pd = fa.attn_fwd_packed_reference(
        qkv, mask, rate=rate, seed=seed, save=True, **kw)
    errs = {"fwd": max(_forward_err(f"#1 {n} {tag}", x, r, dtype_name)
                       for n, x, r in (("out", out, r_out), ("p", p, r_p),
                                       ("pd", pd, r_pd)))}
    print(f"#1 vs plain {tag}: out/p/pd max_abs_err={errs['fwd']:.3e}"
          + _check_keep(fa, "#1", seed, p, pd, rate, tag))

    saved = fa.attn_bwd_packed_saved_cuda(p, pd, qkv, g, **kw)
    recomputed = fa.attn_bwd_packed_cuda(qkv, mask, seed, g, rate=rate,
                                         **kw)
    r_saved = fa.attn_bwd_packed_saved_reference(p, pd, qkv, g, **kw)
    r_recomputed = fa.attn_bwd_packed_reference(qkv, mask, seed, g,
                                                rate=rate, **kw)
    x = qkv.detach().clone().requires_grad_()
    fa.attn_fwd_packed_reference(x, mask, rate=rate, seed=seed,
                                 **kw).backward(g)
    bound_args = (p, pd, qkv, g, kw)
    for name, got, want in (("#3 vs plain", saved, r_saved),
                            ("#3 vs autograd", saved, x.grad),
                            ("#2 vs plain", recomputed, r_recomputed),
                            ("#2 vs autograd", recomputed, x.grad),
                            ("#2 vs #3", recomputed, saved)):
        errs[name] = _grad_err(f"{name} {tag}", got, want, dtype_name,
                               bound_args, fa)
    print(f"backward {tag}: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items() if k != "fwd"))

    again = (fa.attn_fwd_packed_cuda(qkv, mask, rate=rate, seed=seed,
                                     save=True, **kw),
             fa.attn_bwd_packed_saved_cuda(p, pd, qkv, g, **kw),
             fa.attn_bwd_packed_cuda(qkv, mask, seed, g, rate=rate, **kw))
    same = (all(torch.equal(a, b) for a, b in zip(again[0], (out, p, pd)))
            and torch.equal(again[1], saved)
            and torch.equal(again[2], recomputed))
    print(f"same seed twice {tag}: identical bits {same}")
    if not same:
        raise AssertionError(f"the kernels are not bit-reproducible ({tag})")
    return errs, (qkv, mask, g, seed, kw)


def time_training_kernels(fa, case, card):
    """#1 (rate 0.1, save), #3 and #2 against their plain versions, in
    alternating rounds, then #2 at rate 0 beside SDPA's autograd backward
    (dq, dk, dv) on the same q, k, v; returns {name: (kernel ms, plain
    ms)} and, under "attn_bwd_packed rate 0", #2's rate-0 entry."""
    qkv, mask, g, seed, kw = case
    _, p, pd = fa.attn_fwd_packed_cuda(qkv, mask, rate=RATE, seed=seed,
                                       save=True, **kw)
    pairs = {
        "attn_fwd_packed": (
            lambda: fa.attn_fwd_packed_cuda(qkv, mask, rate=RATE, seed=seed,
                                            save=True, **kw),
            lambda: fa.attn_fwd_packed_reference(qkv, mask, rate=RATE,
                                                 seed=seed, save=True,
                                                 **kw)),
        "attn_bwd_packed_saved": (
            lambda: fa.attn_bwd_packed_saved_cuda(p, pd, qkv, g, **kw),
            lambda: fa.attn_bwd_packed_saved_reference(p, pd, qkv, g, **kw)),
        "attn_bwd_packed": (
            lambda: fa.attn_bwd_packed_cuda(qkv, mask, seed, g, rate=RATE,
                                            **kw),
            lambda: fa.attn_bwd_packed_reference(qkv, mask, seed, g,
                                                 rate=RATE, **kw)),
    }
    times = {}
    b, s = qkv.shape[:2]
    for name, (run_kernel, run_plain) in pairs.items():
        k, pl = _alternate(run_plain, run_kernel, 20)
        times[name] = (float(np.mean(k)), float(np.mean(pl)))
        print(f"{name} bf16 B={b} S={s} H=12 Dh=64 rate={RATE} on {card}: "
              f"kernel {k} ms, plain {pl} ms per call")
    k, pl = _alternate(
        lambda: fa.attn_bwd_packed_reference(qkv, mask, 0, g, **kw),
        lambda: fa.attn_bwd_packed_cuda(qkv, mask, 0, g, **kw), 20)
    heads = [x.contiguous() for x in fa._heads(qkv, 12)]
    lib = split_sdpa_calls(*heads, mask, fa._ctx_heads(g, 12).contiguous())[1]
    _time_ms(lib, 3)
    lib_ms = float(np.mean([_time_ms(lib, 20) for _ in range(2)]))
    bound = attn_bound("bwd", b, s, 12, 64, 2)
    times["attn_bwd_packed rate 0"] = {
        "ms": float(np.mean(k)), "plain_ms": float(np.mean(pl)),
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms,
        "library": "scaled_dot_product_attention autograd backward (dq, dk, "
                   "dv), rate 0"}
    print(f"attn_bwd_packed bf16 B={b} S={s} H=12 Dh=64 rate 0 on {card}: "
          f"kernel {k} ms, plain {pl} ms per call, library {lib_ms:.4f} ms; "
          f"bound {bound[0]:.4f} ms ({bound[1]})")
    return times


# bf16 #1's and #3's tensor-core plans (csrc/attn_full_tc.cuh) at their
# edges, (B, S, H, Dh), each from a seeded ragged mask with a batch row
# masked whole. Phase 3, serving (rate 0): a ragged S = 33, Dh = 128 and
# 40. Phase 3b, the training modes and #3: the serving batch at S = 50,
# the register plan's last S and the score tile's first, the backward's
# longest S at Dh = 64 and 128, Dh = 128 and 40, a ragged S = 33; then the
# forward alone at S = 512, past the backward's reach.
FULL_TC_SERVE_EDGES = ((8, 33, 12, 64), (8, S_SERVE, 6, 128),
                       (8, S_SERVE, 8, 40))
FULL_TC_EDGES = ((BATCH, S_SERVE, 12, 64), (8, 64, 12, 64), (8, 65, 12, 64),
                 (8, 140, 12, 64), (8, 117, 4, 128), (16, S_SERVE, 6, 128),
                 (16, S_SERVE, 8, 40), (16, 33, 12, 64))
FULL_TC_FWD_EDGES = ((8, 512, 12, 64), (4, 512, 4, 128))


def check_forward_modes(rng, fa, b, s, rate, h=12, dh=64):
    """Phase 3b's forward alone, bf16 #1 past #3's reach: out, p and pd
    with saved probs against the plain forward within the phase-3 bound,
    the keep mask against the plain Philox mask, the same bits twice and
    the same output without the save. Returns the max error."""
    import torch

    qkv = torch.from_numpy(rng.standard_normal(
        (b, s, 3 * h * dh), dtype=np.float32)).to("cuda", torch.bfloat16)
    mask = torch.from_numpy(_ragged_mask(rng, b, s)).cuda().float()
    seed = int(rng.integers(0, 2 ** 63 - 1))
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5, rate=rate, seed=seed)
    tag = f"bf16 B={b} S={s} H={h} Dh={dh} rate={rate}"
    got = fa.attn_fwd_packed_cuda(qkv, mask, save=True, **kw)
    want = fa.attn_fwd_packed_reference(qkv, mask, save=True, **kw)
    err = max(_forward_err(f"#1 {n} {tag}", x, r, "bf16")
              for n, x, r in zip(("out", "p", "pd"), got, want))
    again = fa.attn_fwd_packed_cuda(qkv, mask, save=True, **kw)
    same = (all(torch.equal(x, y) for x, y in zip(again, got))
            and torch.equal(fa.attn_fwd_packed_cuda(qkv, mask, **kw), got[0]))
    print(f"#1 vs plain {tag}: out/p/pd max_abs_err={err:.3e}"
          + _check_keep(fa, "#1", seed, got[1], got[2], rate, tag)
          + f"; the same bits twice and without the save: {same}")
    if not same:
        raise AssertionError(f"#1 not bit-reproducible across modes ({tag})")
    return err


def kernel_device_ms(fn, key, iters=50):
    """The card's time per launch of the kernels whose names hold ``key``
    over ``iters`` calls of ``fn`` (torch.profiler), with no host time
    between launches counted: at ~0.04 ms a call the wrappers' host work
    paces the back-to-back calls that the CUDA events time."""
    from bert_multimodal_transformer_tpu_torch.utils.profiling import (
        device_time_by_kernel,
    )

    fn()
    rows = [(calls, ms) for name, calls, ms in
            device_time_by_kernel(fn, iters)["kernels"] if key in name]
    return sum(ms for _, ms in rows) / sum(calls for calls, _ in rows)


def time_full_tc(rng, fa, card, case, serve_case):
    """bf16 #1 at the driver's S = 512 evaluation (B=48, rate 0) against
    its plain version and SDPA; the card's time per launch of #1 at
    serving (``serve_case``), #1′ and #3 (``kernel_device_ms``); then, at
    the bench's training shape (B=256, S=50, rate 0.1, ``case``), the
    full-H pair #1′ (saved probs) + #3 against the head-blocked pair #4′ +
    #5′ (recompute), in alternating rounds (hb, full, full, hb). Returns
    {"eval_s512": entry, "device_ms": {...}, "pairs": {"full_ms",
    "hb_ms", ...}}."""
    qkv, mask, _, _ = long_case(rng, "bf16", TRAIN_BATCH, 512)
    kw = dict(n_heads=12, scale=0.125)
    k, pl = _alternate(
        lambda: fa.attn_fwd_packed_reference(qkv, mask, **kw),
        lambda: fa.attn_fwd_packed_cuda(qkv, mask, **kw), 10)
    lib = sdpa_call(qkv, mask, 12, 0.125)[0]
    _time_ms(lib, 3)
    lib_ms = float(np.mean([_time_ms(lib, 10) for _ in range(2)]))
    bound = attn_bound("fwd", TRAIN_BATCH, 512, 12, 64, 2)
    eval_entry = {"ms": float(np.mean(k)), "plain_ms": float(np.mean(pl)),
                  "bound_ms": bound[0], "bound_by": bound[1],
                  "library_ms": lib_ms,
                  "library": "scaled_dot_product_attention"}
    print(f"attn_fwd_packed bf16 B={TRAIN_BATCH} S=512 H=12 Dh=64 rate 0 on "
          f"{card}: kernel {k} ms, plain {pl} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms per call; bound "
          f"{bound[0]:.4f} ms ({bound[1]})")
    del qkv, mask

    qkv, mask, g, seed, kw = case

    def full():
        _, p, pd = fa.attn_fwd_packed_cuda(qkv, mask, rate=RATE, seed=seed,
                                           save=True, **kw)
        fa.attn_bwd_packed_saved_cuda(p, pd, qkv, g, **kw)

    def hb():
        fa.attn_fwd_packed_hb_cuda(qkv, mask, rate=RATE, seed=seed, **kw)
        fa.attn_bwd_packed_hb_cuda(qkv, mask, seed, g, rate=RATE, **kw)

    f_ms, h_ms = _alternate(hb, full, 20)
    s_qkv, s_mask, s_scale, s_h = serve_case
    _, p, pd = fa.attn_fwd_packed_cuda(qkv, mask, rate=RATE, seed=seed,
                                       save=True, **kw)
    device = {
        "#1 serving bf16 B=128 S=50 rate 0": kernel_device_ms(
            lambda: fa.attn_fwd_packed_cuda(s_qkv, s_mask, n_heads=s_h,
                                            scale=s_scale), "attn_full_tc"),
        f"#1' bf16 B=256 S=50 rate {RATE} saved probs": kernel_device_ms(
            lambda: fa.attn_fwd_packed_cuda(qkv, mask, rate=RATE, seed=seed,
                                            save=True, **kw),
            "attn_full_tc"),
        "#3 bf16 B=256 S=50": kernel_device_ms(
            lambda: fa.attn_bwd_packed_saved_cuda(p, pd, qkv, g, **kw),
            "attn_full_tc")}
    print(f"the card's time per launch (torch.profiler) on {card}: "
          + ", ".join(f"{k_} {v_:.4f} ms" for k_, v_ in device.items()))
    b, s = qkv.shape[:2]
    pairs = {"full_ms": float(np.mean(f_ms)), "hb_ms": float(np.mean(h_ms)),
             "shape": f"bf16 B={b} S={s} H=12 Dh=64 rate {RATE}",
             "full": "#1' (saved probs) + #3", "hb": "#4' + #5' (recompute)"}
    print(f"full-H pair #1' + #3 vs head-blocked pair #4' + #5', bf16 B={b} "
          f"S={s} rate {RATE} on {card}: full {f_ms} ms, hb {h_ms} ms per "
          f"step's call")
    return {"eval_s512": eval_entry, "device_ms": device, "pairs": pairs}


def make_split(rng, n, s, vocab, dv, da):
    """A seeded PackedSplit shaped like the BERT packing: [CLS] tokens
    [SEP], right padding, zero modality rows on specials and padding."""
    from bert_multimodal_transformer_tpu_torch.data.pipeline import (
        PackedSplit,
    )

    lengths = rng.integers(3, s + 1, size=n)
    real = np.arange(s)[None, :] < lengths[:, None]
    ids = rng.integers(1000, vocab, size=(n, s)).astype(np.int32)
    ids[:, 0] = 101
    ids[np.arange(n), lengths - 1] = 102
    ids[~real] = 0
    inner = real.copy()
    inner[:, 0] = False
    inner[np.arange(n), lengths - 1] = False
    vis = rng.standard_normal((n, s, dv), dtype=np.float32) * inner[..., None]
    ac = rng.standard_normal((n, s, da), dtype=np.float32) * inner[..., None]
    labels = rng.uniform(-3.0, 3.0, size=n).astype(np.float32)
    return PackedSplit(ids, vis.astype(np.float32), ac.astype(np.float32),
                       real.astype(np.int32), np.zeros((n, s), np.int32),
                       labels)


def profile_batch(predictor, split, card, iters=5):
    """Serial latency of one batch, then its device time by kernel."""
    from bert_multimodal_transformer_tpu_torch.utils.profiling import (
        device_time_by_kernel,
    )

    batch = split.take(np.arange(BATCH)).as_tuple()[:5]

    def one_batch():
        predictor.fetch(predictor.submit(*batch))

    one_batch()
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        one_batch()
        lat.append((time.perf_counter() - t0) * 1e3)
    print(f"one batch of {BATCH}, submit to fetch, on {card}: median "
          f"{np.median(lat):.3f} ms, max {max(lat):.3f} ms (20 runs)")
    _print_profile(device_time_by_kernel(one_batch, iters), iters, "batch")


def _print_profile(prof, iters, unit):
    print(f"profile of {iters} {unit}(es): wall "
          f"{prof['wall_ms'] / iters:.3f} ms/{unit}, device "
          f"{prof['device_ms'] / iters:.3f} ms/{unit}, busy "
          f"{prof['device_ms'] / prof['wall_ms']:.1%}")
    groups = {}
    for name, _, ms in prof["kernels"]:
        group = next((g for g, keys in PROFILE_GROUPS if any(
            k in name for k in keys)), "other elementwise")
        groups[group] = groups.get(group, 0.0) + ms
    print(f"  by group, ms/{unit} (share of device time): " + "; ".join(
        f"{g} {ms / iters:.3f} ({ms / prof['device_ms']:.1%})"
        for g, ms in sorted(groups.items(), key=lambda x: -x[1])))
    rel = {tag: sum(ms for name, _, ms in prof["kernels"]
                    if any(k in name for k in keys))
           for tag, keys in REL_FULL_KERNELS}
    if any(rel.values()):
        print(f"  the rel full-H kernels, ms/{unit} (share of device time): "
              + "; ".join(f"{tag} {ms / iters:.3f} "
                          f"({ms / prof['device_ms']:.1%})"
                          for tag, ms in rel.items()))
    qkv = {tag: sum(ms for name, _, ms in prof["kernels"] if key in name)
           for tag, key in QKVPROJ_KERNELS}
    if any(qkv.values()):
        print(f"  the QKV-projection kernels, ms/{unit} (share of device "
              "time): " + "; ".join(f"{tag} {ms / iters:.3f} "
                                    f"({ms / prof['device_ms']:.1%})"
                                    for tag, ms in qkv.items()))
    for name, calls, ms in prof["kernels"][:25]:
        print(f"  {ms / iters:9.4f} ms/{unit} {calls / iters:7.1f} "
              f"calls/{unit}  {name[:110]}")


def _device_batch(batch):
    import torch

    return tuple(torch.as_tensor(np.asarray(a)).cuda() for a in batch)


def _grad_pieces(model):
    """The fp32 gradients by leaf, each packed qkv leaf split into its Q, K
    and V rows, so a fault in one of dQ, dK, dV shows in its own piece."""
    out = {}
    for name, p in model.named_parameters():
        if p.grad is None:   # XLNet's mask_emb: the query stream's input
            continue
        g = p.grad.detach().float()
        if ".qkv." in name:
            for part, piece in zip("qkv", g.chunk(3)):
                out[f"{name}[{part}]"] = piece.clone()
        else:
            out[name] = g.clone()
    return out


def _grad_gaps(got, ref):
    """[(piece, ‖got − ref‖ / ‖ref‖)], worst first. The key bias is left
    out: its gradient is zero in exact arithmetic (it shifts every score of
    a query by the same amount, which the softmax ignores), so both sides
    hold rounding there."""
    gaps = {k: float((got[k] - r).norm() / r.norm()) for k, r in ref.items()
            if not k.endswith(".qkv.bias[k]")}
    return sorted(gaps.items(), key=lambda kv: -kv[1])


def fused_value_plain_grad(fa, plain, q, k, v, bias, *, scale, **kw):
    """Phase 4b's reference attention for the einsum branch, at dropout 0:
    the value is kernel #1's on the packed q|k|v (the fused branch's
    forward bits), the gradient is autograd's through ``plain``
    (``ops/attention.py::dot_product_attention``) at the same q, k, v.
    Phase 4b's gradient bound assumes the two branches' forwards are the
    same bits: the CUDA-core #1 summed as cuBLAS does and gave them; bf16
    #1 sums on the tensor cores, and its one-ulp differences in ~1e-4 of
    the outputs grow through the 12 layers. q, k, v [B, H, S, Dh], bias
    [B, 1, 1, S] of (1 − m)·−10000; returns [B, H, S, Dh]."""
    import torch

    if (kw.get("head_mask") is not None or kw.get("return_probs")
            or (kw.get("dropout_rate", 0.0) > 0.0
                and not kw.get("deterministic", True))):
        raise ValueError("fused_value_plain_grad takes dropout 0 only")

    class FusedValuePlainGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            ctx.save_for_backward(q, k, v)
            b, h, s, dh = q.shape
            out = fa.attn_fwd_packed_cuda(
                fa._pack(q, k, v), (bias.reshape(b, s) == 0).float(),
                n_heads=h, scale=scale)
            return out.view(b, s, h, dh).permute(0, 2, 1, 3).contiguous()

        @staticmethod
        def backward(ctx, g):
            with torch.enable_grad():
                xs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
                return torch.autograd.grad(plain(*xs, bias, scale=scale), xs,
                                           g)

    return FusedValuePlainGrad.apply(q, k, v)


def train_path(args, rng, fa, model_args, card):
    """Phase 4b. Returns the launch counts of the two training drives."""
    import torch

    from bert_multimodal_transformer_tpu_torch.data.pipeline import (
        BatchIterator,
    )
    from bert_multimodal_transformer_tpu_torch.models import (
        bert as bert_model,
    )
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
        make_train_step,
    )

    cfg, mm, dv, da = model_args
    layers = cfg.num_hidden_layers
    model = MagBertForSequenceClassification(
        cfg, mm, dv, da, torch.bfloat16, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(args.seed + 2))
    splits = [make_split(rng, n, S_SERVE, cfg.vocab_size, dv, da)
              for n in MOSI_SPLITS]
    train_it = BatchIterator(splits[0], TRAIN_BATCH, shuffle=True,
                             drop_remainder=False, seed=args.seed)
    dev_it, test_it = (BatchIterator(sp, EVAL_BATCH, shuffle=False,
                                     drop_remainder=False)
                       for sp in splits[1:])
    # driver.py's count of optimizer steps: int(N / batch) per epoch
    n_opt = int(MOSI_SPLITS[0] / TRAIN_BATCH)
    trainer = Trainer(model=model, tx=make_optimizer(1e-5, n_opt, 0.1))
    state = trainer.create_state_from_params(None, args.seed)
    os.environ.pop("FUSED_ATTN_SAVE", None)

    _zero_counts(fa)
    t0 = time.perf_counter()
    state, summary = trainer.train(state, train_it, dev_it, test_it,
                                   n_epochs=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _counts(fa)
    record = summary["history"][0]
    print(f"Trainer.train, 1 epoch on {card}: {dt:.2f} s, record "
          f"{json.dumps(record)}")
    keys = {"epoch", "train_loss", "valid_loss", "test_acc", "test_mae",
            "test_corr", "test_f_score", "best_valid_loss",
            "best_test_acc", "epoch_seconds"}
    if set(record) != keys:
        raise AssertionError(f"record keys {sorted(record)} != the JAX "
                             f"trainer's {sorted(keys)}")
    # the epoch loss is the mean of the step losses (each ≥ 0), so it is
    # finite iff every one of them is
    if not (math.isfinite(record["train_loss"])
            and math.isfinite(record["valid_loss"])):
        raise AssertionError(f"non-finite loss in {record}")
    n_train, n_eval = len(train_it), len(dev_it) + len(test_it)
    want = _want(fa, attn_fwd_packed=layers * (n_train + n_eval),
                 attn_bwd_packed_saved=layers * n_train)
    print(f"kernel launches in Trainer.train: {counts} (want {want}: "
          f"{layers} layers x ({n_train} train + {n_eval} dev/test "
          f"batches), #3 on the save path)")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")

    batch = _device_batch(next(iter(BatchIterator(
        splits[0], TRAIN_BATCH, shuffle=False, drop_remainder=True)))[0])
    step = make_train_step()
    os.environ["FUSED_ATTN_SAVE"] = "0"
    _zero_counts(fa)
    loss = float(step(state, batch))
    recompute_counts = _counts(fa)
    os.environ.pop("FUSED_ATTN_SAVE")
    want = _want(fa, attn_fwd_packed=layers, attn_bwd_packed=layers)
    print(f"one train step under FUSED_ATTN_SAVE=0: loss {loss:.6f}, "
          f"launches {recompute_counts} (want {want})")
    if recompute_counts != want or not math.isfinite(loss):
        raise AssertionError(f"recompute step: {recompute_counts}, {loss}")

    # At dropout 0, from one copy of the weights: 5 steps on each branch,
    # and the first step's gradients held against einsum's.
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del trainer, state, model
    cfg0 = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    mm0 = dataclasses.replace(mm, dropout_prob=0.0)
    batches = [_device_batch(bt) for bt, _ in BatchIterator(
        splits[0], TRAIN_BATCH, shuffle=False, drop_remainder=True)][:5]

    def run_branch(impl, save, n_steps):
        m = MagBertForSequenceClassification(
            dataclasses.replace(cfg0, attention_impl=impl), mm0, dv, da,
            torch.bfloat16, device="cuda")
        m.load_state_dict(weights)
        st = Trainer(model=m, tx=make_optimizer(
            1e-5, len(batches), 0.1)).create_state_from_params(None,
                                                               args.seed)
        if save is not None:
            os.environ["FUSED_ATTN_SAVE"] = save
        ls = [float(step(st, batches[0]))]
        grads = _grad_pieces(m)
        ls += [float(step(st, bt)) for bt in batches[1:n_steps]]
        os.environ.pop("FUSED_ATTN_SAVE", None)
        return ls, grads

    losses, grads = {}, {}
    for name, impl, save in (("fused, saved probs", "fused", "1"),
                             ("fused, recompute", "fused", "0"),
                             ("einsum", "einsum", None)):
        losses[name], grads[name] = run_branch(impl, save, len(batches))
    # The gradients' reference: the einsum branch with the fused branch's
    # forward bits (``fused_value_plain_grad``), so that the gap measures
    # the backward alone, as GRAD_GAP_TOL assumes.
    real_attention = bert_model.dot_product_attention
    bert_model.dot_product_attention = (
        lambda *a, **kw: fused_value_plain_grad(fa, real_attention, *a, **kw))
    try:
        _, grads["einsum on the fused forward"] = run_branch("einsum", None,
                                                             1)
    finally:
        bert_model.dot_product_attention = real_attention
    # The check's power: the same first step with dK zeroed in #3's output.
    real_saved_bwd = fa.attn_bwd_packed_saved

    def dk_zeroed(*a, **kw):
        dqkv = real_saved_bwd(*a, **kw)
        d = dqkv.shape[-1] // 3
        dqkv[..., d:2 * d] = 0
        return dqkv

    fa.attn_bwd_packed_saved = dk_zeroed
    try:
        _, grads["planted fault: dK zeroed in #3"] = run_branch("fused",
                                                                 "1", 1)
    finally:
        fa.attn_bwd_packed_saved = real_saved_bwd

    ref = np.array(losses["einsum"])
    for name, ls in losses.items():
        print(f"dropout-0 losses, {name}: {ls}")
    for name in ("fused, saved probs", "fused, recompute"):
        diff = np.abs(np.array(losses[name]) - ref)
        print(f"  {name} vs einsum: max |Δloss| {diff.max():.3e} "
              f"(bound {LOSS_ATOL})")
        if not (diff <= LOSS_ATOL).all() or not np.isfinite(
                losses[name]).all():
            raise AssertionError(f"{name} losses differ from einsum's "
                                 f"beyond {LOSS_ATOL}")
    for name in ("fused, saved probs", "fused, recompute"):
        gaps = _grad_gaps(grads[name], grads["einsum"])
        print(f"  step-1 gradients, {name} vs einsum (forwards apart by "
              "bf16 roundings; a record): worst pieces "
              + ", ".join(f"{k} {v:.3e}" for k, v in gaps[:4]))
    for name in ("fused, saved probs", "fused, recompute",
                 "planted fault: dK zeroed in #3"):
        gaps = _grad_gaps(grads[name], grads["einsum on the fused forward"])
        print(f"  step-1 gradients, {name} vs einsum on the fused forward: "
              "worst pieces "
              + ", ".join(f"{k} {v:.3e}" for k, v in gaps[:4])
              + f" (bound {GRAD_GAP_TOL})")
        fails = gaps[0][1] > GRAD_GAP_TOL
        if fails != name.startswith("planted"):
            raise AssertionError(
                f"step-1 gradients, {name}: worst gap {gaps[0]} against "
                f"the bound {GRAD_GAP_TOL}")
    return counts, recompute_counts, weights


def train_speed(args, make_model, batch, card, label):
    """Training speed at B=256, S=50 (phases 5b and 6b): examples/s over 20
    steps after 3 warm-up steps on one resident batch, the per-step median
    and quartiles (CUDA events), the peak memory and one step's device time
    by kernel; then the same step with plain PyTorch attention, same
    weights, in alternating rounds. ``make_model(attention_impl)`` builds
    the model on the card with the run's weights."""
    import torch

    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
        make_train_step,
    )
    from bert_multimodal_transformer_tpu_torch.utils.profiling import (
        device_time_by_kernel,
    )

    warm, steps = 3, 20
    state = Trainer(model=make_model("fused"), tx=make_optimizer(
        1e-5, warm + steps + 1, 0.1)).create_state_from_params(None,
                                                               args.seed)
    step = make_train_step()
    for _ in range(warm):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(steps):
        losses.append(step(state, batch))
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_step = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(float(x)) for x in losses):
        raise AssertionError(f"non-finite loss in the {label} speed run")
    q1, med, q3 = np.percentile(per_step, [25, 50, 75])
    print(f"training on {card}: bf16 {label} MOSI dims, fused attention, "
          f"B={BENCH_BATCH} S={S_SERVE}, dropout 0.1/0.1/0.5: "
          f"{steps * BENCH_BATCH / wall:.1f} train examples/s over {steps} "
          f"steps after {warm} warm-up ({wall:.3f} s wall)")
    print(f"  per step (CUDA events): median {med:.3f} ms, quartiles "
          f"{q1:.3f}/{q3:.3f} ms, min {min(per_step):.3f}, max "
          f"{max(per_step):.3f} ms; peak memory "
          f"{peak / 2 ** 30:.3f} GiB (torch.cuda.max_memory_allocated)")
    _print_profile(device_time_by_kernel(lambda: step(state, batch), 1), 1,
                   "step")

    # The same step with plain PyTorch attention, same weights, in
    # alternating rounds: what the kernels change end to end.
    state_e = Trainer(model=make_model("einsum"), tx=make_optimizer(
        1e-5, 4 * steps, 0.1)).create_state_from_params(None, args.seed)
    for _ in range(warm):
        step(state_e, batch)
    rates = {"fused": [], "einsum": []}
    for name in ("fused", "einsum", "einsum", "fused"):
        st = state if name == "fused" else state_e
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps // 2):
            step(st, batch)
        torch.cuda.synchronize()
        rates[name].append(steps // 2 * BENCH_BATCH
                           / (time.perf_counter() - t0))
    print(f"  {label}: fused vs einsum attention, same weights, rounds of "
          f"{steps // 2} steps (fused, einsum, einsum, fused) on {card}: "
          f"fused {rates['fused']} examples/s, einsum {rates['einsum']} "
          "examples/s")


def sdpa_call(qkv, mask, h, scale):
    """The library call that computes #1 at rate 0:
    ``scaled_dot_product_attention`` on the [B, H, S, Dh] views of the
    packed projection with the additive (1 − mask)·−10000 bias. Returns
    (call, its output as [B, S, D]) for timing; never used by the port."""
    import torch
    import torch.nn.functional as F

    b, s, d3 = qkv.shape
    q, k, v = qkv.view(b, s, 3, h, d3 // 3 // h).permute(2, 0, 3, 1, 4)
    bias = ((1.0 - mask) * -10000.0).to(qkv.dtype)[:, None, None, :]

    def call():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                              scale=scale)

    return call, call().permute(0, 2, 1, 3).reshape(b, s, d3 // 3)


def mag_params(rng, d, dv, da):
    """torch-default (Kaiming-uniform) linears as the gate's init, and a
    LayerNorm scale and shift away from 1 and 0, on the card."""
    import torch

    def u(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    p = {"w_hv_v": u((dv, d), dv + d), "w_hv_t": u((d, d), dv + d),
         "b_hv": u((d,), dv + d), "w_ha_a": u((da, d), da + d),
         "w_ha_t": u((d, d), da + d), "b_ha": u((d,), da + d),
         "w_v": u((dv, d), dv), "b_v": u((d,), dv),
         "w_a": u((da, d), da), "b_a": u((d,), da),
         "ln_gamma": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
         "ln_beta": (0.1 * rng.standard_normal(d)).astype(np.float32)}
    return {k: torch.from_numpy(v).cuda() for k, v in p.items()}


def mag_case(rng, dtype_name, b, s, d, dv, da):
    import torch

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype_name]
    acts = [torch.from_numpy(rng.standard_normal((b * s, w),
                                                 dtype=np.float32)).to(
        "cuda", dtype) for w in (d, dv, da, d)]
    return mag_params(rng, d, dv, da), acts


def check_mag_case(mf, params, acts, dtype_name, beta, tag):
    """#25 and #26 against their plain versions on one case; returns the
    max abs errors (forward; chain outside the ReLU tie band) and the
    number of tie elements left out."""
    import torch

    from bert_multimodal_transformer_tpu_torch.ops.mag import mag_gate

    t, v, a, dy = acts
    y = mf.mag_fwd_cuda(params, t, v, a, beta_shift=beta)
    y_ref = mag_gate(params, t, v, a, beta_shift=beta)
    chain = mf.mag_bwd_cuda(params, t, v, a, dy, beta_shift=beta)
    chain_ref = mf.mag_bwd_chain_plain(params, t, v, a, dy,
                                       beta_shift=beta)
    torch.cuda.synchronize()
    err = (y.float() - y_ref.float()).abs()
    if dtype_name == "bf16":
        bound = MAG_ATOL + MAG_BF16_RTOL * y_ref.float().abs()
    else:
        bound = MAG_FP32_TOL + MAG_FP32_TOL * y_ref.abs()
    if bool((err > bound).any()) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"#25 {tag}: {int((err > bound).sum())} "
                             f"elements out of tolerance, max_abs_err="
                             f"{float(err.max())}")
    r = mf._recompute(mf._weights(params), t.float(), v.float(), a.float(),
                      beta)
    tie = (r["pv"].abs() < MAG_TIE) | (r["pa"].abs() < MAG_TIE)
    names = ("dpv", "dpa", "ddv", "dda", "dt", "xhat")
    bwd_err = 0.0
    for name, g, w in zip(names, chain, chain_ref):
        e = (g - w).abs()
        bad = (e > MAG_BWD_TOL + MAG_BWD_TOL * w.abs()) & ~tie
        if bool(bad.any()) or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"#26 {name} {tag}: {int(bad.sum())} "
                                 f"elements out of tolerance, max_abs_err="
                                 f"{float(e[~tie].max())}")
        bwd_err = max(bwd_err, float(e[~tie].max()))
    # the final gradients, built from each chain by the same products
    chain = tuple(torch.where(tie, w, g) for g, w in zip(chain, chain_ref))
    got = mf.grads_from_chain(params, t, v, a, dy, chain)
    want = mf.grads_from_chain(params, t, v, a, dy, chain_ref)
    pairs = [(k, got[0][k], want[0][k]) for k in mf.PARAM_NAMES]
    pairs += list(zip(("dtext", "dvisual", "dacoustic"), got[1:], want[1:]))
    grad_err = 0.0
    for name, g, w in pairs:
        # an input gradient in bf16 (bf16 activations) is rounded once
        rtol = MAG_BF16_RTOL if w.dtype == torch.bfloat16 else MAG_BWD_TOL
        e = (g.float() - w.float()).abs()
        if bool((e > MAG_BWD_TOL + rtol * w.float().abs()).any()):
            raise AssertionError(f"#26 final gradient {name} {tag}: "
                                 f"max_abs_err={float(e.max())}")
        grad_err = max(grad_err, float(e.max()))
    print(f"#25/#26 vs plain {tag}: forward max_abs_err="
          f"{float(err.max()):.3e}, chain max_abs_err={bwd_err:.3e} "
          f"({int(tie.sum())} ReLU-tie elements of {tie.numel()} left out), "
          f"final gradients max_abs_err={grad_err:.3e}")
    return float(err.max()), max(bwd_err, grad_err), int(tie.sum())


def check_mag_kernels(rng, mf):
    """Phase 3c, the agreement. Returns the max errors over the cases."""
    errs = {"fwd": 0.0, "bwd": 0.0, "ties": 0}
    cases = [(dt, BENCH_BATCH, S_SERVE, 768, 47, 74, beta)
             for dt in ("bf16", "fp32") for beta in (1e-3, 1.0, 1e6)]
    cases += [("bf16", 3, 33, 768, 47, 74, 1.0),
              ("bf16", 48, S_SERVE, 768, 35, 74, 1.0)]
    # bf16 #25's tensor-core plan at its edges (MAG_TC_EDGES)
    cases += [("bf16", b, s, d, dv, 74, beta)
              for b, s, d, dv in MAG_TC_EDGES for beta in (1e-3, 1.0, 1e6)]
    for dtype_name, b, s, d, dv, da, beta in cases:
        params, acts = mag_case(rng, dtype_name, b, s, d, dv, da)
        tag = (f"{dtype_name} B={b} S={s} N={b * s} D={d} Dv={dv} Da={da} "
               f"beta={beta:g}")
        fwd, bwd, ties = check_mag_case(mf, params, acts, dtype_name, beta,
                                        tag)
        errs["fwd"], errs["bwd"] = max(errs["fwd"], fwd), max(errs["bwd"],
                                                              bwd)
        errs["ties"] += ties
    return errs


def time_mag_kernels(rng, mf, card):
    """Phase 3c, the times: #25 and #26 against their plain versions in
    alternating rounds, bf16, at the driver's train and eval batches and
    the bench's (N = 2400, 6400, 12800); then the gate's whole backward a
    call (``mag_backward``: #26, then ``grads_from_chain``'s fp32 products
    and sums) against #26 alone, which only measures what the products
    add. Returns {N: {name: entry}}, the whole backward's ms under
    ``mag_bwd``'s ``whole_backward_ms``."""
    from bert_multimodal_transformer_tpu_torch.ops.mag import mag_gate

    out = {}
    for b in (TRAIN_BATCH, EVAL_BATCH, BENCH_BATCH):
        n = b * S_SERVE
        params, (t, v, a, dy) = mag_case(rng, "bf16", b, S_SERVE, 768, 47,
                                         74)
        pairs = {
            "mag_fwd": (
                lambda: mf.mag_fwd_cuda(params, t, v, a),
                lambda: mag_gate(params, t, v, a)),
            "mag_bwd": (
                lambda: mf.mag_bwd_cuda(params, t, v, a, dy),
                lambda: mf.mag_bwd_chain_plain(params, t, v, a, dy)),
        }
        out[n] = {}
        for name, (run_kernel, run_plain) in pairs.items():
            k, pl = _alternate(run_plain, run_kernel, 20)
            bound, by = mag_bound(name.split("_")[1], n, 768, 47, 74, 2)
            out[n][name] = {"ms": float(np.mean(k)),
                            "plain_ms": float(np.mean(pl)),
                            "bound_ms": bound, "bound_by": by}
            print(f"{name} bf16 N={n} D=768 Dv=47 Da=74 on {card}: kernel "
                  f"{k} ms, plain {pl} ms per call; bound {bound:.4f} ms "
                  f"({by})")
        alone, whole = _alternate(
            lambda: mf.mag_backward(params, t, v, a, dy),
            lambda: mf.mag_bwd_cuda(params, t, v, a, dy), 20)
        out[n]["mag_bwd"]["whole_backward_ms"] = float(np.mean(whole))
        print(f"the gate's whole backward bf16 N={n} on {card}: "
              f"{whole} ms per call (#26, then grads_from_chain's fp32 "
              f"products), #26 alone {alone} ms")
    return out


def run_driver(argv, fa, card):
    """``driver.main(argv)`` in this process: exit 0, one epoch line with
    finite losses. Returns the kernels' launch counts of the run."""
    import io

    import torch

    from bert_multimodal_transformer_tpu_torch import driver

    os.environ.setdefault("WANDB_MODE", "disabled")
    stdout = io.StringIO()
    _zero_counts(fa)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = driver.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(fa)
    text = stdout.getvalue()
    print(text.strip())
    print(f"driver.main({' '.join(argv)}) on {card}: exit {rc}, "
          f"{wall:.2f} s wall (model build, data, one epoch and its eval)")
    if rc != 0:
        raise AssertionError(f"driver.main exited {rc}")
    epochs = [line for line in text.splitlines() if line.startswith("epoch:")]
    if len(epochs) != 1:
        raise AssertionError(f"expected one epoch line, got {epochs}")
    fields = dict(kv.split(":", 1) for kv in epochs[0].split(", "))
    for key in ("train_loss", "valid_loss"):
        if not math.isfinite(float(fields[key])):
            raise AssertionError(f"non-finite {key} in {epochs[0]}")
    return counts


DRIVER_ARGV = ["--model", "bert-base-uncased", "--dataset", "mosi",
               "--synthetic", "--synthetic_sizes", *map(str, MOSI_SPLITS),
               "--n_epochs", "1", "--use_fused_mag", "--attention_impl",
               "fused", "--compute_dtype", "bfloat16"]


def driver_path(args, rng, fa, card):
    """Phase 6: the driver's training run, the launches it made, and the
    fused gate against the plain gate. Returns the launch counts."""
    from bert_multimodal_transformer_tpu_torch.config import BertConfig

    counts = run_driver(DRIVER_ARGV + ["--seed", str(args.seed)], fa,
                        card)
    layers = BertConfig.bert_base_uncased().num_hidden_layers
    n_train = -(-MOSI_SPLITS[0] // TRAIN_BATCH)
    n_eval = sum(-(-n // EVAL_BATCH) for n in MOSI_SPLITS[1:])
    want = _want(fa, attn_fwd_packed=layers * (n_train + n_eval),
                 attn_bwd_packed_saved=layers * n_train,
                 mag_fwd=n_train + n_eval, mag_bwd=n_train)
    print(f"kernel launches in driver.main: {counts} (want {want}: "
          f"{n_train} train + {n_eval} dev/test batches, {layers} layers)")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    gate_check(args, rng, fa, card)
    return counts


def gate_survey(args, card, n_seeds=GATE_SEEDS):
    """Phase 6, the gate over several inputs (ROADMAP C.2): for each of
    ``n_seeds`` seeds its own weights and batch, one dropout-0 step from
    one copy of the weights through the fused and the plain gate, in bf16
    and in fp32 (the attention kernels and the gate kernels in the same
    dtype). Per seed: the worst leaf gap fused vs plain in bf16 and in
    fp32, and each bf16 gate's worst gap to the fp32 plain gate's step;
    then, in fp32, the same step with dpv zeroed in #26's output. Returns
    {"bf16": [...], "fp32": [...], "bf16_vs_fp32": [(fused, plain)...],
    "planted_fp32": gap}."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
        MultimodalConfig,
    )
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )
    from bert_multimodal_transformer_tpu_torch.ops import mag_fused as mf
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
        make_train_step,
    )

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                              attention_impl="fused", hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    step = make_train_step()
    out = {"bf16": [], "fp32": [], "bf16_vs_fp32": [], "planted_fp32": None}

    def grads(model, weights, fused, batch):
        model.load_state_dict(weights)
        model.bert.MAG.use_fused_kernel = fused
        st = Trainer(model=model, tx=make_optimizer(1e-5, 100, 0.1)
                     ).create_state_from_params(None, args.seed)
        step(st, batch)
        return _grad_pieces(model)

    for i in range(n_seeds):
        srng = np.random.default_rng([args.seed, 62, i])
        split = make_split(srng, TRAIN_BATCH, S_SERVE, cfg.vocab_size,
                           ds.visual_dim, ds.acoustic_dim)
        batch = _device_batch(split.as_tuple())
        g = {}
        weights = None
        for dtype_name, dtype in (("fp32", torch.float32),
                                  ("bf16", torch.bfloat16)):
            m = MagBertForSequenceClassification(
                cfg, MultimodalConfig(dropout_prob=0.0), ds.visual_dim,
                ds.acoustic_dim, dtype, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(
                    args.seed + 3 + i))
            if weights is None:
                weights = {k: v.detach().clone()
                           for k, v in m.state_dict().items()}
            for fused in (True, False):
                g[dtype_name, fused] = grads(m, weights, fused, batch)
            if dtype_name == "fp32" and i == 0:
                real_chain = mf.mag_bwd_chain

                def dpv_zeroed(*a, **kw):
                    res = real_chain(*a, **kw)
                    res[0].zero_()
                    return res

                mf.mag_bwd_chain = dpv_zeroed
                try:
                    planted = grads(m, weights, True, batch)
                finally:
                    mf.mag_bwd_chain = real_chain
                out["planted_fp32"] = _grad_gaps(
                    planted, g["fp32", False])[0]
            del m
        for dtype_name in ("bf16", "fp32"):
            out[dtype_name].append(_grad_gaps(g[dtype_name, True],
                                              g[dtype_name, False])[0])
        out["bf16_vs_fp32"].append(tuple(
            _grad_gaps(g["bf16", fused], g["fp32", False])[0]
            for fused in (True, False)))
        print(f"  gate survey seed {i} on {card}: fused vs plain gate, "
              f"worst leaf bf16 {out['bf16'][-1][0]} "
              f"{out['bf16'][-1][1]:.3e}, fp32 {out['fp32'][-1][0]} "
              f"{out['fp32'][-1][1]:.3e}; against the fp32 plain step, "
              f"bf16 fused {out['bf16_vs_fp32'][-1][0][1]:.3e} "
              f"({out['bf16_vs_fp32'][-1][0][0]}), bf16 plain "
              f"{out['bf16_vs_fp32'][-1][1][1]:.3e} "
              f"({out['bf16_vs_fp32'][-1][1][0]})")
    print(f"  gate survey, fp32 planted fault (dpv zeroed in #26): worst "
          f"leaf {out['planted_fp32']}")
    torch.cuda.empty_cache()
    return out


def gate_check(args, rng, fa, card):
    """Phase 6, the gate: at dropout 0, one step with the fused gate
    against the plain gate over ``GATE_SEEDS`` seeded weights and batches
    (``gate_survey``), held in fp32 at ``GATE_FP32_TOL`` leaf by leaf, which
    the same step with dpv zeroed must break; in bf16 each fused-vs-plain
    gap held to the plain gate's own bf16 drift from the fp32 step. Then
    the gate alone and a whole step timed, fused and plain (bf16)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
        MultimodalConfig,
    )
    from bert_multimodal_transformer_tpu_torch.data.pipeline import (
        BatchIterator,
    )
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )
    from bert_multimodal_transformer_tpu_torch.ops import mag as mag_ops
    from bert_multimodal_transformer_tpu_torch.ops import mag_fused as mf
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
        make_train_step,
    )

    survey = gate_survey(args, card)
    worst_fp32 = max(survey["fp32"], key=lambda kv: kv[1])
    print(f"  gate check over {GATE_SEEDS} seeds: fp32 fused vs plain worst "
          f"leaf {worst_fp32} (bound {GATE_FP32_TOL}); planted fault "
          f"{survey['planted_fp32']}")
    if worst_fp32[1] > GATE_FP32_TOL:
        raise AssertionError(f"fp32 gate check: {worst_fp32} against "
                             f"{GATE_FP32_TOL}")
    if survey["planted_fp32"][1] <= GATE_FP32_TOL:
        raise AssertionError(f"the planted fault passed the fp32 gate "
                             f"check: {survey['planted_fp32']}")
    for i, (gap, (_, plain_drift)) in enumerate(zip(
            survey["bf16"], survey["bf16_vs_fp32"])):
        if gap[1] > plain_drift[1]:
            raise AssertionError(
                f"bf16 gate check, seed {i}: fused vs plain {gap} beyond the "
                f"plain gate's own bf16 drift {plain_drift}")

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                              attention_impl="fused", hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    split = make_split(rng, 6 * TRAIN_BATCH, S_SERVE, cfg.vocab_size,
                       ds.visual_dim, ds.acoustic_dim)
    batches = [_device_batch(bt) for bt, _ in BatchIterator(
        split, TRAIN_BATCH, shuffle=False, drop_remainder=True)]
    weights = None
    step = make_train_step()

    def make(fused):
        nonlocal weights
        m = MagBertForSequenceClassification(
            cfg, MultimodalConfig(dropout_prob=0.0, use_fused_kernel=fused),
            ds.visual_dim, ds.acoustic_dim, torch.bfloat16, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(
                args.seed + 3))
        if weights is None:
            weights = {k: v.detach().clone()
                       for k, v in m.state_dict().items()}
        m.load_state_dict(weights)
        st = Trainer(model=m, tx=make_optimizer(1e-5, 100, 0.1)
                     ).create_state_from_params(None, args.seed)
        return m, st

    # The gate's share of a training step's device time, fused and plain:
    # the device time of the gate's forward and backward alone at the
    # step's shapes, and of a whole step (torch.profiler, 3 calls each;
    # event timing at B=48 reads the host's dispatch pace, not the card).
    from bert_multimodal_transformer_tpu_torch.utils.profiling import (
        device_time_by_kernel,
    )

    gate = make(True)[0].bert.MAG
    params = {k: v.detach().clone().requires_grad_()
              for k, v in gate.params_dict().items()}
    text = torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, S_SERVE, 768), dtype=np.float32)).to("cuda",
                                                           torch.bfloat16)
    vis, ac = (x.to(torch.bfloat16) for x in batches[0][1:3])
    g = torch.randn_like(text)
    for name, fused, fn in (("fused", True, mf.mag_gate_fused),
                            ("plain", False, mag_ops.mag_gate)):
        def gate_step():
            x = text.detach().requires_grad_()
            fn(params, x, vis, ac, beta_shift=1.0).backward(g)

        _, st = make(fused)
        for _ in range(2):
            gate_step()
            step(st, batches[1])
        gate_prof = device_time_by_kernel(gate_step, 3)
        step_prof = device_time_by_kernel(lambda: step(st, batches[1]), 3)
        mag_ms = sum(ms for k, _, ms in step_prof["kernels"]
                     if any(n in k for n in MAG_KERNELS))
        print(f"  {name} gate, bf16 B={TRAIN_BATCH} S={S_SERVE} on {card}: "
              f"gate forward+backward alone {gate_prof['device_ms'] / 3:.3f}"
              f" ms of device time; dropout-0 train step "
              f"{step_prof['device_ms'] / 3:.3f} ms of device time "
              f"({step_prof['wall_ms'] / 3:.3f} ms wall under the "
              f"profiler); gate share "
              f"{gate_prof['device_ms'] / step_prof['device_ms']:.1%}"
              + (f"; #25 + #26 in the step {mag_ms / 3:.3f} ms"
                 if fused else ""))


# ---- MAG-XLNet: the rel-attention kernels #11-#13 and the XLNet paths ------


# bf16 #11's, #13's and #12's tensor-core plans (csrc/attn_rel_full_tc.cuh)
# at their edges: (B, Q, K, H, Dh, rates, a query row masked whole). The
# serving shape at rate 0; the memory's K = 100 (#11's score-tile plan, #13
# and #12 past K = 64) at the training batch, timed; Q = 33 with K = 141,
# odd (no pair loads), two d(pd) passes past K = 128; Dh = 128 in both
# probs plans; a row masked whole in each; #12's register plan's last K
# (64) and the score tile's first (65); Q = K = 141, the reach (8 warps).
REL_TC_EDGES = ((BATCH, S_SERVE, S_SERVE, 12, 64, (0.0,), True),
                (BENCH_BATCH, S_SERVE, 2 * S_SERVE, 12, 64, (RATE, 0.0),
                 True),
                (8, 33, 141, 12, 64, (RATE, 0.0), False),
                (16, S_SERVE, S_SERVE, 6, 128, (RATE, 0.0), True),
                (8, S_SERVE, 2 * S_SERVE, 6, 128, (RATE, 0.0), False),
                (8, 64, 64, 12, 64, (RATE, 0.0), False),
                (8, S_SERVE, 65, 12, 64, (RATE,), True),
                (4, 141, 141, 4, 64, (RATE, 0.0), True))


def rel_bound(kind, b, q_len, k_len, h, dh, itemsize, rate=0.0, save=False):
    """The bound of rel kernel ``kind`` at [B, Q, K, H, Dh]: each input read
    once and each output written once (q, g, dq [B,Q,D]; k, v, dk, dv
    [B,K,D]; ebias, debias, p, pd [B,H,Q,K]); the products on the bf16
    tensor cores, 2·B·H·Q·K·Dh operations each (QKᵀ and PV forward; dV,
    d(pd), dQ and dK backward, plus QKᵀ again for the recompute)."""
    d = h * dh
    qd, kd = b * q_len * d * itemsize, b * k_len * d * itemsize
    hqk = b * h * q_len * k_len * itemsize
    probs = hqk * (2 if rate > 0 else 1)
    dot = 2 * b * h * q_len * k_len * dh
    if kind == "fwd":
        n_bytes, n_ops = qd + 2 * kd + hqk + qd + (probs if save else 0), \
            2 * dot
    elif kind == "bwd_saved":   # reads p, pd (the same tensor at rate 0)
        n_bytes, n_ops = probs + 2 * qd + 2 * kd + qd + 2 * kd + hqk, 4 * dot
    else:
        n_bytes, n_ops = 2 * qd + 2 * kd + hqk + qd + 2 * kd + hqk, 5 * dot
    return _bound(n_bytes, n_ops, BF16_FLOPS)


def xlnet_segments(rng, b, s):
    """Left-padded XLNet rows: (lengths, [B, S] mask, [B, S] segment ids
    with 0 on tokens, 2 on the last (<cls>) and 3 on pads); one row full,
    one with a single token."""
    lengths = rng.integers(3, s + 1, size=b)
    lengths[0], lengths[-1] = s, 2
    real = np.arange(s)[None, :] >= (s - lengths)[:, None]
    segs = np.where(real, 0, 3).astype(np.int32)
    segs[:, -1] = 2
    return real.astype(np.int32), segs


def rel_case(rng, dtype_name, b, q_len, k_len, h=12, dh=64):
    """One seeded rel-kernel case with the ebias the model assembles:
    rel_shift of a bd product against P = Q + K position keys, plus the
    segment ef select, plus −1e30 on the masked keys of left-padded rows
    (each query still sees its own position, the last Q keys); all at the
    input dtype, as models/xlnet.py."""
    import torch

    from bert_multimodal_transformer_tpu_torch.models.xlnet import rel_shift

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype_name]
    d = h * dh

    def t(*shape, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                * scale).to("cuda", dtype)

    q, k, v, g = t(b, q_len, d), t(b, k_len, d), t(b, k_len, d), t(b, q_len, d)
    rr, kr = t(b, q_len, h, dh, scale=0.125), t(q_len + k_len, h, dh)
    bd = torch.einsum("bqhf,phf->bhqp", rr.float(), kr.float()).to(dtype)
    mask, segs = (torch.from_numpy(x).cuda()
                  for x in xlnet_segments(rng, b, k_len))
    ef_raw = t(b, h, q_len, 2)
    seg_diff = (segs[:, None, -q_len:, None] != segs[:, None, None, :])
    ef = torch.where(seg_diff, ef_raw[..., 1:2], ef_raw[..., 0:1]).to(dtype)
    own = torch.zeros(q_len, k_len, dtype=torch.bool, device="cuda")
    own[:, k_len - q_len:] = torch.eye(q_len, dtype=torch.bool,
                                       device="cuda")
    masked = (mask[:, None, None, :] == 0) & ~own
    ebias = (rel_shift(bd, k_len) + ef) + (-(1e30 * masked.float())).to(dtype)
    return q, k, v, ebias.contiguous(), g


def _rel_grad_errs(tag, dtype_name, pairs, bound_args, fa):
    """Max abs err of (dq, dk, dv, debias) pairs; raises past the bound."""
    import torch

    p, pd, q, k, v, g, kw = bound_args
    errs = {}
    for name, got, want in pairs:
        if dtype_name == "bf16":
            bounds = fa.rel_grads_bf16_bound(want, p, pd, q, k, v, g, **kw)
        else:
            bounds = [GRAD_FP32_TOL + GRAD_FP32_TOL * w.float().abs()
                      for w in want]
        worst = 0.0
        for part, a, w, bd in zip(("dq", "dk", "dv", "debias"), got, want,
                                  bounds):
            err = (a.float() - w.float()).abs()
            if bool((err > bd).any()) or not bool(torch.isfinite(a).all()):
                raise AssertionError(
                    f"{name} {part} {tag}: {int((err > bd).sum())} elements "
                    f"out of tolerance, max_abs_err={float(err.max())}")
            worst = max(worst, float(err.max()))
        errs[name] = worst
    return errs


def check_rel_kernels(rng, fa, dtype_name, b, q_len, k_len, rate, h=12,
                      dh=64, masked=False):
    """Phase 3d on one case: #11 with save (and dropout at rate > 0), #13
    and #12, each against its plain version, the backward also against
    torch.autograd through the plain forward (debias included); #12
    against #13; the same bits from the same seed twice; #11 without the
    save gives the saved run's output. ``masked``: query row 1 of batch
    row 0, head 0 masked whole (−1e30 on every key), which must come out
    uniform."""
    import torch

    q, k, v, ebias, g = rel_case(rng, dtype_name, b, q_len, k_len, h, dh)
    if masked:
        ebias[0, 0, 1, :] = -1e30
    seed = int(rng.integers(0, 2 ** 63 - 1))
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5)
    tag = (f"{dtype_name} B={b} Q={q_len} K={k_len} H={h} Dh={dh} "
           f"rate={rate}" + (" one row masked whole" if masked else ""))
    out, p, pd = fa.attn_fwd_rel_cuda(q, k, v, ebias, rate=rate, seed=seed,
                                      save=True, **kw)
    r = fa.attn_fwd_rel_reference(q, k, v, ebias, rate=rate, seed=seed,
                                  save=True, **kw)
    errs = {"fwd": max(_forward_err(f"#11 {n} {tag}", x, w, dtype_name)
                       for n, x, w in zip(("out", "p", "pd"), (out, p, pd),
                                          r))}
    if masked and not torch.equal(p[0, 0, 1], torch.full_like(
            p[0, 0, 1], 1.0 / k_len)):
        raise AssertionError(f"#11: a row masked whole is not uniform "
                             f"({tag})")
    print(f"#11 vs plain {tag}: out/p/pd max_abs_err={errs['fwd']:.3e}"
          + _check_keep(fa, "#11", seed, p, pd, rate, tag))

    saved = fa.attn_bwd_rel_saved_cuda(p, pd, q, k, v, g, **kw)
    recomputed = fa.attn_bwd_rel_cuda(q, k, v, ebias, seed, g, rate=rate,
                                      **kw)
    r_saved = fa.attn_bwd_rel_saved_reference(p, pd, q, k, v, g, **kw)
    r_recomputed = fa.attn_bwd_rel_reference(q, k, v, ebias, seed, g,
                                             rate=rate, **kw)
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v, ebias)]
    fa.attn_fwd_rel_reference(*xs, rate=rate, seed=seed, **kw).backward(g)
    autograd = [x.grad for x in xs]
    errs.update(_rel_grad_errs(tag, dtype_name, (
        ("#13 vs plain", saved, r_saved),
        ("#13 vs autograd", saved, autograd),
        ("#12 vs plain", recomputed, r_recomputed),
        ("#12 vs autograd", recomputed, autograd),
        ("#12 vs #13", recomputed, saved)), (p, pd, q, k, v, g, kw), fa))
    print(f"rel backward {tag} (dq, dk, dv, debias): " + ", ".join(
        f"{k_} {v_:.3e}" for k_, v_ in errs.items() if k_ != "fwd"))
    again = (fa.attn_fwd_rel_cuda(q, k, v, ebias, rate=rate, seed=seed,
                                  save=True, **kw),
             fa.attn_bwd_rel_saved_cuda(p, pd, q, k, v, g, **kw),
             fa.attn_bwd_rel_cuda(q, k, v, ebias, seed, g, rate=rate, **kw))
    same = all(torch.equal(a, b_) for a, b_ in zip(
        (*again[0], *again[1], *again[2]), (out, p, pd, *saved,
                                            *recomputed)))
    same = same and torch.equal(fa.attn_fwd_rel_cuda(
        q, k, v, ebias, rate=rate, seed=seed, **kw), out)
    print(f"same seed twice {tag}: identical bits {same} (#11 also without "
          "the save)")
    if not same:
        raise AssertionError(f"the rel kernels are not bit-reproducible "
                             f"({tag})")
    return errs, (q, k, v, ebias, g, seed, kw)


def time_rel_kernels(fa, case, mem_case, card):
    """#11 (rate 0.1, save), #13 and #12 against their plain versions at
    bf16 B=256 Q=K=50, in alternating rounds, and #12 at rate 0 beside
    SDPA's autograd backward (dq, dk, dv, debias; the ebias as its float
    mask); then #11 at the serving shape
    (rate 0, B=128) beside scaled_dot_product_attention(q, k, v,
    attn_mask=ebias, scale=scale), the library call computing the same
    function (timed here, used nowhere in the port); then #11′ and #13 at
    the memory's shape (``mem_case``: bf16 B=256 Q=50 K=100, the
    ``--mem_len 50`` path, #11's score-tile plan); last the card's time per
    launch of each (torch.profiler, free of host pacing)."""
    import torch.nn.functional as F

    q, k, v, ebias, g, seed, kw = case
    _, p, pd = fa.attn_fwd_rel_cuda(q, k, v, ebias, rate=RATE, seed=seed,
                                    save=True, **kw)
    pairs = {
        "attn_fwd_rel": (
            lambda: fa.attn_fwd_rel_cuda(q, k, v, ebias, rate=RATE,
                                         seed=seed, save=True, **kw),
            lambda: fa.attn_fwd_rel_reference(q, k, v, ebias, rate=RATE,
                                              seed=seed, save=True, **kw)),
        "attn_bwd_rel_saved": (
            lambda: fa.attn_bwd_rel_saved_cuda(p, pd, q, k, v, g, **kw),
            lambda: fa.attn_bwd_rel_saved_reference(p, pd, q, k, v, g,
                                                    **kw)),
        "attn_bwd_rel": (
            lambda: fa.attn_bwd_rel_cuda(q, k, v, ebias, seed, g, rate=RATE,
                                         **kw),
            lambda: fa.attn_bwd_rel_reference(q, k, v, ebias, seed, g,
                                              rate=RATE, **kw)),
    }
    times = {}
    for name, (run_kernel, run_plain) in pairs.items():
        kt, pt = _alternate(run_plain, run_kernel, 20)
        times[name] = (float(np.mean(kt)), float(np.mean(pt)))
        print(f"{name} bf16 B={BENCH_BATCH} Q=K={S_SERVE} H=12 Dh=64 "
              f"rate={RATE} on {card}: kernel {kt} ms, plain {pt} ms per call")
    # #12 at rate 0 beside SDPA's autograd backward to q, k, v and the ebias
    kt, pt = _alternate(
        lambda: fa.attn_bwd_rel_reference(q, k, v, ebias, 0, g, **kw),
        lambda: fa.attn_bwd_rel_cuda(q, k, v, ebias, 0, g, **kw), 20)
    lib = sdpa_rel_calls(q, k, v, ebias, g, 12, kw["scale"])[1]
    _time_ms(lib, 3)
    lib_ms = float(np.mean([_time_ms(lib, 20) for _ in range(2)]))
    bound = rel_bound("bwd", BENCH_BATCH, S_SERVE, S_SERVE, 12, 64, 2)
    times["attn_bwd_rel rate 0"] = {
        "ms": float(np.mean(kt)), "plain_ms": float(np.mean(pt)),
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms,
        "library": "scaled_dot_product_attention autograd backward (dq, dk, "
                   "dv, debias), the ebias as float mask, rate 0"}
    print(f"attn_bwd_rel bf16 B={BENCH_BATCH} Q=K={S_SERVE} H=12 Dh=64 rate 0 "
          f"on {card}: kernel {kt} ms, plain {pt} ms per call, library "
          f"{lib_ms:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]})")
    del lib

    # the serving shape: a fresh B=128 case at rate 0
    sq, sk, sv, seb = (x[:BATCH].contiguous() for x in (q, k, v, ebias))
    heads = [x.view(BATCH, -1, 12, 64).transpose(1, 2) for x in (sq, sk, sv)]

    def sdpa():
        return F.scaled_dot_product_attention(*heads, attn_mask=seb,
                                              scale=kw["scale"])

    kt, pt = _alternate(
        lambda: fa.attn_fwd_rel_reference(sq, sk, sv, seb, **kw),
        lambda: fa.attn_fwd_rel_cuda(sq, sk, sv, seb, **kw), 50)
    _time_ms(sdpa, 10)
    lib = [_time_ms(sdpa, 50) for _ in range(2)]
    lib_err = float((sdpa().transpose(1, 2).reshape(BATCH, S_SERVE, 768)
                     .float() - fa.attn_fwd_rel_cuda(sq, sk, sv, seb, **kw)
                     .float()).abs().max())
    bound = rel_bound("fwd", BATCH, S_SERVE, S_SERVE, 12, 64, 2)
    times["serving"] = {"ms": float(np.mean(kt)), "plain_ms": float(
        np.mean(pt)), "library_ms": float(np.mean(lib)),
        "bound_ms": bound[0], "bound_by": bound[1],
        "library": "scaled_dot_product_attention"}
    print(f"attn_fwd_rel bf16 B={BATCH} Q=K={S_SERVE} rate 0 on {card}: "
          f"kernel {kt} ms, plain {pt} ms, scaled_dot_product_attention "
          f"{lib} ms per call (max |Δ| to the kernel {lib_err:.3e}); bound "
          f"{bound[0]:.4f} ms ({bound[1]})")

    mq, mk, mv, meb, mg, m_seed, m_kw = mem_case
    b, q_len, k_len = mq.shape[0], mq.shape[1], mk.shape[1]
    _, mp, mpd = fa.attn_fwd_rel_cuda(mq, mk, mv, meb, rate=RATE,
                                      seed=m_seed, save=True, **m_kw)
    mem = {
        "attn_fwd_rel": (
            lambda: fa.attn_fwd_rel_cuda(mq, mk, mv, meb, rate=RATE,
                                         seed=m_seed, save=True, **m_kw),
            lambda: fa.attn_fwd_rel_reference(mq, mk, mv, meb, rate=RATE,
                                              seed=m_seed, save=True,
                                              **m_kw),
            rel_bound("fwd", b, q_len, k_len, 12, 64, 2, RATE, save=True)),
        "attn_bwd_rel_saved": (
            lambda: fa.attn_bwd_rel_saved_cuda(mp, mpd, mq, mk, mv, mg,
                                               **m_kw),
            lambda: fa.attn_bwd_rel_saved_reference(mp, mpd, mq, mk, mv, mg,
                                                    **m_kw),
            rel_bound("bwd_saved", b, q_len, k_len, 12, 64, 2, RATE)),
    }
    times["mem"] = {}
    for name, (run_kernel, run_plain, mem_bound) in mem.items():
        kt, pt = _alternate(run_plain, run_kernel, 20)
        times["mem"][name] = {
            "ms": float(np.mean(kt)), "plain_ms": float(np.mean(pt)),
            "bound_ms": mem_bound[0], "bound_by": mem_bound[1],
            "library_ms": None}
        print(f"{name} bf16 B={b} Q={q_len} K={k_len} H=12 Dh=64 "
              f"rate={RATE} on {card}: kernel {kt} ms, plain {pt} ms per "
              f"call; bound {mem_bound[0]:.4f} ms ({mem_bound[1]})")

    device = {
        f"#11 serving bf16 B={BATCH} Q=K={S_SERVE} rate 0": kernel_device_ms(
            lambda: fa.attn_fwd_rel_cuda(sq, sk, sv, seb, **kw),
            "attn_fwd_rel"),
        f"#11' bf16 B={BENCH_BATCH} Q=K={S_SERVE} rate {RATE} saved probs":
            kernel_device_ms(pairs["attn_fwd_rel"][0], "attn_fwd_rel"),
        f"#13 bf16 B={BENCH_BATCH} Q=K={S_SERVE}": kernel_device_ms(
            pairs["attn_bwd_rel_saved"][0], "attn_bwd_rel_saved"),
        f"#11' bf16 B={b} Q={q_len} K={k_len} rate {RATE} saved probs":
            kernel_device_ms(mem["attn_fwd_rel"][0], "attn_fwd_rel"),
        f"#13 bf16 B={b} Q={q_len} K={k_len}": kernel_device_ms(
            mem["attn_bwd_rel_saved"][0], "attn_bwd_rel_saved")}
    times["device_ms"] = device
    print(f"the card's time per launch of #11/#13 (torch.profiler) on "
          f"{card}: " + ", ".join(f"{k_} {v_:.4f} ms"
                                  for k_, v_ in device.items()))
    return times


def make_xlnet_split(rng, n, s, vocab, dv, da):
    """A seeded PackedSplit shaped like the XLNet packing: tokens <sep>
    <cls> at the end, left padding (pad id 5), segments 0/2/3, zero
    modality rows on specials and padding."""
    from bert_multimodal_transformer_tpu_torch.data.pipeline import (
        PackedSplit,
    )

    mask, segs = xlnet_segments(rng, n, s)
    ids = np.where(mask == 1, rng.integers(10, vocab, size=(n, s)),
                   5).astype(np.int32)
    ids[:, -2], ids[:, -1] = 4, 3
    inner = (mask == 1) & (np.arange(s) < s - 2)[None, :]
    vis = rng.standard_normal((n, s, dv), dtype=np.float32) * inner[..., None]
    ac = rng.standard_normal((n, s, da), dtype=np.float32) * inner[..., None]
    labels = rng.uniform(-3.0, 3.0, size=n).astype(np.float32)
    return PackedSplit(ids, vis.astype(np.float32), ac.astype(np.float32),
                       mask, segs, labels)


def _xlnet(cfg, mm, impl, device_seed, weights=None):
    """A MagXLNetForSequenceClassification at MOSI dims and bf16 on the
    card, with random weights from a seeded generator (or ``weights``)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import DatasetConfig
    from bert_multimodal_transformer_tpu_torch.models.xlnet import (
        MagXLNetForSequenceClassification,
    )

    ds = DatasetConfig.mosi()
    model = MagXLNetForSequenceClassification(
        dataclasses.replace(cfg, attention_impl=impl), mm, ds.visual_dim,
        ds.acoustic_dim, torch.bfloat16, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(device_seed))
    if weights is not None:
        model.load_state_dict(weights)
    return model


def serving_path(fa, card, label, predictor, make_einsum, split, requests,
                 kernel, layers):
    """Phases 4 and 4c: ``Predictor.score_split`` over the split at batch
    128, then ``predict_requests`` over the requests. Checks: ``kernel``
    ran once per layer per batch and nothing else launched, every
    prediction is finite, and the predictions agree with the same weights
    on ``attention_impl="einsum"`` (``make_einsum()``). Returns the launch
    counts."""
    import torch

    from bert_multimodal_transformer_tpu_torch.data.pipeline import (
        BatchIterator,
    )
    from bert_multimodal_transformer_tpu_torch.serving import Predictor

    predictor.predict_split(split.take(np.arange(BATCH)))  # warm-up
    torch.cuda.synchronize()
    _zero_counts(fa)
    t0 = time.perf_counter()
    scores = predictor.score_split(split)
    t1 = time.perf_counter()
    served = list(predictor.predict_requests(requests))
    t2 = time.perf_counter()
    counts = _counts(fa)
    n_batches = len(BatchIterator(split, BATCH, shuffle=False,
                                  drop_remainder=False)) + N_REQUESTS
    want = _want(fa, **{kernel: layers * n_batches})
    print(f"kernel launches in {label} serving: {counts} (want {want}: "
          f"{layers} layers x {n_batches} batches)")
    if counts != want:
        raise AssertionError(f"{label} serving launches {counts} != {want}")
    preds = predictor.predict_split(split)
    if preds.shape != (N_TEST,) or not np.isfinite(preds).all():
        raise AssertionError(f"bad {label} predictions: shape {preds.shape}"
                             f", finite={np.isfinite(preds).all()}")
    for out in served:
        if out.shape != (REQUEST_SIZE,) or not np.isfinite(out).all():
            raise AssertionError(f"bad request predictions {out.shape}")
    if set(scores) != {"acc", "mae", "corr", "f_score"}:
        raise AssertionError(f"bad scores {scores}")
    print(f"{label} scores (random weights): {scores}")
    preds_e = Predictor(make_einsum(), batch_size=BATCH).predict_split(split)
    pred_err = float(np.abs(preds - preds_e).max())
    print(f"{label} fused vs einsum predictions: max_abs_diff={pred_err:.3e} "
          f"(tolerance {PRED_ATOL}), |pred| max {np.abs(preds_e).max():.3f}")
    if not pred_err <= PRED_ATOL:
        raise AssertionError(f"{label} fused and einsum predictions differ "
                             f"by {pred_err} > {PRED_ATOL}")
    # One pass over the split lasts ~0.1 s, so host noise moves it; five
    # more passes give a median and a spread.
    reps = []
    for _ in range(5):
        t3 = time.perf_counter()
        predictor.predict_split(split)
        reps.append(N_TEST / (time.perf_counter() - t3))
    print(f"{label} serving on {card}: score_split {N_TEST / (t1 - t0):.1f} "
          f"examples/s ({N_TEST} examples, batch {BATCH}, S={S_SERVE}, "
          f"bf16), predict_requests "
          f"{N_REQUESTS * REQUEST_SIZE / (t2 - t1):.1f} examples/s "
          f"({N_REQUESTS} x {REQUEST_SIZE}); predict_split over 5 more "
          f"passes: median {np.median(reps):.1f}, min {min(reps):.1f}, max "
          f"{max(reps):.1f} examples/s")
    return counts


def xlnet_serving(args, rng, fa, card):
    """Phase 4c: ``serving_path`` over MagXLNetForSequenceClassification at
    xlnet-base-cased width on XLNet-packed splits, then one batch's
    profile. Returns the launch counts."""
    from bert_multimodal_transformer_tpu_torch.config import (
        DatasetConfig,
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.serving import Predictor

    ds = DatasetConfig.mosi()
    cfg = XLNetConfig.xlnet_base_cased()
    mm = MultimodalConfig(injection_index=1)
    model = _xlnet(cfg, mm, "fused", args.seed + 10)
    split = make_xlnet_split(rng, N_TEST, S_SERVE, cfg.vocab_size,
                             ds.visual_dim, ds.acoustic_dim)
    requests = [make_xlnet_split(rng, REQUEST_SIZE, S_SERVE, cfg.vocab_size,
                                 ds.visual_dim, ds.acoustic_dim).as_tuple()[:5]
                for _ in range(N_REQUESTS)]
    predictor = Predictor(model, batch_size=BATCH)
    counts = serving_path(
        fa, card, "xlnet-base-cased", predictor,
        lambda: _xlnet(cfg, mm, "einsum", 0, model.state_dict()), split,
        requests, "attn_fwd_rel", cfg.n_layer)
    profile_batch(predictor, split, card)
    return counts


XLNET_DRIVER_ARGV = ["--model", "xlnet-base-cased", "--dataset", "mosi",
                     "--synthetic", "--synthetic_sizes",
                     *map(str, MOSI_SPLITS), "--n_epochs", "1",
                     "--attention_impl", "fused", "--compute_dtype",
                     "bfloat16"]


def xlnet_driver_path(args, rng, fa, card):
    """Phase 6b: the XLNet driver's training run and its launches, one step
    through #12, the fused-vs-einsum gradients with two planted faults, and
    the training speed. Returns (driver counts, recompute counts)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        DatasetConfig,
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.data.pipeline import (
        BatchIterator,
    )
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
        make_train_step,
    )

    os.environ.pop("FUSED_ATTN_SAVE", None)
    counts = run_driver(XLNET_DRIVER_ARGV + ["--seed", str(args.seed)], fa,
                        card)
    cfg = XLNetConfig.xlnet_base_cased()
    layers = cfg.n_layer
    n_train = -(-MOSI_SPLITS[0] // TRAIN_BATCH)
    n_eval = sum(-(-n // EVAL_BATCH) for n in MOSI_SPLITS[1:])
    want = _want(fa, attn_fwd_rel=layers * (n_train + n_eval),
                 attn_bwd_rel_saved=layers * n_train)
    print(f"kernel launches in the XLNet driver.main: {counts} (want {want}: "
          f"{n_train} train + {n_eval} dev/test batches, {layers} layers)")
    if counts != want:
        raise AssertionError(f"XLNet driver launches {counts} != {want}")

    # One step through the recompute backward (#12).
    ds = DatasetConfig.mosi()
    mm = MultimodalConfig(injection_index=1)
    split = make_xlnet_split(rng, 6 * TRAIN_BATCH, S_SERVE, cfg.vocab_size,
                             ds.visual_dim, ds.acoustic_dim)
    batches = [_device_batch(bt) for bt, _ in BatchIterator(
        split, TRAIN_BATCH, shuffle=False, drop_remainder=True)]
    step = make_train_step()
    model = _xlnet(cfg, mm, "fused", args.seed + 11)
    state = Trainer(model=model, tx=make_optimizer(1e-5, 10, 0.1)
                    ).create_state_from_params(None, args.seed)
    os.environ["FUSED_ATTN_SAVE"] = "0"
    _zero_counts(fa)
    loss = float(step(state, batches[0]))
    recompute_counts = _counts(fa)
    os.environ.pop("FUSED_ATTN_SAVE")
    want = _want(fa, attn_fwd_rel=layers, attn_bwd_rel=layers)
    print(f"one XLNet train step under FUSED_ATTN_SAVE=0: loss {loss:.6f}, "
          f"launches {recompute_counts} (want {want})")
    if recompute_counts != want or not math.isfinite(loss):
        raise AssertionError(f"XLNet recompute step: {recompute_counts}, "
                             f"{loss}")
    # One B=256 step's device time with the probs recomputed (#12) and
    # saved (#13), from a stream of its own.
    from bert_multimodal_transformer_tpu_torch.utils.profiling import (
        device_time_by_kernel,
    )

    big = _device_batch(make_xlnet_split(
        np.random.default_rng([args.seed, 21]), BENCH_BATCH, S_SERVE,
        cfg.vocab_size, ds.visual_dim, ds.acoustic_dim).as_tuple())
    for save in (False, True):
        if not save:
            os.environ["FUSED_ATTN_SAVE"] = "0"
        try:
            step(state, big)
            torch.cuda.synchronize()
            print(f"one XLNet training step, bf16 xlnet-base-cased "
                  f"B={BENCH_BATCH} S={S_SERVE}, the probs "
                  + ("saved (#13)" if save else
                     "recomputed (#12, FUSED_ATTN_SAVE=0)") + f" on {card}:")
            _print_profile(device_time_by_kernel(lambda: step(state, big), 1),
                           1, "step")
        finally:
            os.environ.pop("FUSED_ATTN_SAVE", None)

    # At dropout 0, from one copy of the weights: one step fused against
    # einsum, leaf by leaf; then the same step with debias, then dK, zeroed
    # in #13's output.
    weights = {k_: v_.detach().clone()
               for k_, v_ in model.state_dict().items()}
    del state, model
    cfg0 = dataclasses.replace(cfg, dropout=0.0, summary_last_dropout=0.0)
    mm0 = dataclasses.replace(mm, dropout_prob=0.0)

    def one_step(impl):
        m = _xlnet(cfg0, mm0, impl, 0, weights)
        st = Trainer(model=m, tx=make_optimizer(1e-5, 10, 0.1)
                     ).create_state_from_params(None, args.seed)
        step(st, batches[1])
        return _grad_pieces(m)

    grads = {"fused": one_step("fused"), "einsum": one_step("einsum")}
    real = fa.attn_bwd_rel_saved
    for name, part in (("planted fault: debias zeroed in #13", 3),
                       ("planted fault: dK zeroed in #13", 1)):
        def faulty(*a, _part=part, **kw):
            out = list(real(*a, **kw))
            out[_part] = torch.zeros_like(out[_part])
            return tuple(out)

        fa.attn_bwd_rel_saved = faulty
        try:
            grads[name] = one_step("fused")
        finally:
            fa.attn_bwd_rel_saved = real
    bias_leaves = ("rel_attn.r_r_bias", "rel_attn.r", "rel_attn.seg_embed",
                   "rel_attn.r_s_bias")
    for name in ("fused", "planted fault: debias zeroed in #13",
                 "planted fault: dK zeroed in #13"):
        gaps = _grad_gaps(grads[name], grads["einsum"])
        by = dict(gaps)
        ebias_side = max(v_ for k_, v_ in by.items()
                         if k_.endswith(bias_leaves))
        print(f"  XLNet step-1 gradients, {name} vs einsum: worst pieces "
              + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in gaps[:4])
              + f"; r_r_bias/r/seg_embed/r_s_bias leaves worst "
              f"{ebias_side:.3e} (bound {XLNET_GRAD_GAP_TOL})")
        fails = gaps[0][1] > XLNET_GRAD_GAP_TOL
        if fails != name.startswith("planted"):
            raise AssertionError(f"XLNet step-1 gradients, {name}: worst "
                                 f"gap {gaps[0]} against {XLNET_GRAD_GAP_TOL}")
    batch = _device_batch(make_xlnet_split(
        rng, BENCH_BATCH, S_SERVE, cfg.vocab_size, ds.visual_dim,
        ds.acoustic_dim).as_tuple())
    train_speed(args, lambda impl: _xlnet(cfg, mm, impl, 0, weights), batch,
                card, "xlnet-base-cased")
    return counts, recompute_counts


# ---- Long-sequence MAG-BERT: the head-blocked (#4, #5) and flash-streamed
# (#6, #7) packed tiers ---------------------------------------------------

LONG_S = (512, 640, 1024)      # the driver's long runs and the hb reach
# The edges of #6's and #23's bf16 tensor-core plan: (B, S, H, Dh) with a
# ragged q tile and key block off 16, a zero-padded k-depth, the widest
# head; #23 also (B, Q, K, H, Dh) with Q ≠ K, as under the memory.
FS_EDGES = ((2, 200, 4, 64), (2, 256, 3, 40), (2, 130, 2, 128))
# The edges of #4's and #7's bf16 tensor-core plans beyond those: a
# zero-padded k-depth ragged off 16, #4's reach at the widest head, #7's
# ragged last key tile (every case's mask has a fully padded row).
HB_EDGES = ((2, 333, 3, 40), (2, 640, 2, 128), (2, 700, 2, 64))
# #5's beyond those: S = 141, the first S that takes it with a gradient
# (its fully padded batch row included, as every case's).
HB_BWD_EDGES = ((2, 141, 12, 64),)
# #23's and #24's (and #14's where K ≤ 640) beyond those: S ragged off 16
# and off 64, Q ≠ K at the widest head.
RELIK_FS_EDGES = ((2, 200, 200, 4, 64), (2, 128, 128, 3, 40),
                  (2, 130, 130, 2, 128), (2, 96, 200, 4, 64),
                  (2, 333, 333, 3, 40), (2, 700, 700, 2, 64),
                  (2, 130, 260, 2, 128))
LONG_SPLITS = (96, 48, 48)     # one short epoch: 2 train + 2 eval batches
LONG_SERVE_N = 256             # 2 batches of 128 per serving length


def long_case(rng, dtype_name, b, s, h=12, dh=64):
    """One seeded packed case with a ragged mask (one fully padded row,
    one full row), a context gradient and a 63-bit seed."""
    import torch

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype_name]
    d = h * dh
    qkv = torch.from_numpy(rng.standard_normal(
        (b, s, 3 * d), dtype=np.float32)).to("cuda", dtype)
    g = torch.from_numpy(rng.standard_normal(
        (b, s, d), dtype=np.float32)).to("cuda", dtype)
    mask = torch.from_numpy(_ragged_mask(rng, b, s)).cuda().float()
    return qkv, mask, g, int(rng.integers(0, 2 ** 63 - 1))


def _tier_err(name, got, want, pd, qkv, h, dtype_name):
    """#6 against a whole-row tier (#1 or #4, or their plain version) on
    the same inputs and seed. fp32: FP32_ATOL. bf16: the whole-row tiers
    round p = e/l to bf16 before PV, #6 rounds e and divides by l after;
    each rounding moves an element by ≤ 2^-8 relative, so the two lie
    within 2^-7·(pd·|V|) of each other, plus one output rounding each:
    2^-7·(|want| + pd·|V|) + 2^-17. Raises past it; returns max |Δ|."""
    import torch

    err = (got.float() - want.float()).abs()
    if dtype_name == "bf16":
        b, s, d3 = qkv.shape
        v = qkv.view(b, s, 3, h, d3 // 3 // h)[:, :, 2].permute(
            0, 2, 1, 3).float().abs()
        spread = torch.matmul(pd.float().abs(), v).permute(0, 2, 1, 3)
        bound = 2.0 ** -7 * (want.float().abs() + spread.reshape(b, s, -1)) \
            + 2.0 ** -17
    else:
        bound = torch.full_like(err, FP32_ATOL)
    if bool((err > bound).any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: {int((err > bound).sum())} elements "
                             f"out of the stated bound, max_abs_err="
                             f"{float(err.max())}")
    return float(err.max())


def check_long_kernels(rng, fa, dtype_name, b, s, rate, h=12, dh=64):
    """Phase 3e on one case: #4 and #5 (S ≤ HB_MAX_SEQ_LEN) and #6 and #7
    against their plain versions; #6 against the whole-row plain forward
    (the same seed: the same mask in both tiers) within ``_tier_err``'s
    bound; lse against the plain lse (fp32 1e-5 plus 1e-6 relative: a
    fully padded row's lse is near −10^4); the same bits from the same
    seed twice. Returns the max errors and the case."""
    import torch

    qkv, mask, g, seed = long_case(rng, dtype_name, b, s, h, dh)
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5)
    tag = f"{dtype_name} B={b} S={s} H={h} Dh={dh} rate={rate}"
    # the whole-row probs, for the bf16 gradient bound and the tier bound
    w_out, p, pd = fa.attn_fwd_packed_reference(qkv, mask, rate=rate,
                                                seed=seed, save=True, **kw)
    bound_args = (p, pd, qkv, g, kw)
    errs, twice = {}, []
    if s <= fa.HB_MAX_SEQ_LEN:
        out4 = fa.attn_fwd_packed_hb_cuda(qkv, mask, rate=rate, seed=seed,
                                          **kw)
        errs["#4"] = _forward_err(
            f"#4 {tag}", out4, fa.attn_fwd_packed_hb_reference(
                qkv, mask, rate=rate, seed=seed, **kw), dtype_name)
        d5 = fa.attn_bwd_packed_hb_cuda(qkv, mask, seed, g, rate=rate, **kw)
        errs["#5"] = _grad_err(
            f"#5 {tag}", d5, fa.attn_bwd_packed_hb_reference(
                qkv, mask, seed, g, rate=rate, **kw), dtype_name,
            bound_args, fa)
        twice += [(out4, lambda: fa.attn_fwd_packed_hb_cuda(
            qkv, mask, rate=rate, seed=seed, **kw)),
                  (d5, lambda: fa.attn_bwd_packed_hb_cuda(
                      qkv, mask, seed, g, rate=rate, **kw))]
    out6, lse = fa.attn_fwd_packed_fs_cuda(qkv, mask, rate=rate, seed=seed,
                                           **kw)
    r_out6, r_lse = fa.attn_fwd_packed_fs_reference(qkv, mask, rate=rate,
                                                    seed=seed, **kw)
    errs["#6"] = _forward_err(f"#6 {tag}", out6, r_out6, dtype_name)
    lse_err = (lse - r_lse).abs()
    if bool((lse_err > 1e-5 + 1e-6 * r_lse.abs()).any()):
        raise AssertionError(f"#6 lse {tag}: max_abs_err "
                             f"{float(lse_err.max())}")
    errs["#6 lse"] = float(lse_err.max())
    errs["#6 vs whole-row plain"] = _tier_err(
        f"#6 vs whole-row plain {tag}", out6, w_out, pd, qkv, h, dtype_name)
    d7 = fa.attn_bwd_packed_fs_cuda(qkv, mask, seed, out6, lse, g, rate=rate,
                                    **kw)
    errs["#7"] = _grad_err(f"#7 {tag}", d7, fa.attn_bwd_packed_fs_reference(
        qkv, mask, seed, out6, lse, g, rate=rate, **kw), dtype_name,
        bound_args, fa)
    if dtype_name == "fp32":
        # In fp32 δ = Σ g⊙o is Σ_k pd⊙d(pd) to rounding, so #7 is the
        # whole-row recompute backward's function, on the batch rows with a
        # real token. A fully padded row's scores sit near −10^4, where the
        # fp32 lse keeps ~5e-4 relative precision, so its p = exp(s − lse)
        # is that far from the whole-row softmax (the JAX fs tier's too).
        live = mask.any(dim=1)
        errs["#7 vs whole-row plain"] = _grad_err(
            f"#7 vs whole-row plain {tag}", d7[live],
            fa.attn_bwd_packed_reference(qkv, mask, seed, g, rate=rate,
                                         **kw)[live], dtype_name, None, fa)
    twice += [(out6, lambda: fa.attn_fwd_packed_fs_cuda(
        qkv, mask, rate=rate, seed=seed, **kw)[0]),
              (d7, lambda: fa.attn_bwd_packed_fs_cuda(
                  qkv, mask, seed, out6, lse, g, rate=rate, **kw))]
    same = all(torch.equal(first, again()) for first, again in twice)
    print(f"long kernels vs plain {tag}: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items())
        + f"; same seed twice, identical bits {same}")
    if not same:
        raise AssertionError(f"the long kernels are not bit-reproducible "
                             f"({tag})")
    return errs, (qkv, mask, g, seed, kw)


def check_long_against_full(rng, fa):
    """#4 against #1 (S = 128, 512) and #5 against #2 (S = 128) at rate
    0.1. fp32 #4 and #5 run #1's and #2's row code: the same bits. In bf16
    #1 past S = 64 runs #4's tensor-core plan (csrc/attn_full_tc.cuh), held
    within the phase-3 forward bound (``_forward_err``; its identical bits
    printed); #5 rebuilds p from its own online statistics
    (exp(s − m)·(1/l), δ an online sum) where #2 takes the whole-row e / l
    and Σ t, so it is held to #2 within ``dqkv_bf16_bound``."""
    import torch

    for dtype_name in ("bf16", "fp32"):
        for s in (128, 512):
            qkv, mask, g, seed = long_case(rng, dtype_name, 8, s)
            kw = dict(n_heads=12, scale=0.125, rate=RATE)
            pairs = [("#4 vs #1", fa.attn_fwd_packed_hb_cuda(
                qkv, mask, seed=seed, **kw), fa.attn_fwd_packed_cuda(
                qkv, mask, seed=seed, **kw))]
            if s <= fa.max_bwd_seq_len(64):
                pairs.append(("#5 vs #2", fa.attn_bwd_packed_hb_cuda(
                    qkv, mask, seed, g, **kw), fa.attn_bwd_packed_cuda(
                    qkv, mask, seed, g, **kw)))
            for name, got, want in pairs:
                tag = f"{name} {dtype_name} B=8 S={s} rate {RATE}"
                same = torch.equal(got, want)
                if dtype_name == "bf16":
                    if name == "#4 vs #1":
                        err = _forward_err(tag, got, want, dtype_name)
                        what = "the forward bound"
                    else:
                        _, p, pd = fa.attn_fwd_packed_reference(
                            qkv, mask, seed=seed, save=True, **kw)
                        err = _grad_err(tag, got, want, dtype_name, (
                            p, pd, qkv, g, dict(n_heads=12, scale=0.125)),
                            fa)
                        what = "dqkv_bf16_bound"
                    print(f"{tag}: within {what}, max |Δ| {err:.3e} "
                          f"(identical bits {same})")
                    continue
                diff = float((got.float() - want.float()).abs().max())
                print(f"{tag}: identical bits {same}, max |Δ| {diff:.3e}")
                if not same:
                    raise AssertionError(f"{tag}: not the same bits")


def check_long_masks(rng, fa):
    """#4's, #6's and #5's keep masks against the plain Philox mask, bit
    for bit: with Q = K = 0 every score is 0 and p = 1/S, and with V_h the
    identity (S = Dh = 128) the output is out[q, h, c] = keep(q, c)/(S·(1 −
    rate)) rounded, > 0 exactly where (b, h, q, c) is kept; with g_h the
    identity #5's dV[k, h, c] = pd(c, k) likewise (its dK/dV pass's mask).
    bf16 B=2 S=128 H=6 Dh=128 at rate 0.1; the keep rate within 5σ of
    0.9."""
    import torch

    b, s, h, dh = 2, 128, 6, 128
    qkv = torch.zeros(b, s, 3, h, dh, device="cuda", dtype=torch.bfloat16)
    qkv[:, :, 2] = torch.eye(s, device="cuda", dtype=torch.bfloat16)[
        None, :, None, :]
    qkv = qkv.reshape(b, s, 3 * h * dh)
    seed = int(rng.integers(0, 2 ** 63 - 1))
    keep = fa.dropout_keep_mask(seed, b, h, s, s, RATE, "cuda")
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5, rate=RATE, seed=seed)
    eye = qkv.view(b, s, 3, h * dh)[:, :, 2].contiguous()  # g_h = I
    d5 = fa.attn_bwd_packed_hb_cuda(qkv, None, seed, eye, n_heads=h,
                                    scale=kw["scale"], rate=RATE)
    for name, out in (
            ("#4", fa.attn_fwd_packed_hb_cuda(qkv, None, **kw)),
            ("#6", fa.attn_fwd_packed_fs_cuda(qkv, None, **kw)[0]),
            ("#5's dV", d5.view(b, s, 3, h, dh)[:, :, 2].permute(
                0, 2, 3, 1))):
        if name != "#5's dV":
            out = out.view(b, s, h, dh).permute(0, 2, 1, 3)
        kernel_keep = out > 0
        if not torch.equal(kernel_keep, keep):
            n_bad = int((kernel_keep != keep).sum())
            raise AssertionError(f"{name} keep mask differs from the plain "
                                 f"Philox mask in {n_bad} elements")
        got = float(kernel_keep.double().mean())
        sigma = math.sqrt(RATE * (1 - RATE) / keep.numel())
        if abs(got - (1 - RATE)) >= 5 * sigma:
            raise AssertionError(f"{name} keep rate {got} not within 5σ")
        print(f"{name} keep mask = plain Philox mask bit for bit over "
              f"{keep.numel()} elements (bf16 B={b} S={s} H={h} Dh={dh}), "
              f"keep rate {got:.6f} (5σ={5 * sigma:.1e})")


def sdpa_backward_call(qkv, mask, h, scale, g):
    """The library call for the rate-0 backwards: the autograd backward of
    ``scaled_dot_product_attention`` (as ``sdpa_call``) to the packed
    projection. Returns the call; never used by the port."""
    import torch
    import torch.nn.functional as F

    b, s, d3 = qkv.shape
    x = qkv.detach().clone().requires_grad_()
    q, k, v = x.view(b, s, 3, h, d3 // 3 // h).permute(2, 0, 3, 1, 4)
    bias = ((1.0 - mask) * -10000.0).to(qkv.dtype)[:, None, None, :]
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                         scale=scale)
    gh = g.view(b, s, h, d3 // 3 // h).transpose(1, 2)

    def call():
        return torch.autograd.grad(out, x, gh, retain_graph=True)

    return call


def hb_bwd_passes(fa, qkv, mask, seed, g, rate, h=12, scale=0.125):
    """bf16 #5's two launches one at a time on the buffers its wrapper
    allocates: {pass: call}, for timing the passes apart. The calls go to
    the library directly, so no launch count moves."""
    import torch

    b, s, d3 = qkv.shape
    dqkv = torch.empty_like(qkv)
    ws = torch.empty((3, b, h, s), dtype=torch.float32, device=qkv.device)
    args = (qkv.data_ptr(), fa._ptr(mask), g.data_ptr(), dqkv.data_ptr(),
            ws.data_ptr(), b, s, h, d3 // 3 // h, float(scale),
            *fa._drop_args(rate, seed), fa._DTYPE_CODES[qkv.dtype])
    keep = (dqkv, ws)

    def launch(name):
        return lambda: (keep, fa._launch(name, *args, device=qkv.device))

    return {"statistics + dQ pass": launch("attn_bwd_packed_hb"),
            "dK/dV pass": launch("attn_bwd_packed_hb_dkdv")}


def time_long_kernels(rng, fa, card):
    """#4 and #5 at the driver's S = 512, #6 and #7 at its S = 1024, bf16
    B=48 (its train batch): at rate 0 against the plain versions and the
    library call (SDPA forward; SDPA's autograd backward), and at rate 0.1
    (the training path) against the plain versions; alternating rounds;
    #5's two launches timed apart (``hb_bwd_passes``). Returns {name:
    entry}."""
    out = {}
    for s, names in ((512, ("attn_fwd_packed_hb", "attn_bwd_packed_hb")),
                     (1024, ("attn_fwd_packed_fs", "attn_bwd_packed_fs"))):
        qkv, mask, g, seed = long_case(rng, "bf16", TRAIN_BATCH, s)
        kw = dict(n_heads=12, scale=0.125)
        fwd, bwd = names
        for rate in (0.0, RATE):
            o = lse = None
            if bwd == "attn_bwd_packed_fs":   # #7's residuals
                o, lse = fa.attn_fwd_packed_fs_cuda(qkv, mask, rate=rate,
                                                    seed=seed, **kw)
            runs = {
                "attn_fwd_packed_hb": (
                    lambda: fa.attn_fwd_packed_hb_cuda(qkv, mask, rate=rate,
                                                       seed=seed, **kw),
                    lambda: fa.attn_fwd_packed_hb_reference(
                        qkv, mask, rate=rate, seed=seed, **kw)),
                "attn_bwd_packed_hb": (
                    lambda: fa.attn_bwd_packed_hb_cuda(qkv, mask, seed, g,
                                                       rate=rate, **kw),
                    lambda: fa.attn_bwd_packed_hb_reference(
                        qkv, mask, seed, g, rate=rate, **kw)),
                "attn_fwd_packed_fs": (
                    lambda: fa.attn_fwd_packed_fs_cuda(qkv, mask, rate=rate,
                                                       seed=seed, **kw),
                    lambda: fa.attn_fwd_packed_fs_reference(
                        qkv, mask, rate=rate, seed=seed, **kw)),
                "attn_bwd_packed_fs": (
                    lambda: fa.attn_bwd_packed_fs_cuda(
                        qkv, mask, seed, o, lse, g, rate=rate, **kw),
                    lambda: fa.attn_bwd_packed_fs_reference(
                        qkv, mask, seed, o, lse, g, rate=rate, **kw))}
            for name in names:
                run_kernel, run_plain = runs[name]
                k, pl = _alternate(run_plain, run_kernel, 3)
                kind = "fwd" if name == fwd else "bwd"
                bound = long_bound(kind, TRAIN_BATCH, s, 12, 64, 2,
                                   fs=name.endswith("_fs"))
                entry = {"ms": float(np.mean(k)), "plain_ms": float(
                    np.mean(pl)), "bound_ms": bound[0],
                    "bound_by": bound[1]}
                lib_note = ""
                if rate == 0.0:
                    lib = (sdpa_call(qkv, mask, 12, 0.125)[0] if kind == "fwd"
                           else sdpa_backward_call(qkv, mask, 12, 0.125, g))
                    _time_ms(lib, 2)
                    entry["library_ms"] = float(np.mean(
                        [_time_ms(lib, 3) for _ in range(2)]))
                    entry["library"] = ("scaled_dot_product_attention, "
                                        "[B,1,1,S] mask" if kind == "fwd"
                                        else "scaled_dot_product_attention"
                                        " autograd backward, rate 0")
                    lib_note = f", library {entry['library_ms']:.3f} ms"
                    out[name] = entry
                else:
                    out[name]["modes"] = {
                        f"training rate {RATE}, bf16 B={TRAIN_BATCH} S={s}":
                            entry}
                print(f"{name} bf16 B={TRAIN_BATCH} S={s} H=12 Dh=64 rate "
                      f"{rate} on {card}: kernel {k} ms, plain {pl} ms per "
                      f"call{lib_note}; bound {bound[0]:.4f} ms ({bound[1]})")
            if bwd == "attn_bwd_packed_hb":
                passes = hb_bwd_passes(fa, qkv, mask, seed, g, rate)
                for call in passes.values():
                    _time_ms(call, 2)
                pass_ms = {n: float(np.mean([_time_ms(c, 3)
                                             for _ in range(2)]))
                           for n, c in passes.items()}
                e5 = out[bwd]
                (e5 if rate == 0.0 else next(iter(e5["modes"].values())))[
                    "passes_ms"] = pass_ms
                print(f"{bwd} passes bf16 B={TRAIN_BATCH} S={s} rate {rate} "
                      f"on {card}: " + ", ".join(
                          f"{n} {v:.3f} ms" for n, v in pass_ms.items()))
                del passes
    return out


def long_bound(kind, b, s, h, dh, itemsize, fs=False):
    """The bound of a long-tier kernel at [B, S, H, Dh]: each input read
    once and each output written once (qkv, the mask and out, plus lse for
    #6; qkv, the mask, g and dqkv, plus o and lse for #7); the products
    on the bf16 tensor cores, 2·B·H·S²·Dh operations each (QKᵀ and PV
    forward; QKᵀ, d(pd), dV, dQ and dK backward)."""
    d = h * dh
    qkv, ctx, mask = b * s * 3 * d * itemsize, b * s * d * itemsize, b * s * 4
    lse = b * h * s * 4 if fs else 0
    dot = 2 * b * h * s * s * dh
    if kind == "fwd":
        return _bound(qkv + mask + ctx + lse, 2 * dot, BF16_FLOPS)
    return _bound(qkv + mask + ctx + qkv + (ctx + lse if fs else 0),
                  5 * dot, BF16_FLOPS)


def _long_bert(cfg, ds, seed):
    import torch

    from bert_multimodal_transformer_tpu_torch.config import MultimodalConfig
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )

    return MagBertForSequenceClassification(
        cfg, MultimodalConfig(), ds.visual_dim, ds.acoustic_dim,
        torch.bfloat16, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(seed))


def long_serving(args, rng, fa, card):
    """Phase 4d: ``Predictor.predict_split`` at bert-base width with a
    1024-row position table, bf16, fused attention, over 256 seeded
    examples at batch 128, at S = 640 (#4) and S = 1024 (#6). Checks: the
    tier's kernel once per layer per batch and nothing else, finite
    predictions, and agreement with the same weights on einsum attention.
    Returns {S: counts}."""
    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.serving import Predictor

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                              attention_impl="fused",
                              max_position_embeddings=1024)
    model = _long_bert(cfg, ds, args.seed + 20)
    predictor = Predictor(model, batch_size=BATCH)
    einsum = _long_bert(dataclasses.replace(cfg, attention_impl="einsum"),
                        ds, 0)
    einsum.load_state_dict(model.state_dict())
    counts = {}
    for s, kernel in ((640, "attn_fwd_packed_hb"),
                      (1024, "attn_fwd_packed_fs")):
        split = make_split(rng, LONG_SERVE_N, s, cfg.vocab_size,
                           ds.visual_dim, ds.acoustic_dim)
        predictor.predict_split(split.take(np.arange(BATCH)))  # warm-up
        _zero_counts(fa)
        t0 = time.perf_counter()
        preds = predictor.predict_split(split)
        dt = time.perf_counter() - t0
        counts[s] = _counts(fa)
        n_batches = -(-LONG_SERVE_N // BATCH)
        want = _want(fa, **{kernel: cfg.num_hidden_layers * n_batches})
        print(f"kernel launches in predict_split at S={s}: {counts[s]} "
              f"(want {want})")
        if counts[s] != want:
            raise AssertionError(f"S={s} serving launches {counts[s]} != "
                                 f"{want}")
        if preds.shape != (LONG_SERVE_N,) or not np.isfinite(preds).all():
            raise AssertionError(f"bad S={s} predictions {preds.shape}")
        preds_e = Predictor(einsum, batch_size=BATCH).predict_split(split)
        gap = float(np.abs(preds - preds_e).max())
        print(f"bert-base S={s} serving on {card}: predict_split "
              f"{LONG_SERVE_N / dt:.1f} examples/s (batch {BATCH}, bf16); "
              f"fused vs einsum predictions max |Δ| {gap:.3e} (tolerance "
              f"{PRED_ATOL}), |pred| max {np.abs(preds_e).max():.3f}")
        if not gap <= PRED_ATOL:
            raise AssertionError(f"S={s}: fused and einsum predictions "
                                 f"differ by {gap}")
    return counts


def long_step_profile(args, rng, card):
    """One training step of bert-base at the driver's batch (48), bf16,
    fused attention, dropout 0.1/0.1/0.5, at S = 512 (#4, #5) and 1024
    (#6, #7): its device time by kernel group (torch.profiler), after one
    warm-up step."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
        make_train_step,
    )
    from bert_multimodal_transformer_tpu_torch.utils.profiling import (
        device_time_by_kernel,
    )

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                              attention_impl="fused",
                              max_position_embeddings=1024)
    state = Trainer(model=_long_bert(cfg, ds, args.seed + 21),
                    tx=make_optimizer(1e-5, 10, 0.1)
                    ).create_state_from_params(None, args.seed)
    step = make_train_step()
    for s in (512, 1024):
        batch = _device_batch(make_split(
            rng, TRAIN_BATCH, s, cfg.vocab_size, ds.visual_dim,
            ds.acoustic_dim).as_tuple())
        step(state, batch)
        torch.cuda.synchronize()
        print(f"one training step, bf16 bert-base B={TRAIN_BATCH} S={s} on "
              f"{card}:")
        _print_profile(device_time_by_kernel(lambda: step(state, batch), 1),
                       1, "step")


def long_driver_path(args, fa, card):
    """Phase 6c: ``driver.main`` at bert-base with ``--max_seq_length 512``
    and ``1024`` (``--attention_impl fused``, bf16, one epoch over
    synthetic splits of 96/48/48). Checks: exit 0, finite losses, and the
    launches: at S=512 training takes #4 and #5 (two launches a call) and
    evaluation #1; at S=1024 training takes #6 and #7 (two launches a
    call) and evaluation #6. Returns {S: counts}."""
    from bert_multimodal_transformer_tpu_torch.config import BertConfig

    layers = BertConfig.bert_base_uncased().num_hidden_layers
    n_train = -(-LONG_SPLITS[0] // TRAIN_BATCH)
    n_eval = sum(-(-n // EVAL_BATCH) for n in LONG_SPLITS[1:])
    counts = {}
    for s in (512, 1024):
        argv = ["--model", "bert-base-uncased", "--dataset", "mosi",
                "--synthetic", "--synthetic_sizes", *map(str, LONG_SPLITS),
                "--n_epochs", "1", "--attention_impl", "fused",
                "--compute_dtype", "bfloat16", "--max_seq_length", str(s),
                "--seed", str(args.seed)]
        counts[s] = run_driver(argv, fa, card)
        if s == 512:
            want = _want(fa, attn_fwd_packed_hb=layers * n_train,
                         attn_bwd_packed_hb=2 * layers * n_train,
                         attn_fwd_packed=layers * n_eval)
        else:
            want = _want(fa, attn_fwd_packed_fs=layers * (n_train + n_eval),
                         attn_bwd_packed_fs=2 * layers * n_train)
        print(f"kernel launches in driver.main --max_seq_length {s}: "
              f"{counts[s]} (want {want}: {n_train} train + {n_eval} "
              f"dev/test batches, {layers} layers)")
        if counts[s] != want:
            raise AssertionError(f"S={s} driver launches {counts[s]} != "
                                 f"{want}")
    return counts


# ---- Long-sequence MAG-XLNet: the ingredients flash-streamed (#23, #24) and
# the head-blocked rel (#14, #15) tiers ---------------------------------------

XLNET_LONG_S = (512, 1024)    # the driver's long XLNet runs
XLNET_CHECK_BATCH = 8         # the dropout-0 gradient check's batch


def relik_case(rng, dtype_name, b, s, h=12, dh=64, k_len=None):
    """One seeded ingredients case shaped as the XLNet model feeds #23 (Q =
    S): rw, rr (scaled) [B, S, D], r [S + K, D] (bi attention: P = Q + K),
    k, v [B, K, D], the scaled segment delta ed [B, H, S], segd from XLNet
    segments and maskb −1e30 on the masked keys of left-padded rows (each
    query still sees its own position), all in the input dtype; a context
    gradient; a seed. K = S unless ``k_len``: then the first K − S keys are
    a memory, unmasked and of segment 0, as the model's; K < S (a shape
    past what one block's shared memory holds at once, the query rows in
    chunks) takes the last K tokens as the keys."""
    import torch

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype_name]
    d, sc = h * dh, 1.0 / dh ** 0.5
    k_len = s if k_len is None else k_len
    mlen = k_len - s

    def t(*shape, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                * scale).to("cuda", dtype)

    # (the segments of a 3-token row cut to its last S where S < 3)
    mask, segs = (torch.from_numpy(x[:, -s:]).cuda()
                  for x in xlnet_segments(rng, b, max(s, 3)))
    own = torch.zeros(s, k_len, dtype=torch.bool, device="cuda")
    if mlen < 0:
        mask_k, segs_k = mask[:, -k_len:], segs[:, -k_len:]
        own[-k_len:] = torch.eye(k_len, dtype=torch.bool, device="cuda")
    else:
        mem = torch.zeros(b, mlen, dtype=mask.dtype, device="cuda")
        mask_k = torch.cat([mem + 1, mask], 1)
        segs_k = torch.cat([mem, segs], 1)
        own[:, mlen:] = torch.eye(s, dtype=torch.bool, device="cuda")
    masked = (mask_k[:, None, :] == 0) & ~own
    case = dict(rw=t(b, s, d), rr=t(b, s, d, scale=sc), r=t(s + k_len, d),
                k=t(b, k_len, d), v=t(b, k_len, d), ed=t(b, h, s, scale=sc),
                segd=(segs[:, :, None] != segs_k[:, None, :]).to(dtype),
                maskb=(-(1e30 * masked.float())).to(dtype), g=t(b, s, d))
    return case, int(rng.integers(0, 2 ** 63 - 1))


RELIK = ("rw", "rr", "r", "k", "v", "ed", "segd", "maskb")


def _relik_grad_errs(name, dtype_name, got, want, bound_args, fa):
    """Max abs err over an ingredients backward's (drw, drr, dr, dk, dv,
    ded); raises past the bound (fp32: GRAD_FP32_TOL; bf16: the bound
    function of ``bound_args`` = (function, args, kwargs), #24's
    ``relik_grads_bf16_bound`` or #21/#22's
    ``relik_full_grads_bf16_bound``)."""
    import torch

    if dtype_name == "bf16":
        bound_fn, args, kwargs = bound_args
        bounds = bound_fn(want, *args, **kwargs)
    else:
        bounds = [GRAD_FP32_TOL + GRAD_FP32_TOL * w.float().abs()
                  for w in want]
    worst = 0.0
    for part, a, w, bd in zip(("drw", "drr", "dr", "dk", "dv", "ded"), got,
                              want, bounds):
        err = (a.float() - w.float()).abs()
        if bool((err > bd).any()) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name} {part}: {int((err > bd).sum())} "
                                 f"elements out of tolerance, max_abs_err="
                                 f"{float(err.max())}")
        worst = max(worst, float(err.max()))
    return worst


def check_long_rel_kernels(rng, fa, dtype_name, b, s, rate, h=12, dh=64,
                           k_len=None):
    """Phase 3f on one case (Q = S; K = S unless ``k_len``, the first K − S
    keys then a memory): #14 and #15 (K ≤ HB_MAX_SEQ_LEN) on the ebias the
    model assembles, and #23 and #24 on the ingredients (P = Q + K), each
    against its plain version (lse to 1e-4 absolute plus 1e-6 relative: a
    score near −1e30 is never the row max, so the lse carries the fp32
    sums' rounding only); the same bits from the same seed twice. Returns
    the max errors."""
    import torch

    k_len = s if k_len is None else k_len
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5, rate=rate)
    tag = (f"{dtype_name} B={b} Q={s} K={k_len} H={h} Dh={dh} "
           f"rate={rate}")
    errs, twice = {}, []
    if k_len <= fa.HB_MAX_SEQ_LEN:
        q, k, v, ebias, g = rel_case(rng, dtype_name, b, s, k_len, h, dh)
        hb_seed = int(rng.integers(0, 2 ** 63 - 1))
        out = fa.attn_fwd_rel_hb_cuda(q, k, v, ebias, seed=hb_seed, **kw)
        errs["#14"] = _forward_err(f"#14 {tag}", out, fa.attn_fwd_rel_hb_reference(
            q, k, v, ebias, seed=hb_seed, **kw), dtype_name)
        grads = fa.attn_bwd_rel_hb_cuda(q, k, v, ebias, hb_seed, g, **kw)
        _, p, pd = fa.attn_fwd_rel_reference(q, k, v, ebias, seed=hb_seed,
                                             save=True, **kw)
        rate_kw = {x: kw[x] for x in ("n_heads", "scale")}
        errs["#15"] = _rel_grad_errs(tag, dtype_name, (
            ("#15 vs plain", grads, fa.attn_bwd_rel_hb_reference(
                q, k, v, ebias, hb_seed, g, **kw)),), (p, pd, q, k, v, g,
                                                       rate_kw), fa)["#15 vs plain"]
        del p, pd
        twice += [("#14", (out,), lambda: (fa.attn_fwd_rel_hb_cuda(
            q, k, v, ebias, seed=hb_seed, **kw),)),
                  ("#15", grads, lambda: fa.attn_bwd_rel_hb_cuda(
                      q, k, v, ebias, hb_seed, g, **kw))]
    c, seed = relik_case(rng, dtype_name, b, s, h, dh, k_len)
    ins = [c[n] for n in RELIK]
    o23, lse = fa.attn_fwd_relik_fs_cuda(*ins, seed=seed, **kw)
    r_out, r_lse = fa.attn_fwd_relik_fs_reference(*ins, seed=seed, **kw)
    errs["#23"] = _forward_err(f"#23 {tag}", o23, r_out, dtype_name)
    lse_err = (lse - r_lse).abs()
    if bool((lse_err > 1e-4 + 1e-6 * r_lse.abs()).any()):
        raise AssertionError(f"#23 lse {tag}: max_abs_err "
                             f"{float(lse_err.max())}")
    errs["#23 lse"] = float(lse_err.max())
    g24 = fa.attn_bwd_relik_fs_cuda(*ins, seed, o23, lse, c["g"], **kw)
    errs["#24"] = _relik_grad_errs(
        f"#24 {tag}", dtype_name, g24, fa.attn_bwd_relik_fs_reference(
            *ins, seed, o23, lse, c["g"], **kw),
        (fa.relik_grads_bf16_bound, (*ins, seed, lse, c["g"], o23), kw), fa)
    twice += [("#23", (o23, lse), lambda: fa.attn_fwd_relik_fs_cuda(
        *ins, seed=seed, **kw)),
              ("#24", g24, lambda: fa.attn_bwd_relik_fs_cuda(
                  *ins, seed, o23, lse, c["g"], **kw))]
    differ = [name for name, first, again in twice
              if not all(torch.equal(x, y) for x, y in zip(first, again()))]
    print(f"long rel kernels vs plain {tag}: " + ", ".join(
        f"{k_} {v_:.3e}" for k_, v_ in errs.items())
        + f"; same seed twice, identical bits {not differ}")
    if differ:
        raise AssertionError(f"{', '.join(differ)} not bit-reproducible "
                             f"({tag})")
    return errs


def check_long_rel_against_full(rng, fa):
    """#14 against #11 (Q = K = 128, 512) and #15 against #12 (Q = K =
    128) at rate 0.1. fp32 #14 and #15 run #11's and #12's row code: the
    same bits. In bf16 #14 and #11 (its score-tile plan past K = 64) both
    sum their dots on the tensor cores, from kernels built apart, so #14 is
    held to #11 within the phase-3 forward bound (``_forward_err``); #15
    rebuilds p from its own online statistics (exp(s − m)·(1/l), δ an
    online sum) where #12 takes the whole-row e / l and Σ t, so it is held
    to #12 within ``rel_grads_bf16_bound``."""
    import torch

    for dtype_name in ("bf16", "fp32"):
        for s in (128, 512):
            q, k, v, ebias, g = rel_case(rng, dtype_name, 8, s, s)
            kw = dict(n_heads=12, scale=0.125, rate=RATE)
            pairs = [("#14 vs #11", fa.attn_fwd_rel_hb_cuda(q, k, v, ebias,
                                                            seed=s, **kw),
                      fa.attn_fwd_rel_cuda(q, k, v, ebias, seed=s, **kw))]
            if fa.rel_bwd_fits(s, s, 64):
                pairs += [(f"#15 vs #12 {part}", x, y) for part, x, y in zip(
                    ("dq", "dk", "dv", "debias"),
                    fa.attn_bwd_rel_hb_cuda(q, k, v, ebias, s, g, **kw),
                    fa.attn_bwd_rel_cuda(q, k, v, ebias, s, g, **kw))]
            tag = f"{dtype_name} B=8 Q=K={s} rate {RATE}"
            if dtype_name == "bf16":
                err = _forward_err(f"#14 vs #11 {tag}", *pairs[0][1:],
                                   dtype_name)
                print(f"#14 vs #11 {tag}: within the forward bound, max |Δ| "
                      f"{err:.3e} (identical bits "
                      f"{torch.equal(*pairs[0][1:])})")
                if len(pairs) > 1:
                    _, p, pd = fa.attn_fwd_rel_reference(q, k, v, ebias,
                                                         seed=s, save=True,
                                                         **kw)
                    err = _rel_grad_errs(tag, dtype_name, (
                        ("#15 vs #12", [x for _, x, _ in pairs[1:]],
                         [y for _, _, y in pairs[1:]]),), (
                        p, pd, q, k, v, g, dict(n_heads=12, scale=0.125)),
                        fa)["#15 vs #12"]
                    same = all(torch.equal(x, y) for _, x, y in pairs[1:])
                    print(f"#15 vs #12 {tag}: within rel_grads_bf16_bound, "
                          f"max |Δ| {err:.3e} (identical bits {same})")
                continue
            for name, got, want in pairs:
                same = torch.equal(got, want)
                print(f"{name} {tag}: identical bits {same}, max |Δ| "
                      f"{float((got.float() - want.float()).abs().max()):.3e}")
                if not same:
                    raise AssertionError(f"{name} {tag}: not the same bits")


def check_relik_mask(rng, fa):
    """#23's keep mask against the plain Philox mask, bit for bit: with rw
    = rr = ed = 0 and no mask every score is 0 and p = 1/K, and with v_h
    the identity (K = Dh = 128) the output is out[q, h, c] = keep(q, c)/
    (K·(1 − rate)) rounded, > 0 exactly where (b, h, q, c) is kept. bf16
    B=2 S=128 H=6 Dh=128 at rate 0.1."""
    import torch

    b, s, h, dh = 2, 128, 6, 128
    c, seed = relik_case(rng, "bf16", b, s, h, dh)
    for n in ("rw", "rr", "ed", "maskb"):
        c[n].zero_()
    c["v"] = torch.eye(s, device="cuda", dtype=torch.bfloat16)[
        None, :, None, :].expand(b, s, h, dh).reshape(b, s, h * dh).contiguous()
    keep = fa.dropout_keep_mask(seed, b, h, s, s, RATE, "cuda")
    out, _ = fa.attn_fwd_relik_fs_cuda(*(c[n] for n in RELIK), n_heads=h,
                                       scale=dh ** -0.5, rate=RATE, seed=seed)
    kernel_keep = out.view(b, s, h, dh).permute(0, 2, 1, 3) > 0
    if not torch.equal(kernel_keep, keep):
        raise AssertionError(f"#23 keep mask differs from the plain Philox "
                             f"mask in {int((kernel_keep != keep).sum())} "
                             "elements")
    got = float(kernel_keep.double().mean())
    sigma = math.sqrt(RATE * (1 - RATE) / keep.numel())
    if abs(got - (1 - RATE)) >= 5 * sigma:
        raise AssertionError(f"#23 keep rate {got} not within 5σ")
    print(f"#23 keep mask = plain Philox mask bit for bit over "
          f"{keep.numel()} elements (bf16 B={b} S={s} H={h} Dh={dh}), keep "
          f"rate {got:.6f} (5σ={5 * sigma:.1e})")


def relik_bound(kind, b, s, h, dh, itemsize):
    """The bound of #23 (``fwd``) or #24 at B, Q = K = S, P = 2S: each input
    read once and each output written once (rw, rr, r, k, v, ed, segd,
    maskb; out and the fp32 lse; #24 also o, lse and g, and writes drw,
    drr, dr, dk, dv, ded); the products on the bf16 tensor cores, 2·B·H·
    S²·Dh operations each (rw·kᵀ, rr·r on the shifted window and PV
    forward; those three less PV, then dV, dK, drw, drr and dr backward)."""
    d = h * dh
    qd, pd_, hq = b * s * d * itemsize, 2 * s * d * itemsize, b * h * s
    ins = 5 * qd + pd_ + hq * itemsize + 2 * b * s * s * itemsize
    dot = 2 * b * h * s * s * dh
    if kind == "fwd":
        return _bound(ins + qd + 4 * hq, 3 * dot, BF16_FLOPS)
    return _bound(ins + 2 * qd + 4 * hq + 5 * qd + pd_ + hq * itemsize,
                  8 * dot, BF16_FLOPS)


def assembled_ebias(c, h=12):
    """The [B, H, Q, K] score bias an ingredients case stands for, assembled
    at its dtype as the XLNet model's stream path does: rel_shift of the bd
    product (rr·rᵀ), plus ed·segd, plus maskb."""
    import torch

    from bert_multimodal_transformer_tpu_torch.models.xlnet import rel_shift

    b, q_len, d = c["rr"].shape
    bd = torch.einsum("bqhf,phf->bhqp", c["rr"].view(b, q_len, h, d // h),
                      c["r"].view(-1, h, d // h))
    return (rel_shift(bd, c["k"].shape[1]) + c["ed"][..., None]
            * c["segd"][:, None] + c["maskb"][:, None]).contiguous()


def sdpa_rel_calls(q, k, v, ebias, g, h, scale):
    """The library calls for the rate-0 rel tiers: ``scaled_dot_product_
    attention`` with the assembled ebias as its float mask, and its autograd
    backward to q, k, v and ebias. Returns (forward, backward); never used
    by the port."""
    import torch
    import torch.nn.functional as F

    b, q_len, d = q.shape
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v, ebias)]
    heads = [x.view(b, -1, h, d // h).transpose(1, 2) for x in xs[:3]]
    out = F.scaled_dot_product_attention(*heads, attn_mask=xs[3],
                                         scale=scale)
    gh = g.view(b, q_len, h, d // h).transpose(1, 2)

    def forward():
        with torch.no_grad():
            return F.scaled_dot_product_attention(
                *(x.detach() for x in heads), attn_mask=ebias, scale=scale)

    def backward():
        return torch.autograd.grad(out, xs, gh, retain_graph=True)

    return forward, backward


def rel_bwd_passes(fa, name, q, k, v, ebias, seed, g, rate, o=None,
                   lse=None, h=12, scale=0.125):
    """bf16 #15's (``name`` "attn_bwd_rel_hb") or #17's ("attn_bwd_rel_fs",
    from #16's ``o`` and ``lse``) two launches one at a time on the buffers
    its wrapper allocates: {pass: call}, for timing the passes apart. The
    calls go to the library directly, so no launch count moves."""
    import torch

    b, q_len, d = q.shape
    dq, dk, dv, debias = (torch.empty_like(x) for x in (q, k, v, ebias))
    tail = (b, q_len, k.shape[1], h, d // h, float(scale),
            *fa._drop_args(rate, seed), fa._DTYPE_CODES[q.dtype])
    outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), debias.data_ptr())
    if name == "attn_bwd_rel_hb":
        ws = torch.empty((3, b, h, q_len), dtype=torch.float32,
                         device=q.device)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), ebias.data_ptr(),
                g.data_ptr(), *outs, ws.data_ptr(), *tail)
        names = (("statistics + dQ + debias pass", "attn_bwd_rel_hb"),
                 ("dK/dV pass", "attn_bwd_rel_hb_dkdv"))
    else:
        ws = None
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), ebias.data_ptr(),
                o.data_ptr(), lse.data_ptr(), g.data_ptr(), *outs, *tail)
        names = (("dK/dV pass", "attn_bwd_rel_fs_dkdv"),
                 ("dQ + debias pass", "attn_bwd_rel_fs_dq"))
    keep = (dq, dk, dv, debias, ws)

    def launch(entry):
        return lambda: (keep, fa._launch(entry, *args, device=q.device))

    return {label: launch(entry) for label, entry in names}


def _time_passes(passes, label, e, card):
    """Each pass's ms (two rounds of three after a warm-up) into e
    ["passes_ms"], printed under ``label``."""
    for call in passes.values():
        _time_ms(call, 2)
    e["passes_ms"] = {n: float(np.mean([_time_ms(c, 3) for _ in range(2)]))
                      for n, c in passes.items()}
    print(f"{label} on {card}: " + ", ".join(
        f"{n} {v:.3f} ms" for n, v in e["passes_ms"].items()))


def relik_bwd_passes(fa, ins, seed, o, lse, g, rate, h=12, scale=0.125):
    """#24's three launches one at a time on the buffers its wrapper
    allocates (the workspace zeroed once, then summed into again: the
    values grow, the work does not): {pass: call}, for timing the passes
    apart. The calls go to the library directly, so no launch count
    moves."""
    import torch

    rw, r, k = ins[0], ins[2], ins[3]
    b, q_len, d = rw.shape
    p_len, k_len = r.shape[0], k.shape[1]
    drw, drr, dk, dv, ded, dr = (torch.empty_like(x) for x in (
        rw, ins[1], k, ins[4], ins[5], r))
    ws = torch.zeros((b, p_len, d), dtype=torch.float32, device=rw.device)
    args = (*(t.data_ptr() for t in ins), o.data_ptr(), lse.data_ptr(),
            g.data_ptr(), drw.data_ptr(), drr.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), ded.data_ptr(), ws.data_ptr(), b, q_len, k_len,
            p_len, h, d // h, float(scale), *fa._drop_args(rate, seed),
            0, 0, fa._DTYPE_CODES[rw.dtype])  # counter offsets (0, 0)
    keep = (drw, drr, dk, dv, ded, dr, ws)

    def launch(name, *a):
        return lambda: (keep, fa._launch(name, *a, device=rw.device))

    return {"dK/dV pass": launch("attn_bwd_relik_fs_dkdv", *args),
            "drw/drr/ded/dr pass": launch("attn_bwd_relik_fs_dq", *args),
            "dr sum over B": launch("attn_bwd_relik_fs_dr", ws.data_ptr(),
                                    dr.data_ptr(), b, p_len, d,
                                    fa._DTYPE_CODES[rw.dtype])}


def time_long_rel_kernels(rng, fa, card):
    """#14 and #15 at the stream path's S = 512, #23 and #24 at the driver's
    S = 1024, bf16 B=48: at rate 0 against the plain versions and the
    library calls (SDPA with the assembled ebias as a float mask; SDPA's
    autograd backward), at rate 0.1 against the plain versions; alternating
    rounds; #15's and #24's passes timed apart (``rel_bwd_passes``,
    ``relik_bwd_passes``). Returns {name: entry}."""
    import torch

    out = {}
    q, k, v, ebias, g = rel_case(rng, "bf16", TRAIN_BATCH, 512, 512)
    c, seed = relik_case(rng, "bf16", TRAIN_BATCH, 1024)
    ins = [c[n] for n in RELIK]
    for rate in (0.0, RATE):
        kw = dict(n_heads=12, scale=0.125, rate=rate)
        o23, lse = fa.attn_fwd_relik_fs_cuda(*ins, seed=seed, **kw)
        runs = {
            "attn_fwd_rel_hb": (
                lambda: fa.attn_fwd_rel_hb_cuda(q, k, v, ebias, seed=seed,
                                                **kw),
                lambda: fa.attn_fwd_rel_hb_reference(q, k, v, ebias,
                                                     seed=seed, **kw)),
            "attn_bwd_rel_hb": (
                lambda: fa.attn_bwd_rel_hb_cuda(q, k, v, ebias, seed, g,
                                                **kw),
                lambda: fa.attn_bwd_rel_hb_reference(q, k, v, ebias, seed, g,
                                                     **kw)),
            "attn_fwd_relik_fs": (
                lambda: fa.attn_fwd_relik_fs_cuda(*ins, seed=seed, **kw),
                lambda: fa.attn_fwd_relik_fs_reference(*ins, seed=seed,
                                                       **kw)),
            "attn_bwd_relik_fs": (
                lambda: fa.attn_bwd_relik_fs_cuda(*ins, seed, o23, lse,
                                                  c["g"], **kw),
                lambda: fa.attn_bwd_relik_fs_reference(*ins, seed, o23, lse,
                                                       c["g"], **kw))}
        for name, (run_kernel, run_plain) in runs.items():
            s = 512 if name.endswith("_hb") else 1024
            kt, pt = _alternate(run_plain, run_kernel, 3)
            kind = "fwd" if "_fwd_" in name else "bwd"
            bound = (rel_bound(kind, TRAIN_BATCH, s, s, 12, 64, 2, rate)
                     if s == 512 else relik_bound(kind, TRAIN_BATCH, s, 12,
                                                  64, 2))
            entry = {"ms": float(np.mean(kt)), "plain_ms": float(np.mean(pt)),
                     "bound_ms": bound[0], "bound_by": bound[1]}
            lib_note = ""
            if rate == 0.0:
                if s == 512:
                    lib = sdpa_rel_calls(q, k, v, ebias, g, 12, 0.125)
                else:   # the ebias the ingredients make, assembled
                    eb = assembled_ebias(c)
                    lib = sdpa_rel_calls(c["rw"], c["k"], c["v"], eb, c["g"],
                                         12, 0.125)
                    del eb
                call = lib[0] if kind == "fwd" else lib[1]
                _time_ms(call, 2)
                entry["library_ms"] = float(np.mean(
                    [_time_ms(call, 3) for _ in range(2)]))
                entry["library"] = (
                    "scaled_dot_product_attention, assembled ebias as float "
                    "mask" if kind == "fwd" else
                    "scaled_dot_product_attention autograd backward (dq, dk, "
                    "dv, debias), rate 0")
                lib_note = f", library {entry['library_ms']:.3f} ms"
                del lib, call
                out[name] = entry
            else:
                out[name]["modes"] = {
                    f"training rate {RATE}, bf16 B={TRAIN_BATCH} S={s}":
                        entry}
            print(f"{name} bf16 B={TRAIN_BATCH} S={s} H=12 Dh=64 rate {rate} "
                  f"on {card}: kernel {kt} ms, plain {pt} ms per call"
                  f"{lib_note}; bound {bound[0]:.4f} ms ({bound[1]})")
        for name, s, passes in (
                ("attn_bwd_rel_hb", 512, rel_bwd_passes(
                    fa, "attn_bwd_rel_hb", q, k, v, ebias, seed, g, rate)),
                ("attn_bwd_relik_fs", 1024, relik_bwd_passes(
                    fa, ins, seed, o23, lse, c["g"], rate))):
            e = out[name]
            _time_passes(passes, f"{name} passes bf16 B={TRAIN_BATCH} S={s} "
                         f"rate {rate}", e if rate == 0.0 else next(
                             iter(e["modes"].values())), card)
            del passes
        torch.cuda.empty_cache()
    return out


def xlnet_long_serving(args, rng, fa, card):
    """Phase 4e: ``Predictor.predict_split`` at xlnet-base-cased width,
    bf16, fused attention, over 256 seeded XLNet-packed examples at batch
    128, at S = 640 and 1024. Checks: #23 once per layer per batch and
    nothing else, finite predictions, and agreement with the same weights
    on einsum attention (run at batch 32: the einsum branch's [B, H, Q, P]
    fp32 bd at S = 1024 is 13 GB at batch 128). Returns {S: counts}."""
    from bert_multimodal_transformer_tpu_torch.config import (
        DatasetConfig,
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.serving import Predictor

    ds = DatasetConfig.mosi()
    cfg = XLNetConfig.xlnet_base_cased()
    mm = MultimodalConfig(injection_index=1)
    model = _xlnet(cfg, mm, "fused", args.seed + 30)
    predictor = Predictor(model, batch_size=BATCH)
    einsum = Predictor(_xlnet(cfg, mm, "einsum", 0, model.state_dict()),
                       batch_size=32)
    counts = {}
    for s in (640, 1024):
        split = make_xlnet_split(rng, LONG_SERVE_N, s, cfg.vocab_size,
                                 ds.visual_dim, ds.acoustic_dim)
        predictor.predict_split(split.take(np.arange(BATCH)))  # warm-up
        _zero_counts(fa)
        t0 = time.perf_counter()
        preds = predictor.predict_split(split)
        dt = time.perf_counter() - t0
        counts[s] = _counts(fa)
        want = _want(fa, attn_fwd_relik_fs=cfg.n_layer
                     * -(-LONG_SERVE_N // BATCH))
        print(f"kernel launches in XLNet predict_split at S={s}: "
              f"{counts[s]} (want {want})")
        if counts[s] != want:
            raise AssertionError(f"XLNet S={s} serving launches {counts[s]} "
                                 f"!= {want}")
        if preds.shape != (LONG_SERVE_N,) or not np.isfinite(preds).all():
            raise AssertionError(f"bad XLNet S={s} predictions "
                                 f"{preds.shape}")
        gap = float(np.abs(preds - einsum.predict_split(split)).max())
        print(f"xlnet-base-cased S={s} serving on {card}: predict_split "
              f"{LONG_SERVE_N / dt:.1f} examples/s (batch {BATCH}, bf16); "
              f"fused vs einsum predictions max |Δ| {gap:.3e} (tolerance "
              f"{PRED_ATOL}), |pred| max {np.abs(preds).max():.3f}")
        if not gap <= PRED_ATOL:
            raise AssertionError(f"XLNet S={s}: fused and einsum predictions "
                                 f"differ by {gap}")
    return counts


def xlnet_long_driver_path(args, rng, fa, card):
    """Phase 6d: ``driver.main --model xlnet-base-cased --attention_impl
    fused`` (bf16, one epoch over synthetic splits of 96/48/48) at
    ``--max_seq_length 512`` and ``1024``, and with ``--rel_bias_impl
    stream`` at 512. Checks: exit 0, finite losses, and the launches: under
    ``auto`` training takes #23 and #24 (three launches a call) and
    evaluation #11 at S=512 (K ≤ 512, no gradient) and #23 at 1024; under
    ``stream`` training takes #14 and #15 (two launches a call) and
    evaluation #11. Then the dropout-0 gradient checks (S=512 under auto
    with #24; under stream with #15, from a stream of its own) and the
    profiled steps (S=1024 auto, S=512 stream). Returns {path: counts}."""
    from bert_multimodal_transformer_tpu_torch.config import XLNetConfig

    layers = XLNetConfig.xlnet_base_cased().n_layer
    n_train = -(-LONG_SPLITS[0] // TRAIN_BATCH)
    n_eval = sum(-(-n // EVAL_BATCH) for n in LONG_SPLITS[1:])
    runs = {
        "xlnet_driver_s512": (512, [], dict(
            attn_fwd_relik_fs=layers * n_train,
            attn_bwd_relik_fs=3 * layers * n_train,
            attn_fwd_rel=layers * n_eval)),
        "xlnet_driver_s1024": (1024, [], dict(
            attn_fwd_relik_fs=layers * (n_train + n_eval),
            attn_bwd_relik_fs=3 * layers * n_train)),
        "xlnet_driver_stream_s512": (512, ["--rel_bias_impl", "stream"], dict(
            attn_fwd_rel_hb=layers * n_train,
            attn_bwd_rel_hb=2 * layers * n_train,
            attn_fwd_rel=layers * n_eval)),
    }
    counts = {}
    for path, (s, extra, launches) in runs.items():
        argv = ["--model", "xlnet-base-cased", "--dataset", "mosi",
                "--synthetic", "--synthetic_sizes", *map(str, LONG_SPLITS),
                "--n_epochs", "1", "--attention_impl", "fused",
                "--compute_dtype", "bfloat16", "--max_seq_length", str(s),
                "--seed", str(args.seed), *extra]
        counts[path] = run_driver(argv, fa, card)
        want = _want(fa, **launches)
        print(f"kernel launches in {path}: {counts[path]} (want {want}: "
              f"{n_train} train + {n_eval} dev/test batches, {layers} "
              "layers)")
        if counts[path] != want:
            raise AssertionError(f"{path} launches {counts[path]} != {want}")
    xlnet_grad_check(args, rng, fa, card, s=512, batch=XLNET_CHECK_BATCH,
                     impl="auto", bwd="attn_bwd_relik_fs", tag="#24",
                     launches=dict(attn_fwd_relik_fs=layers,
                                   attn_bwd_relik_fs=3 * layers),
                     seed_offset=31)
    xlnet_grad_check(args, np.random.default_rng([args.seed, 16]), fa, card,
                     s=512, batch=XLNET_CHECK_BATCH, impl="stream",
                     bwd="attn_bwd_rel_hb", tag="#15",
                     launches=dict(attn_fwd_rel_hb=layers,
                                   attn_bwd_rel_hb=2 * layers),
                     seed_offset=34, faults=((3, "debias"),))
    xlnet_long_step_profile(args, rng, card)
    xlnet_long_step_profile(args, rng, card, "stream", s=512)
    return counts


def xlnet_grad_check(args, rng, fa, card, *, s, batch, impl, bwd, tag,
                     launches, seed_offset, faults=((2, "dr"), (5, "ded"))):
    """At dropout 0, from one copy of the weights (seed ``args.seed +
    seed_offset``), one training step at S = ``s`` and ``batch`` under
    ``rel_bias_impl`` ``impl``, fused against einsum leaf by leaf within
    XLNET_GRAD_GAP_TOL, the fused step's kernel launches ``launches``;
    then the same step with each of ``faults`` (the part of the output of
    ``fa.<bwd>``, kernel ``tag``, and its name) zeroed, which must break it:
    dr, then ded (the position projection r, and seg_embed and r_s_bias,
    lose their score gradient), or debias (both). Phase 6d: S=512 under
    auto (#24) and under stream (#15, debias); 6f: S=50 under inkernel
    (#22)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        DatasetConfig,
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
        make_train_step,
    )

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(XLNetConfig.xlnet_base_cased(), dropout=0.0,
                              summary_last_dropout=0.0, rel_bias_impl=impl)
    mm = MultimodalConfig(injection_index=1, dropout_prob=0.0)
    weights = _xlnet(cfg, mm, "fused", args.seed + seed_offset).state_dict()
    data = _device_batch(make_xlnet_split(
        rng, batch, s, cfg.vocab_size, ds.visual_dim,
        ds.acoustic_dim).as_tuple())
    step = make_train_step()

    def one_step(attention_impl):
        m = _xlnet(cfg, mm, attention_impl, 0, weights)
        st = Trainer(model=m, tx=make_optimizer(1e-5, 10, 0.1)
                     ).create_state_from_params(None, args.seed)
        _zero_counts(fa)
        step(st, data)
        return _grad_pieces(m), _counts(fa)

    grads = {"einsum": one_step("einsum")[0]}
    grads["fused"], got = one_step("fused")
    want = _want(fa, **launches)
    if got != want:
        raise AssertionError(f"S={s} {impl} check step launches {got} != "
                             f"{want}")
    real = getattr(fa, bwd)
    parts = [part for part, _ in faults]
    faults = [f"planted fault: {what} zeroed in {tag}" for _, what in faults]
    for name, part in zip(faults, parts):
        def faulty(*a, _part=part, **kw):
            out = list(real(*a, **kw))
            out[_part] = torch.zeros_like(out[_part])
            return tuple(out)

        setattr(fa, bwd, faulty)
        try:
            grads[name] = one_step("fused")[0]
        finally:
            setattr(fa, bwd, real)
    for name in ("fused", *faults):
        gaps = _grad_gaps(grads[name], grads["einsum"])
        print(f"  XLNet S={s} B={batch} {impl} step-1 gradients, {name} vs "
              f"einsum: worst pieces " + ", ".join(
                  f"{k_} {v_:.3e}" for k_, v_ in gaps[:4])
              + f" (bound {XLNET_GRAD_GAP_TOL})")
        fails = gaps[0][1] > XLNET_GRAD_GAP_TOL
        if fails != name.startswith("planted"):
            raise AssertionError(f"XLNet S={s} {impl} step-1 gradients, "
                                 f"{name}: worst gap {gaps[0]} against "
                                 f"{XLNET_GRAD_GAP_TOL}")


def xlnet_long_step_profile(args, rng, card, impl="auto", s=1024,
                            batch=TRAIN_BATCH):
    """One training step of xlnet-base-cased at ``batch`` (the driver's 48),
    bf16, fused attention, dropout 0.1, at S = ``s`` (1024: #23, #24 under
    ``rel_bias_impl`` ``impl`` "auto"; #16, #17 and the ebias assembly
    under "stream"; at S = 50 #11/#13 and the assembly under "auto", #20/#22
    under "inkernel"): its device time by kernel group and the card's busy
    share (torch.profiler), after one warm-up step. Returns the profile."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        DatasetConfig,
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
        make_train_step,
    )
    from bert_multimodal_transformer_tpu_torch.utils.profiling import (
        device_time_by_kernel,
    )

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(XLNetConfig.xlnet_base_cased(),
                              rel_bias_impl=impl)
    state = Trainer(model=_xlnet(cfg, MultimodalConfig(injection_index=1),
                                 "fused", args.seed + 32),
                    tx=make_optimizer(1e-5, 10, 0.1)
                    ).create_state_from_params(None, args.seed)
    step = make_train_step()
    data = _device_batch(make_xlnet_split(
        rng, batch, s, cfg.vocab_size, ds.visual_dim,
        ds.acoustic_dim).as_tuple())
    step(state, data)
    torch.cuda.synchronize()
    print(f"one training step, bf16 xlnet-base-cased B={batch} S={s} "
          f"rel_bias_impl={impl} on {card}:")
    prof = device_time_by_kernel(lambda: step(state, data), 1)
    _print_profile(prof, 1, "step")
    return prof


# The rel flash-streamed tier's checks (3g): (dtype, B, Q, K) with rates.
REL_FS_CASES = (("fp32", 2, 70, 131), ("bf16", 2, 1024, 1024),
                ("bf16", 2, 512, 1024))
# The edges of bf16 #16's tensor-core plan, (B, Q, K, H, Dh), each with a
# 64-key block and a query row masked whole: K ragged off 8 (the ebias by
# plain loads), the 50-row memory (K = 562), the widest head ragged off 64,
# a zero-padded k-depth.
REL_FS_EDGES = ((2, 70, 131, 3, 64), (2, 512, 562, 12, 64),
                (2, 136, 200, 2, 128), (2, 256, 320, 3, 40))
MEM_LEN = 512                 # the long-memory driver runs: K = 512 + 512
XLNET_FS_CHECK_BATCH = 4      # the S=1024 stream gradient check's batch


def check_rel_fs_kernels(rng, fa, dtype_name, b, q_len, k_len, rate, h=12,
                         dh=64, masked=False):
    """Phase 3g on one case: #16 (out and lse) and #17 (dq, dk, dv, debias)
    against their plain versions on the ebias the model assembles (K > Q:
    the memory's keys first); with ``masked`` also keys 64 .. 127 of batch
    row 0 (a key block masked whole) and query row 3 of batch row 1, head
    0 (a row masked whole, which comes out uniform) at −1e30. lse to 1e-4
    absolute plus 1e-6 relative; #17 within ``rel_fs_grads_bf16_bound``
    (fp32: GRAD_FP32_TOL); where K ≤ HB_MAX_SEQ_LEN #15 on the same case
    within ``rel_grads_bf16_bound``; the same bits from the same seed
    twice. Returns the max errors."""
    import torch

    kw = dict(n_heads=h, scale=dh ** -0.5, rate=rate)
    tag = (f"{dtype_name} B={b} Q={q_len} K={k_len} H={h} Dh={dh} "
           f"rate={rate}" + (", masked block and row" if masked else ""))
    q, k, v, ebias, g = rel_case(rng, dtype_name, b, q_len, k_len, h, dh)
    if masked:
        ebias[0, :, :, 64:128] = -1e30
        ebias[1, 0, 3, :] = -1e30
    seed = int(rng.integers(0, 2 ** 63 - 1))
    out, lse = fa.attn_fwd_rel_fs_cuda(q, k, v, ebias, seed=seed, **kw)
    r_out, r_lse = fa.attn_fwd_rel_fs_reference(q, k, v, ebias, seed=seed,
                                                **kw)
    errs = {"#16": _forward_err(f"#16 {tag}", out, r_out, dtype_name)}
    lse_err = (lse - r_lse).abs()
    if bool((lse_err > 1e-4 + 1e-6 * r_lse.abs()).any()):
        raise AssertionError(f"#16 lse {tag}: max_abs_err "
                             f"{float(lse_err.max())}")
    errs["#16 lse"] = float(lse_err.max())
    grads = fa.attn_bwd_rel_fs_cuda(q, k, v, ebias, seed, out, lse, g, **kw)
    want = fa.attn_bwd_rel_fs_reference(q, k, v, ebias, seed, out, lse, g,
                                        **kw)
    if dtype_name == "bf16":
        bounds = fa.rel_fs_grads_bf16_bound(want, q, k, v, ebias, seed, out,
                                            lse, g, **kw)
    else:
        bounds = [GRAD_FP32_TOL + GRAD_FP32_TOL * w.float().abs()
                  for w in want]
    worst = 0.0
    for part, a, w, bd in zip(("dq", "dk", "dv", "debias"), grads, want,
                              bounds):
        err = (a.float() - w.float()).abs()
        if bool((err > bd).any()) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"#17 {part} {tag}: {int((err > bd).sum())}"
                                 f" elements out of rel_fs_grads_bf16_bound,"
                                 f" max_abs_err={float(err.max())}")
        worst = max(worst, float(err.max()))
    errs["#17"] = worst
    del want, bounds
    again16 = fa.attn_fwd_rel_fs_cuda(q, k, v, ebias, seed=seed, **kw)
    again17 = fa.attn_bwd_rel_fs_cuda(q, k, v, ebias, seed, out, lse, g,
                                      **kw)
    same = (torch.equal(again16[0], out) and torch.equal(again16[1], lse)
            and all(torch.equal(x, y) for x, y in zip(grads, again17)))
    if k_len <= fa.HB_MAX_SEQ_LEN:
        g15 = fa.attn_bwd_rel_hb_cuda(q, k, v, ebias, seed, g, **kw)
        _, p, pd = fa.attn_fwd_rel_reference(q, k, v, ebias, seed=seed,
                                             save=True, **kw)
        errs["#15"] = _rel_grad_errs(tag, dtype_name, (
            ("#15 vs plain", g15, fa.attn_bwd_rel_hb_reference(
                q, k, v, ebias, seed, g, **kw)),), (
            p, pd, q, k, v, g, dict(n_heads=h, scale=kw["scale"])),
            fa)["#15 vs plain"]
        del p, pd
        same = same and all(torch.equal(x, y) for x, y in zip(
            g15, fa.attn_bwd_rel_hb_cuda(q, k, v, ebias, seed, g, **kw)))
    print(f"rel fs kernels vs plain {tag}: " + ", ".join(
        f"{k_} {v_:.3e}" for k_, v_ in errs.items())
        + f"; same seed twice, identical bits {same}")
    if not same:
        raise AssertionError(f"#15-#17 not bit-reproducible ({tag})")
    return errs


def check_rel_fs_against_hb(rng, fa):
    """#16 against #14 where both reach, Q = K = 512, bf16, rate 0.1, one
    seed: (1) the keep masks: with q = 0 and a zero bias every score is 0
    and p = 1/K; with head h's v the identity on the keys 128·((h + r) % 4)
    .. +127 (H = 4, Dh = 128), out[q, h, c] > 0 exactly where that key is
    kept, so four rotations r read every (b, h, q, k) of both kernels'
    masks, which must equal each other and the plain Philox mask bit for
    bit; (2) the outputs on a model-like case, within ``_tier_err``'s bound
    (#14 rounds p = e/l before PV, #16 rounds e and divides after)."""
    import torch

    b, s, h, dh = 2, 512, 4, 128
    seed = int(rng.integers(0, 2 ** 63 - 1))
    q = torch.zeros(b, s, h * dh, device="cuda", dtype=torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((b, s, h * dh),
                                             dtype=np.float32)).to(
        "cuda", torch.bfloat16)
    eb = torch.zeros(b, h, s, s, device="cuda", dtype=torch.bfloat16)
    kw = dict(n_heads=h, scale=dh ** -0.5, rate=RATE, seed=seed)
    keep = fa.dropout_keep_mask(seed, b, h, s, s, RATE, "cuda")
    seen = {"#16": torch.zeros_like(keep), "#14": torch.zeros_like(keep)}
    eye = torch.eye(dh, device="cuda", dtype=torch.bfloat16)
    for r in range(4):
        v = torch.zeros(b, s, h, dh, device="cuda", dtype=torch.bfloat16)
        for hh in range(h):
            w = (hh + r) % 4
            v[:, w * dh:(w + 1) * dh, hh, :] = eye
        v = v.reshape(b, s, h * dh)
        outs = {"#16": fa.attn_fwd_rel_fs_cuda(q, k, v, eb, **kw)[0],
                "#14": fa.attn_fwd_rel_hb_cuda(q, k, v, eb, **kw)}
        for name, out in outs.items():
            kept = out.view(b, s, h, dh).permute(0, 2, 1, 3) > 0
            for hh in range(h):
                w = (hh + r) % 4
                seen[name][:, hh, :, w * dh:(w + 1) * dh] = kept[:, hh]
    for name, kept in seen.items():
        if not torch.equal(kept, keep):
            raise AssertionError(f"{name} keep mask differs from the plain "
                                 f"Philox mask in "
                                 f"{int((kept != keep).sum())} elements")
    q, k, v, ebias, _ = rel_case(rng, "bf16", 8, s, s)
    kw = dict(n_heads=12, scale=0.125, rate=RATE, seed=seed)
    out16 = fa.attn_fwd_rel_fs_cuda(q, k, v, ebias, **kw)[0]
    out14 = fa.attn_fwd_rel_hb_cuda(q, k, v, ebias, **kw)
    _, _, pd = fa.attn_fwd_rel_reference(q, k, v, ebias, save=True, **kw)
    err = (out16.float() - out14.float()).abs()
    vh = v.view(8, s, 12, 64).permute(0, 2, 1, 3).float().abs()
    spread = torch.matmul(pd.float().abs(), vh).permute(0, 2, 1, 3).reshape(
        8, s, -1)
    bound = 2.0 ** -7 * (out14.float().abs() + spread) + 2.0 ** -17
    if bool((err > bound).any()):
        raise AssertionError(f"#16 vs #14 bf16 B=8 Q=K={s}: "
                             f"{int((err > bound).sum())} elements out of "
                             f"the bound, max |Δ| {float(err.max())}")
    print(f"#16 and #14 keep masks = plain Philox mask bit for bit over "
          f"{keep.numel()} elements (bf16 B={b} Q=K={s} H={h} Dh={dh}, rate "
          f"{RATE}); #16 vs #14 output bf16 B=8 Q=K={s} H=12 rate {RATE}: "
          f"max |Δ| {float(err.max()):.3e} within 2^-7·(|out| + pd·|v|)")


def check_rel_bwd_masks(rng, fa):
    """#15's and #17's keep masks (their dK/dV passes') against the plain
    Philox mask, bit for bit: with q = k = 0 and a zero ebias every score is
    0 and p = 1/K, and with g_h the identity (Q = Dh = 128) dV[k, h, c] =
    Σ_q pd(q, k)·g[q, h, c] = pd(c, k) is > 0 exactly where (b, h, c, k) is
    kept. bf16 B=2 Q=128 K=200 (ragged, K ≠ Q) H=3 Dh=128 at rate 0.1; the
    keep rate within 5σ of 0.9."""
    import torch

    b, q_len, k_len, h, dh = 2, 128, 200, 3, 128
    seed = int(rng.integers(0, 2 ** 63 - 1))
    q = torch.zeros(b, q_len, h * dh, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(b, k_len, h * dh, device="cuda", dtype=torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((b, k_len, h * dh),
                                             dtype=np.float32)).to(
        "cuda", torch.bfloat16)
    eb = torch.zeros(b, h, q_len, k_len, device="cuda", dtype=torch.bfloat16)
    g = torch.eye(dh, device="cuda", dtype=torch.bfloat16)[
        None, :, None, :].expand(b, q_len, h, dh).reshape(
        b, q_len, h * dh).contiguous()
    kw = dict(n_heads=h, scale=dh ** -0.5, rate=RATE)
    keep = fa.dropout_keep_mask(seed, b, h, q_len, k_len, RATE, "cuda")
    out, lse = fa.attn_fwd_rel_fs_cuda(q, k, v, eb, seed=seed, **kw)
    for name, grads in (
            ("#15's dV", fa.attn_bwd_rel_hb_cuda(q, k, v, eb, seed, g, **kw)),
            ("#17's dV", fa.attn_bwd_rel_fs_cuda(q, k, v, eb, seed, out, lse,
                                                 g, **kw))):
        kernel_keep = grads[2].view(b, k_len, h, dh).permute(0, 2, 3, 1) > 0
        if not torch.equal(kernel_keep, keep):
            raise AssertionError(f"{name} keep mask differs from the plain "
                                 f"Philox mask in "
                                 f"{int((kernel_keep != keep).sum())} "
                                 "elements")
        got = float(kernel_keep.double().mean())
        sigma = math.sqrt(RATE * (1 - RATE) / keep.numel())
        if abs(got - (1 - RATE)) >= 5 * sigma:
            raise AssertionError(f"{name} keep rate {got} not within 5σ")
        print(f"{name} keep mask = plain Philox mask bit for bit over "
              f"{keep.numel()} elements (bf16 B={b} Q={q_len} K={k_len} "
              f"H={h} Dh={dh}), keep rate {got:.6f} (5σ={5 * sigma:.1e})")


def rel_fs_bound(kind, b, q_len, k_len, h, dh, itemsize):
    """The bound of #16 (``fwd``) or #17 at [B, Q, K, H, Dh]: each input
    read once and each output written once (q, k, v, ebias; out and the
    fp32 lse; #17 also o, lse and g, and writes dq, dk, dv and debias); the
    products on the bf16 tensor cores, 2·B·H·Q·K·Dh operations each (QKᵀ
    and PV forward; QKᵀ, d(pd), dV, dQ and dK backward)."""
    d = h * dh
    qd, kd = b * q_len * d * itemsize, b * k_len * d * itemsize
    hqk, lse = b * h * q_len * k_len * itemsize, b * h * q_len * 4
    dot = 2 * b * h * q_len * k_len * dh
    if kind == "fwd":
        return _bound(qd + 2 * kd + hqk + qd + lse, 2 * dot, BF16_FLOPS)
    return _bound(3 * qd + 2 * kd + hqk + lse + qd + 2 * kd + hqk, 5 * dot,
                  BF16_FLOPS)


def time_rel_fs_kernels(rng, fa, card):
    """#16 and #17 at the stream path's S = 1024, bf16 B=48 (the driver's
    batch), rate 0 against the plain versions and the library calls (SDPA
    with the ebias as a float mask; SDPA's autograd backward to q, k, v and
    the ebias), rate 0.1 against the plain versions; CUDA events over
    alternating rounds; #17's two launches timed apart (``rel_bwd_passes``).
    Returns {name: entry}."""
    import torch

    s = 1024
    q, k, v, ebias, g = rel_case(rng, "bf16", TRAIN_BATCH, s, s)
    seed = int(rng.integers(0, 2 ** 63 - 1))
    out = {}
    for rate in (0.0, RATE):
        kw = dict(n_heads=12, scale=0.125, rate=rate)
        o16, lse = fa.attn_fwd_rel_fs_cuda(q, k, v, ebias, seed=seed, **kw)
        runs = {
            "attn_fwd_rel_fs": (
                lambda: fa.attn_fwd_rel_fs_cuda(q, k, v, ebias, seed=seed,
                                                **kw),
                lambda: fa.attn_fwd_rel_fs_reference(q, k, v, ebias,
                                                     seed=seed, **kw)),
            "attn_bwd_rel_fs": (
                lambda: fa.attn_bwd_rel_fs_cuda(q, k, v, ebias, seed, o16,
                                                lse, g, **kw),
                lambda: fa.attn_bwd_rel_fs_reference(q, k, v, ebias, seed,
                                                     o16, lse, g, **kw))}
        for name, (run_kernel, run_plain) in runs.items():
            kt, pt = _alternate(run_plain, run_kernel, 3)
            kind = "fwd" if "_fwd_" in name else "bwd"
            bound = rel_fs_bound(kind, TRAIN_BATCH, s, s, 12, 64, 2)
            entry = {"ms": float(np.mean(kt)), "plain_ms": float(np.mean(pt)),
                     "bound_ms": bound[0], "bound_by": bound[1]}
            lib_note = ""
            if rate == 0.0:
                lib = sdpa_rel_calls(q, k, v, ebias, g, 12, 0.125)
                call = lib[0] if kind == "fwd" else lib[1]
                _time_ms(call, 2)
                entry["library_ms"] = float(np.mean(
                    [_time_ms(call, 3) for _ in range(2)]))
                entry["library"] = (
                    "scaled_dot_product_attention, ebias as float mask"
                    if kind == "fwd" else
                    "scaled_dot_product_attention autograd backward (dq, dk, "
                    "dv, debias), rate 0")
                lib_note = f", library {entry['library_ms']:.3f} ms"
                del lib, call
                out[name] = entry
            else:
                out[name]["modes"] = {
                    f"training rate {RATE}, bf16 B={TRAIN_BATCH} Q=K={s}":
                        entry}
            print(f"{name} bf16 B={TRAIN_BATCH} Q=K={s} H=12 Dh=64 rate "
                  f"{rate} on {card}: kernel {kt} ms, plain {pt} ms per call"
                  f"{lib_note}; bound {bound[0]:.4f} ms ({bound[1]})")
        e = out["attn_bwd_rel_fs"]
        _time_passes(rel_bwd_passes(fa, "attn_bwd_rel_fs", q, k, v, ebias,
                                    seed, g, rate, o16, lse),
                     f"attn_bwd_rel_fs passes bf16 B={TRAIN_BATCH} Q=K={s} "
                     f"rate {rate}", e if rate == 0.0 else next(
                         iter(e["modes"].values())), card)
        torch.cuda.empty_cache()
    return out


def xlnet_fs_serving(args, rng, fa, card):
    """Phase 4f: ``Predictor.predict_split`` at xlnet-base-cased width,
    bf16, fused, over 256 seeded XLNet-packed examples at batch 128:
    ``rel_bias_impl="stream"`` at S = 1024 (#16 once per layer per batch),
    against einsum at batch 32; and ``Predictor(mem_len=512)`` at S = 512
    under "stream" (Q = 512, K = 1024: #16), the memory chained through the
    batches, against the einsum model's chain at the same batch. Checks:
    the launches, finite predictions, agreement within PRED_ATOL. Returns
    {path: counts}."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        DatasetConfig,
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.serving import Predictor

    ds = DatasetConfig.mosi()
    mm = MultimodalConfig(injection_index=1)
    counts = {}
    for path, s, mem_len, einsum_batch in (
            ("xlnet_serving_stream_s1024", 1024, None, 32),
            ("xlnet_serving_mem512", 512, MEM_LEN, BATCH)):
        cfg = dataclasses.replace(XLNetConfig.xlnet_base_cased(),
                                  rel_bias_impl="stream", mem_len=mem_len)
        model = _xlnet(cfg, mm, "fused", args.seed + 40)
        predictor = Predictor(model, batch_size=BATCH, mem_len=mem_len)
        split = make_xlnet_split(rng, LONG_SERVE_N, s, cfg.vocab_size,
                                 ds.visual_dim, ds.acoustic_dim)
        predictor.predict_split(split.take(np.arange(BATCH)))  # warm-up
        torch.cuda.synchronize()
        _zero_counts(fa)
        t0 = time.perf_counter()
        preds = predictor.predict_split(split)
        dt = time.perf_counter() - t0
        counts[path] = _counts(fa)
        want = _want(fa, attn_fwd_rel_fs=cfg.n_layer
                     * -(-LONG_SERVE_N // BATCH))
        print(f"kernel launches in {path}: {counts[path]} (want {want})")
        if counts[path] != want:
            raise AssertionError(f"{path} launches {counts[path]} != "
                                 f"{want}")
        if preds.shape != (LONG_SERVE_N,) or not np.isfinite(preds).all():
            raise AssertionError(f"bad {path} predictions {preds.shape}")
        einsum = Predictor(_xlnet(cfg, mm, "einsum", 0, model.state_dict()),
                           batch_size=einsum_batch, mem_len=mem_len)
        gap = float(np.abs(preds - einsum.predict_split(split)).max())
        del einsum
        torch.cuda.empty_cache()
        print(f"{path} (xlnet-base-cased S={s}, mem_len {mem_len}, stream) "
              f"on {card}: predict_split {LONG_SERVE_N / dt:.1f} examples/s "
              f"(batch {BATCH}, bf16); fused vs einsum (batch "
              f"{einsum_batch}) max |Δ| {gap:.3e} (tolerance {PRED_ATOL}), "
              f"|pred| max {np.abs(preds).max():.3f}")
        if not gap <= PRED_ATOL:
            raise AssertionError(f"{path}: fused and einsum predictions "
                                 f"differ by {gap}")
        del predictor, model
        torch.cuda.empty_cache()
    return counts


def xlnet_fs_driver_path(args, rng, fa, card):
    """Phase 6e: ``driver.main --model xlnet-base-cased --attention_impl
    fused`` (bf16, one epoch over synthetic splits of 96/48/48) with
    ``--rel_bias_impl stream --max_seq_length 1024`` (training #16 and #17,
    two launches a call; evaluation #16), ``--mem_len 512 --max_seq_length
    512`` under "stream" (Q = 512, K = 1024: the same kernels) and under
    "auto" (#23, and #24 in three launches, at K ≠ Q), and ``--mem_len 50``
    at S = 50 (K = 100: #11 with saved probs, #13). Checks: exit 0, finite
    losses, the launches; prints each run's peak device memory. Then the
    S = 1024 stream gradient check and one profiled B=48 S=1024 stream
    step. Returns {path: counts}."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import XLNetConfig

    layers = XLNetConfig.xlnet_base_cased().n_layer
    n_train = -(-LONG_SPLITS[0] // TRAIN_BATCH)
    n_eval = sum(-(-n // EVAL_BATCH) for n in LONG_SPLITS[1:])
    fs = dict(attn_fwd_rel_fs=layers * (n_train + n_eval),
              attn_bwd_rel_fs=2 * layers * n_train)
    runs = {
        "xlnet_driver_stream_s1024": (
            ["--max_seq_length", "1024", "--rel_bias_impl", "stream"], fs),
        "xlnet_driver_mem512_stream": (
            ["--max_seq_length", "512", "--mem_len", str(MEM_LEN),
             "--rel_bias_impl", "stream"], fs),
        "xlnet_driver_mem512": (
            ["--max_seq_length", "512", "--mem_len", str(MEM_LEN)], dict(
                attn_fwd_relik_fs=layers * (n_train + n_eval),
                attn_bwd_relik_fs=3 * layers * n_train)),
        "xlnet_driver_mem50": (
            ["--mem_len", "50"], dict(
                attn_fwd_rel=layers * (n_train + n_eval),
                attn_bwd_rel_saved=layers * n_train)),
    }
    counts = {}
    for path, (extra, launches) in runs.items():
        argv = ["--model", "xlnet-base-cased", "--dataset", "mosi",
                "--synthetic", "--synthetic_sizes", *map(str, LONG_SPLITS),
                "--n_epochs", "1", "--attention_impl", "fused",
                "--compute_dtype", "bfloat16", "--seed", str(args.seed),
                *extra]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counts[path] = run_driver(argv, fa, card)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = _want(fa, **launches)
        print(f"kernel launches in {path}: {counts[path]} (want {want}: "
              f"{n_train} train + {n_eval} dev/test batches, {layers} "
              f"layers); peak device memory {peak:.2f} GiB "
              "(torch.cuda.max_memory_allocated)")
        if counts[path] != want:
            raise AssertionError(f"{path} launches {counts[path]} != {want}")
    xlnet_fs_grad_check(args, rng, fa, card)
    xlnet_long_step_profile(args, rng, card, "stream")
    return counts


def xlnet_fs_grad_check(args, rng, fa, card):
    """Phase 6e: at dropout 0, from one copy of the weights, one training
    step at S = 1024, batch XLNET_FS_CHECK_BATCH, ``rel_bias_impl=
    "stream"``: fused (#16/#17) against einsum leaf by leaf within
    XLNET_GRAD_GAP_TOL; then the same step with debias zeroed in #17's
    output, which must break it (r, r_r_bias, seg_embed and r_s_bias lose
    their score gradient)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        DatasetConfig,
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
        make_train_step,
    )

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(XLNetConfig.xlnet_base_cased(), dropout=0.0,
                              summary_last_dropout=0.0,
                              rel_bias_impl="stream")
    mm = MultimodalConfig(injection_index=1, dropout_prob=0.0)
    weights = _xlnet(cfg, mm, "fused", args.seed + 41).state_dict()
    batch = _device_batch(make_xlnet_split(
        rng, XLNET_FS_CHECK_BATCH, 1024, cfg.vocab_size, ds.visual_dim,
        ds.acoustic_dim).as_tuple())
    step = make_train_step()

    def one_step(impl):
        m = _xlnet(cfg, mm, impl, 0, weights)
        st = Trainer(model=m, tx=make_optimizer(1e-5, 10, 0.1)
                     ).create_state_from_params(None, args.seed)
        _zero_counts(fa)
        step(st, batch)
        return _grad_pieces(m), _counts(fa)

    grads = {"einsum": one_step("einsum")[0]}
    torch.cuda.empty_cache()
    grads["fused"], launches = one_step("fused")
    want = _want(fa, attn_fwd_rel_fs=cfg.n_layer,
                 attn_bwd_rel_fs=2 * cfg.n_layer)
    if launches != want:
        raise AssertionError(f"S=1024 stream check step launches {launches} "
                             f"!= {want}")
    real = fa.attn_bwd_rel_fs
    fault = "planted fault: debias zeroed in #17"

    def faulty(*a, **kw):
        dq, dk, dv, debias = real(*a, **kw)
        return dq, dk, dv, torch.zeros_like(debias)

    fa.attn_bwd_rel_fs = faulty
    try:
        grads[fault] = one_step("fused")[0]
    finally:
        fa.attn_bwd_rel_fs = real
    for name in ("fused", fault):
        gaps = _grad_gaps(grads[name], grads["einsum"])
        print(f"  XLNet S=1024 stream B={XLNET_FS_CHECK_BATCH} step-1 "
              f"gradients, {name} vs einsum: worst pieces " + ", ".join(
                  f"{k_} {v_:.3e}" for k_, v_ in gaps[:4])
              + f" (bound {XLNET_GRAD_GAP_TOL})")
        fails = gaps[0][1] > XLNET_GRAD_GAP_TOL
        if fails != name.startswith("planted"):
            raise AssertionError(f"XLNet S=1024 stream step-1 gradients, "
                                 f"{name}: worst gap {gaps[0]} against "
                                 f"{XLNET_GRAD_GAP_TOL}")


# ---- MAG-XLNet under rel_bias_impl="inkernel": the full-H ingredients
# kernels #20 (forward), #22 (saved-probs backward) and #21 (recompute) --

RELIK_FULL_CASES = (   # (dtype, B, Q, K) with the rates each runs at
    ("bf16", BENCH_BATCH, S_SERVE, S_SERVE, (RATE, 0.0)),
    ("bf16", TRAIN_BATCH, S_SERVE, 2 * S_SERVE, (RATE,)),   # --mem_len 50
    ("fp32", 4, S_SERVE, 77, (RATE, 0.0)))                  # ragged K ≠ Q
# bf16 #20's, #21's and #22's tensor-core plans at their edges, (B, Q, K,
# H, Dh) at rates 0.1 and 0: K odd, the register plan's last K and the
# score tile's first, two q tiles, the widest head in both forward plans (at
# K = 100 with Q = 40, inside #21's reach), the edges of #21's reach (Q = K
# = 95; Q = 1 at K = 435); then the memory's K = 100 at Dh = 64 and two
# query chunks (Q = 1000 at K = 8, Dh = 8).
RELIK_TC_EDGES = ((8, S_SERVE, 57, 12, 64), (8, S_SERVE, 64, 12, 64),
                  (8, S_SERVE, 65, 12, 64), (8, 77, 77, 12, 64),
                  (8, S_SERVE, S_SERVE, 6, 128),
                  (8, 40, 2 * S_SERVE, 6, 128), (8, 95, 95, 12, 64),
                  (8, 1, 435, 12, 64), (8, S_SERVE, 2 * S_SERVE, 12, 64),
                  (2, 1000, 8, 2, 8))


def relik_full_bound(kind, b, q_len, k_len, h, dh, itemsize, rate=0.0,
                     save=False):
    """The bound of #20 (``fwd``), #22 (``bwd_saved``) or #21 (``bwd``) at
    [B, Q, K, H, Dh], P = Q + K: each input read once and each output
    written once (rw, rr, g, out, drw, drr [B,Q,D]; k, v, dk, dv [B,K,D];
    r [P,D], dr fp32; ed, ded [B,H,Q]; segd, maskb [B,Q,K]; p, pd
    [B,H,Q,K]); the products on the bf16 tensor cores, 2·B·H·Q·K·Dh
    operations each (ac, bd and PV forward; d(pd), dV, drw, dK, drr and dr
    backward, plus ac and bd again for the recompute). The dr workspace is
    the kernel's own and is not counted."""
    d = h * dh
    qd, kd = b * q_len * d * itemsize, b * k_len * d * itemsize
    r_, hq = (q_len + k_len) * d * itemsize, b * h * q_len * itemsize
    qk = b * q_len * k_len * itemsize
    probs = b * h * q_len * k_len * itemsize * (2 if rate > 0 else 1)
    dot = 2 * b * h * q_len * k_len * dh
    grads = 2 * qd + 2 * kd + hq + (q_len + k_len) * d * 4
    if kind == "fwd":
        return _bound(2 * qd + 2 * kd + r_ + hq + 2 * qk + qd
                      + (probs if save else 0), 3 * dot, BF16_FLOPS)
    if kind == "bwd_saved":
        return _bound(probs + 3 * qd + 2 * kd + r_ + qk + grads, 6 * dot,
                      BF16_FLOPS)
    return _bound(3 * qd + 2 * kd + r_ + hq + 2 * qk + grads, 8 * dot,
                  BF16_FLOPS)


def check_relik_full_kernels(rng, fa, dtype_name, b, q_len, k_len, rate,
                             h=12, dh=64):
    """Phase 3h on one case: #20 with save (and dropout at rate > 0), #22
    and #21, each against its plain version (fp32: GRAD_FP32_TOL; bf16:
    ``relik_full_grads_bf16_bound``), the two backwards against each other;
    #20's keep mask against the plain Philox mask; the same bits twice (dr
    summed over B in a fixed order). Returns the max errors, whether each
    kernel gave its plain version's bits, and the case."""
    import torch

    c, seed = relik_case(rng, dtype_name, b, q_len, h, dh, k_len=k_len)
    ins = [c[n] for n in RELIK]
    kw = dict(n_heads=h, scale=1.0 / dh ** 0.5)
    tag = (f"{dtype_name} B={b} Q={q_len} K={k_len} P={q_len + k_len} H={h} "
           f"Dh={dh} rate={rate}")
    out, p, pd = fa.attn_fwd_relik_cuda(*ins, rate=rate, seed=seed,
                                        save=True, **kw)
    want = fa.attn_fwd_relik_reference(*ins, rate=rate, seed=seed, save=True,
                                       **kw)
    errs = {"#20": max(_forward_err(f"#20 {n} {tag}", x, w, dtype_name)
                       for n, x, w in zip(("out", "p", "pd"), (out, p, pd),
                                          want))}
    same = {"#20": all(torch.equal(x, w) for x, w in zip((out, p, pd),
                                                         want))}
    print(f"#20 vs plain {tag}: out/p/pd max_abs_err={errs['#20']:.3e}, "
          f"identical bits {same['#20']}"
          + _check_keep(fa, "#20", seed, p, pd, rate, tag))
    saved_in = (p, pd, *ins[:5], c["segd"], c["g"])
    runs = {"#22": lambda: fa.attn_bwd_relik_saved_cuda(*saved_in, **kw),
            "#21": lambda: fa.attn_bwd_relik_cuda(*ins, seed, c["g"],
                                                  rate=rate, **kw)}
    got = {name: run() for name, run in runs.items()}
    plain = {"#22": fa.attn_bwd_relik_saved_reference(*saved_in, **kw),
             "#21": fa.attn_bwd_relik_reference(*ins, seed, c["g"],
                                                rate=rate, **kw)}
    bound_args = (fa.relik_full_grads_bf16_bound,
                  (p, pd, *ins[:5], c["segd"], c["g"]), kw)
    for name in runs:
        errs[name] = _relik_grad_errs(f"{name} vs plain {tag}", dtype_name,
                                      got[name], plain[name], bound_args, fa)
        same[name] = all(torch.equal(x, w)
                         for x, w in zip(got[name], plain[name]))
    errs["#21 vs #22"] = _relik_grad_errs(f"#21 vs #22 {tag}", dtype_name,
                                          got["#21"], got["#22"], bound_args,
                                          fa)
    twice = [("#20", (out, p, pd), lambda: fa.attn_fwd_relik_cuda(
        *ins, rate=rate, seed=seed, save=True, **kw))]
    twice += [(name, got[name], run) for name, run in runs.items()]
    differ = [name for name, first, again in twice
              if not all(torch.equal(x, y) for x, y in zip(first, again()))]
    print(f"relik full-H backward {tag} (drw, drr, dr, dk, dv, ded): "
          + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in errs.items()
                      if k_ != "#20")
          + f"; identical to plain: #22 {same['#22']}, #21 {same['#21']}; "
          f"same seed twice, identical bits {not differ}")
    if differ:
        raise AssertionError(f"{', '.join(differ)} not bit-reproducible "
                             f"({tag})")
    return errs, same, (c, seed)


def check_relik_full_against_rel(fa, case):
    """#20 against #11 fed the ebias the model's stream path assembles
    (``assembled_ebias``), one seed, bf16 B=256 Q=K=50 at rate 0.1. They
    draw the same keep mask and run the same register softmax and PV
    (``reg_softmax``, ``reg_probs_pv``), but #20 sums its scores from the
    ingredients and #11 from the ebias, whose dots round in another order,
    so a prob may round to bf16 one ulp apart (2^-8 relative) and an
    output by one more. Their scores also differ by the bf16 roundings of
    the assembled ebias, so each prob differs by a factor within e^{±δ}, δ
    the largest gap of a row's log-probs (measured from the plain
    versions). So the outputs lie within 2^-7·(|out| + pd·|v|) (#16 against
    #14's band) plus (e^δ − 1)·pd·|v|."""
    import torch

    c, seed = case
    ins = [c[n] for n in RELIK]
    b, q_len, d = c["rw"].shape
    kw = dict(n_heads=12, scale=0.125, rate=RATE, seed=seed)
    ebias = assembled_ebias(c)
    out20 = fa.attn_fwd_relik_cuda(*ins, **kw)
    out11 = fa.attn_fwd_rel_cuda(c["rw"], c["k"], c["v"], ebias, **kw)
    lp20 = torch.log_softmax(fa._relik_scores(*ins[:4], *ins[5:], 12,
                                              0.125), dim=-1)
    lp11 = fa._rel_probs(c["rw"], c["k"], ebias, 12, 0.125).log()
    live = c["maskb"][:, None].float() > -1e29     # masked: p = 0 in both
    delta = torch.where(live, (lp20 - lp11).abs(), 0.0).amax(dim=-1)
    _, _, pd = fa.attn_fwd_rel_reference(c["rw"], c["k"], c["v"], ebias,
                                         save=True, **kw)
    vh = c["v"].view(b, -1, 12, 64).permute(0, 2, 1, 3).float().abs()
    spread = torch.matmul(pd.float().abs(), vh)          # [B, H, Q, Dh]
    extra = (torch.exp(delta)[..., None] - 1) * spread
    to_out = lambda x: x.permute(0, 2, 1, 3).reshape(b, q_len, d)  # noqa: E731
    err = (out20.float() - out11.float()).abs()
    bound = (2.0 ** -7 * (out11.float().abs() + to_out(spread))
             + to_out(extra) + 2.0 ** -17)
    print(f"#20 vs #11 on the assembled ebias, bf16 B={b} Q=K={q_len} rate "
          f"{RATE}: max |Δ| {float(err.max()):.3e}, largest log-prob gap δ "
          f"{float(delta.max()):.3e}, {int((err > bound).sum())} elements "
          "past 2^-7·(|out| + pd·|v|) + (e^δ − 1)·pd·|v|")
    if bool((err > bound).any()):
        raise AssertionError("#20 vs #11: outputs past the bound")


def time_relik_full_kernels(fa, case, card):
    """#20 (rate 0.1, saved p and pd), #22 and #21 at bf16 B=256 Q=K=50
    against their plain versions, then at rate 0 beside the library calls
    (SDPA with the assembled ebias as a float mask; SDPA's autograd
    backward to q, k, v and the ebias), #20 at the serving shape (B=128);
    alternating rounds; then each mode's time per launch on the card
    (torch.profiler; #21's and #22's (head, batch row) pass and the dr sum
    apart). Returns {name: entry}."""
    c, seed = case
    ins = [c[n] for n in RELIK]
    kw = dict(n_heads=12, scale=0.125)
    out, launch_ms = {}, {}
    for rate in (RATE, 0.0):
        _, p, pd = fa.attn_fwd_relik_cuda(*ins, rate=rate, seed=seed,
                                          save=True, **kw)
        saved_in = (p, pd, *ins[:5], c["segd"], c["g"])
        serve = [x if n == "r" else x[:BATCH].contiguous()
                 for n, x in zip(RELIK, ins)]
        runs = {
            "attn_fwd_relik": (
                lambda: fa.attn_fwd_relik_cuda(*ins, rate=rate, seed=seed,
                                               save=True, **kw),
                lambda: fa.attn_fwd_relik_reference(*ins, rate=rate,
                                                    seed=seed, save=True,
                                                    **kw))
            if rate > 0 else (
                lambda: fa.attn_fwd_relik_cuda(*serve, **kw),
                lambda: fa.attn_fwd_relik_reference(*serve, **kw)),
            "attn_bwd_relik_saved": (
                lambda: fa.attn_bwd_relik_saved_cuda(*saved_in, **kw),
                lambda: fa.attn_bwd_relik_saved_reference(*saved_in, **kw)),
            "attn_bwd_relik": (
                lambda: fa.attn_bwd_relik_cuda(*ins, seed, c["g"], rate=rate,
                                               **kw),
                lambda: fa.attn_bwd_relik_reference(*ins, seed, c["g"],
                                                    rate=rate, **kw))}
        for name, (run_kernel, run_plain) in runs.items():
            kt, pt = _alternate(run_plain, run_kernel, 20)
            fwd = name == "attn_fwd_relik"
            b = BATCH if fwd and rate == 0 else BENCH_BATCH
            kind = {"attn_fwd_relik": "fwd", "attn_bwd_relik_saved":
                    "bwd_saved", "attn_bwd_relik": "bwd"}[name]
            bound = relik_full_bound(kind, b, S_SERVE, S_SERVE, 12, 64, 2,
                                     rate, save=fwd and rate > 0)
            entry = {"ms": float(np.mean(kt)), "plain_ms": float(np.mean(pt)),
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": None}
            lib_note = ""
            if rate == 0.0:
                sub = {n: x if n == "r" else x[:b] for n, x in c.items()}
                lib = sdpa_rel_calls(sub["rw"], sub["k"], sub["v"],
                                     assembled_ebias(sub), sub["g"], 12,
                                     0.125)
                call = lib[0] if fwd else lib[1]
                _time_ms(call, 3)
                entry["library_ms"] = float(np.mean(
                    [_time_ms(call, 20) for _ in range(2)]))
                entry["library"] = (
                    "scaled_dot_product_attention, assembled ebias as float "
                    "mask" if fwd else
                    "scaled_dot_product_attention autograd backward (dq, dk, "
                    "dv, debias), rate 0")
                lib_note = f", library {entry['library_ms']:.4f} ms"
                del lib, call
            label = (f"{'serving' if fwd and rate == 0 else 'training'} "
                     f"rate {rate}, bf16 B={b} Q=K={S_SERVE}")
            if rate > 0:
                out[name] = dict(entry, shape=label
                                 + (", saved probs" if fwd else ""))
            else:
                # the rate-0 mode, where one PyTorch call computes the same
                # function, sets the top-level numbers; training beside it
                training = {k_: out[name][k_] for k_ in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                out[name] = dict(entry, shape=label, modes={
                    out[name]["shape"]: training})
            print(f"{name} {label} H=12 Dh=64 on {card}: kernel {kt} ms, "
                  f"plain {pt} ms per call{lib_note}; bound "
                  f"{bound[0]:.4f} ms ({bound[1]})")
            # the card's time per launch: #20's, and #21's and #22's (head,
            # batch row) pass apart from the dr sum over B
            keys = {"attn_fwd_relik": ("attn_fwd_relik",),
                    "attn_bwd_relik_saved": ("attn_bwd_relik_saved",
                                             "attn_bwd_relik_fs_dr"),
                    "attn_bwd_relik": ("attn_bwd_relik_tc",
                                       "attn_bwd_relik_fs_dr")}[name]
            launch = {key: kernel_device_ms(run_kernel, key) for key in keys}
            launch_ms.setdefault(name, {})[label] = launch
            print(f"{name} {label}: the card's time per launch on {card} "
                  "(torch.profiler): " + ", ".join(
                      f"{k_} {v_:.4f} ms" for k_, v_ in launch.items()))
    for name, entry in out.items():
        entry["device_ms"] = launch_ms[name]
    return out


def xlnet_inkernel_serving(args, rng, fa, card):
    """Phase 4g: ``serving_path`` over MagXLNetForSequenceClassification at
    xlnet-base-cased width with ``rel_bias_impl="inkernel"`` (#20 once per
    layer per batch and nothing else), against einsum; ``rel_shift`` never
    called (the model builds no [B, H, Q, P] bias); then one batch's
    profile, in which #20 runs and #11 does not. Returns the counts."""
    from bert_multimodal_transformer_tpu_torch.config import (
        DatasetConfig,
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.models import xlnet as txl
    from bert_multimodal_transformer_tpu_torch.serving import Predictor
    from bert_multimodal_transformer_tpu_torch.utils.profiling import (
        device_time_by_kernel,
    )

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(XLNetConfig.xlnet_base_cased(),
                              rel_bias_impl="inkernel")
    mm = MultimodalConfig(injection_index=1)
    model = _xlnet(cfg, mm, "fused", args.seed + 50)
    split = make_xlnet_split(rng, N_TEST, S_SERVE, cfg.vocab_size,
                             ds.visual_dim, ds.acoustic_dim)
    requests = [make_xlnet_split(rng, REQUEST_SIZE, S_SERVE, cfg.vocab_size,
                                 ds.visual_dim, ds.acoustic_dim).as_tuple()[:5]
                for _ in range(N_REQUESTS)]
    predictor = Predictor(model, batch_size=BATCH)
    counts = serving_path(
        fa, card, "xlnet-base-cased inkernel", predictor,
        lambda: _xlnet(cfg, mm, "einsum", 0, model.state_dict()), split,
        requests, "attn_fwd_relik", cfg.n_layer)
    real_shift, shifts = txl.rel_shift, []
    txl.rel_shift = lambda *a: shifts.append(1) or real_shift(*a)
    try:
        predictor.predict_split(split)
    finally:
        txl.rel_shift = real_shift
    print(f"rel_shift calls in one inkernel predict_split pass: "
          f"{len(shifts)}")
    if shifts:
        raise AssertionError(f"inkernel serving called rel_shift "
                             f"{len(shifts)} times")
    profile_batch(predictor, split, card)
    batch = split.take(np.arange(BATCH)).as_tuple()[:5]
    names = [n for n, _, _ in device_time_by_kernel(
        lambda: predictor.fetch(predictor.submit(*batch)), 1)["kernels"]]
    # bf16 #20 at K = 50: its tensor-core register plan and nothing of #11
    want = {"attn_fwd_relik_tc_reg_kernel": True,
            "attn_fwd_relik_kernel": False, "attn_fwd_rel_kernel": False,
            "attn_fwd_rel_tc_reg_kernel": False,
            "attn_fwd_rel_tc_smem_kernel": False}
    ran = {kernel: any(f"{kernel}<" in n for n in names) for kernel in want}
    print(f"kernels in the inkernel batch's profile: {ran}")
    if ran != want:
        raise AssertionError(f"inkernel serving profile: {ran}")
    return counts


def xlnet_inkernel_driver_path(args, rng, fa, card):
    """Phase 6f: ``driver.main --model xlnet-base-cased --attention_impl
    fused --rel_bias_impl inkernel`` (bf16, one epoch over synthetic splits
    of 96/48/48) at S = 50: as written (#20 once per layer per batch, #22
    two launches a call per layer per train step), with ``--mem_len 50`` (K
    = 100, P = 150: the same kernels) and under ``FUSED_ATTN_SAVE=0`` (#21
    in place of #22). Checks: exit 0, finite losses, the launches. Then the
    S=50 gradient check and the two profiled B=256 steps. Returns {path:
    counts}."""
    from bert_multimodal_transformer_tpu_torch.config import XLNetConfig

    layers = XLNetConfig.xlnet_base_cased().n_layer
    n_train = -(-LONG_SPLITS[0] // TRAIN_BATCH)
    n_eval = sum(-(-n // EVAL_BATCH) for n in LONG_SPLITS[1:])
    saved = dict(attn_fwd_relik=layers * (n_train + n_eval),
                 attn_bwd_relik_saved=2 * layers * n_train)
    runs = {
        "xlnet_driver_inkernel": ([], None, saved),
        "xlnet_driver_inkernel_mem50": (["--mem_len", "50"], None, saved),
        "xlnet_driver_inkernel_recompute": ([], "0", dict(
            attn_fwd_relik=layers * (n_train + n_eval),
            attn_bwd_relik=2 * layers * n_train)),
    }
    counts = {}
    for path, (extra, save, launches) in runs.items():
        argv = ["--model", "xlnet-base-cased", "--dataset", "mosi",
                "--synthetic", "--synthetic_sizes", *map(str, LONG_SPLITS),
                "--n_epochs", "1", "--attention_impl", "fused",
                "--rel_bias_impl", "inkernel", "--compute_dtype", "bfloat16",
                "--seed", str(args.seed), *extra]
        if save is not None:
            os.environ["FUSED_ATTN_SAVE"] = save
        try:
            counts[path] = run_driver(argv, fa, card)
        finally:
            os.environ.pop("FUSED_ATTN_SAVE", None)
        want = _want(fa, **launches)
        print(f"kernel launches in {path}: {counts[path]} (want {want}: "
              f"{n_train} train + {n_eval} dev/test batches, {layers} "
              "layers)")
        if counts[path] != want:
            raise AssertionError(f"{path} launches {counts[path]} != {want}")
    xlnet_grad_check(args, rng, fa, card, s=S_SERVE, batch=TRAIN_BATCH,
                     impl="inkernel", bwd="attn_bwd_relik_saved", tag="#22",
                     launches=dict(attn_fwd_relik=layers,
                                   attn_bwd_relik_saved=2 * layers),
                     seed_offset=51)
    profs = {impl: xlnet_long_step_profile(args, rng, card, impl, s=S_SERVE,
                                           batch=BENCH_BATCH)
             for impl in ("inkernel", "auto")}
    outside = {}
    for impl, prof in profs.items():
        attn = sum(ms for name, _, ms in prof["kernels"]
                   if "attn_fwd_rel" in name or "attn_bwd_rel" in name)
        outside[impl] = prof["device_ms"] - attn
    gap = outside["auto"] - outside["inkernel"]
    print(f"XLNet B={BENCH_BATCH} S={S_SERVE} step on {card}: device "
          f"{profs['auto']['device_ms']:.3f} ms under auto, "
          f"{profs['inkernel']['device_ms']:.3f} under inkernel; outside the "
          f"attention kernels {outside['auto']:.3f} and "
          f"{outside['inkernel']:.3f} ms: the ebias assembly and its backward "
          f"cost {gap:.3f} ms, {gap / profs['auto']['device_ms']:.1%} of the "
          "auto step")
    return counts


# ---- tensor parallelism: the split-layout kernels #8-#10 and the TP paths --

# Phase 3i's cases: (dtype, B, S, heads, rates, (batch-row, head) offsets).
# H=6 at offsets (256, 6) is a data-rank-1, model-rank-1 shard at model 2.
SPLIT_CASES = (
    ("bf16", BENCH_BATCH, S_SERVE, 12, (RATE, 0.0), (0, 0)),
    ("bf16", BENCH_BATCH, S_SERVE, 6, (RATE,), (BENCH_BATCH, 6)),
    ("fp32", 4, 77, 12, (RATE,), (4, 12)),
)
TP_RANKS = 2                  # model 2 on the one card, ranks over gloo
TP_SERVE_N = 256              # phase 4h: two batches of 128
TP_SPLITS = (96, 48, 48)      # phase 6g: 2 train + 2 eval batches at 48/128
# Phase 6g: two dropout-0 steps of the two-rank model against the one-card
# model from the same weights, at lr 1e-5 with no warmup, so the second
# loss sees the first update. Held: every parameter's first-step gradient,
# as the max |Δ| of the rank's chunk to the one card's over the one card's
# max |·| (TP_GRAD_TOL), and the relative loss gap (TP_STEP_TOL). The model
# axis sums its partial products in another order, so in fp32 both move by
# fp32 roundings (~1e-7 relative for the losses, ~1e-6 of a parameter's
# scale for its gradient); a wrong shard, a missing all-reduce, an unsummed
# qkv gradient or a wrong dq moves a gradient by its own scale (the planted
# faults of TP_FAULTS must read past the fp32 bound). In bf16 each rank
# rounds its partial products to bf16 before the sum, which one card does
# not: the losses move by about 1e-3 relative and the gradients by about
# 1e-2 of their scale; the bf16 bounds are ten times that.
TP_STEP_TOL = {"fp32": 1e-4, "bf16": 1e-2}
TP_GRAD_TOL = {"fp32": 1e-4, "bf16": 1e-1}


def split_case(rng, dtype_name, b, s, h, dh=64):
    """Seeded q, k, v, g [B, H, S, Dh], a ragged mask and a seed."""
    import torch

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype_name]
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (b, h, s, dh), dtype=np.float32)).to("cuda", dtype)
        for _ in range(4))
    mask = torch.from_numpy(_ragged_mask(rng, b, s)).cuda().float()
    return q, k, v, mask, g, int(rng.integers(0, 2 ** 63 - 1))


def _split_grad_err(name, got, want, dtype_name, bound_args, fa):
    """Max abs err over (dq, dk, dv); raises past the stated bound (bf16:
    ``split_grads_bf16_bound``; fp32: GRAD_FP32_TOL)."""
    import torch

    if dtype_name == "bf16":
        p, pd, q, k, v, g = bound_args
        bounds = fa.split_grads_bf16_bound(want, p, pd, q, k, v, g,
                                           scale=0.125)
    errs = []
    for i, (x, w) in enumerate(zip(got, want)):
        err = (x.float() - w.float()).abs()
        bound = (bounds[i] if dtype_name == "bf16"
                 else GRAD_FP32_TOL + GRAD_FP32_TOL * w.float().abs())
        if bool((err > bound).any()) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name} d{'qkv'[i]}: "
                                 f"{int((err > bound).sum())} elements out "
                                 f"of tolerance, max_abs_err "
                                 f"{float(err.max())}")
        errs.append(float(err.max()))
    return max(errs)


def check_split_kernels(rng, fa, dtype_name, b, s, h, rate, offs):
    """Phase 3i on one case: #8 with save (and dropout at rate > 0) at the
    shard's (batch-row, head) offsets, #10 and #9, each against its plain
    version and the backwards against torch.autograd through the plain
    forward; #8's keep mask against the plain Philox mask of the shard's
    global rows and heads; at offsets 0, #8 against #1 on the packed
    q|k|v bit for bit; #2 on the packed q|k|v against its plain version
    and bit for bit against #9 at offsets 0; the same bits twice. Returns
    the max errors."""
    import torch

    q, k, v, mask, g, seed = split_case(rng, dtype_name, b, s, h)
    b_off, h_off = offs
    drop = dict(rate=rate, seed=seed, b_off=b_off, h_off=h_off)
    kw = dict(scale=0.125)
    tag = (f"{dtype_name} B={b} S={s} H={h} Dh=64 rate={rate} offsets "
           f"(b {b_off}, h {h_off})")
    out, p, pd = fa.attn_fwd_split_cuda(q, k, v, mask, save=True, **drop,
                                        **kw)
    want = fa.attn_fwd_split_reference(q, k, v, mask, save=True, **drop,
                                       **kw)
    errs = {"#8": max(_forward_err(f"#8 {n} {tag}", x, w, dtype_name)
                      for n, x, w in zip(("out", "p", "pd"), (out, p, pd),
                                         want))}
    line = (f"#8 vs plain {tag}: out/p/pd max_abs_err={errs['#8']:.3e}"
            + _check_keep(fa, "#8", seed, p, pd, rate, tag, offs))
    if offs == (0, 0):
        packed = fa.attn_fwd_packed_cuda(fa._pack(q, k, v), mask,
                                         n_heads=h, rate=rate, seed=seed,
                                         save=True, **kw)
        same = (torch.equal(fa._merge_heads(out), packed[0])
                and torch.equal(p, packed[1]) and torch.equal(pd, packed[2]))
        line += f"; #8 = #1 on the packed q|k|v bit for bit: {same}"
        if not same:
            raise AssertionError(f"#8 and #1 differ ({tag})")
    print(line)
    runs = {"#10": lambda: fa.attn_bwd_split_saved_cuda(p, pd, q, k, v, g,
                                                        **kw),
            "#9": lambda: fa.attn_bwd_split_cuda(q, k, v, mask, seed, g,
                                                 rate=rate, b_off=b_off,
                                                 h_off=h_off, **kw)}
    got = {name: run() for name, run in runs.items()}
    plain = {"#10": fa.attn_bwd_split_saved_reference(p, pd, q, k, v, g,
                                                      **kw),
             "#9": fa.attn_bwd_split_reference(q, k, v, mask, seed, g,
                                               rate=rate, b_off=b_off,
                                               h_off=h_off, **kw)}
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    fa.attn_fwd_split_reference(*xs, mask, **drop, **kw).backward(g)
    auto = [x.grad for x in xs]
    bound_args = (p, pd, q, k, v, g)
    for name, x, w in (("#10 vs plain", got["#10"], plain["#10"]),
                       ("#10 vs autograd", got["#10"], auto),
                       ("#9 vs plain", got["#9"], plain["#9"]),
                       ("#9 vs autograd", got["#9"], auto),
                       ("#9 vs #10", got["#9"], got["#10"])):
        errs[name] = _split_grad_err(f"{name} {tag}", x, w, dtype_name,
                                     bound_args, fa)
    # #2 runs #9's kernel through the packed layout: on the same q, k, v
    # (the forward's counter at offsets 0) the same bits as #9, and its
    # plain version's values within the bound
    qkv, g_packed = fa._pack(q, k, v), fa._merge_heads(g)
    nought = dict(rate=rate, seed=seed, **kw)
    two = fa.attn_bwd_packed_cuda(qkv, mask, seed, g_packed, n_heads=h,
                                  rate=rate, **kw)
    two_plain = fa.attn_bwd_packed_reference(qkv, mask, seed, g_packed,
                                             n_heads=h, rate=rate, **kw)
    nine = (got["#9"] if offs == (0, 0) else fa.attn_bwd_split_cuda(
        q, k, v, mask, seed, g, rate=rate, **kw))
    p0, pd0 = ((p, pd) if offs == (0, 0) else fa.attn_fwd_split_reference(
        q, k, v, mask, save=True, **nought)[1:])
    errs["#2 vs plain"] = _split_grad_err(
        f"#2 vs plain {tag}", fa._heads(two, h), fa._heads(two_plain, h),
        dtype_name, (p0, pd0, q, k, v, g), fa)
    two_is_nine = torch.equal(fa._pack(*nine), two)
    if not two_is_nine:
        raise AssertionError(f"#2 and #9 differ on the same q, k, v ({tag})")
    twice = [("#8", (out, p, pd), lambda: fa.attn_fwd_split_cuda(
        q, k, v, mask, save=True, **drop, **kw))]
    twice += [(name, got[name], run) for name, run in runs.items()]
    twice += [("#2", (two,), lambda: (fa.attn_bwd_packed_cuda(
        qkv, mask, seed, g_packed, n_heads=h, rate=rate, **kw),))]
    differ = [name for name, first, again in twice
              if not all(torch.equal(x, y) for x, y in zip(first, again()))]
    print(f"#2 = #9 on the packed q|k|v bit for bit {tag}: {two_is_nine}")
    print(f"split backward {tag} (dq, dk, dv): "
          + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in errs.items()
                      if k_ != "#8")
          + f"; same seed twice, identical bits {not differ}")
    if differ:
        raise AssertionError(f"{', '.join(differ)} not bit-reproducible "
                             f"({tag})")
    return errs


def split_sdpa_calls(q, k, v, mask, g):
    """The library calls at rate 0 on the split layout:
    ``scaled_dot_product_attention`` with the (1 − mask)·−10000 bias, and
    its autograd backward to q, k, v. Never used by the port."""
    import torch
    import torch.nn.functional as F

    bias = ((1.0 - mask) * -10000.0).to(q.dtype)[:, None, None, :]
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*xs, attn_mask=bias, scale=0.125)

    def forward():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                              scale=0.125)

    def backward():
        return torch.autograd.grad(out, xs, g, retain_graph=True)

    return forward, backward


def time_split_kernels(rng, fa, card):
    """#8 at the serving shape (bf16 B=128 S=50, rate 0) beside SDPA, and
    #8 (rate 0.1, saved p and pd), #10 and #9 at the training shape (B=256)
    against their plain versions, #9 at rate 0 beside SDPA's autograd
    backward; at H=12 (all heads) and H=6 (one rank's heads at model 2);
    alternating rounds. Returns {name: entry}, H=12 at the top level."""
    import torch

    out = {}
    for h in (12, 6):
        q, k, v, mask, g, seed = split_case(rng, "bf16", BENCH_BATCH,
                                            S_SERVE, h)
        kw = dict(scale=0.125)
        _, p, pd = fa.attn_fwd_split_cuda(q, k, v, mask, rate=RATE,
                                          seed=seed, save=True, **kw)
        serve = [x[:BATCH] for x in (q, k, v, mask)]
        modes = {
            ("attn_fwd_split", "serving rate 0", BATCH): (
                lambda: fa.attn_fwd_split_cuda(*serve, **kw),
                lambda: fa.attn_fwd_split_reference(*serve, **kw),
                attn_bound("fwd", BATCH, S_SERVE, h, 64, 2),
                split_sdpa_calls(*serve, g[:BATCH])[0]),
            ("attn_fwd_split", "training rate 0.1, saved probs",
             BENCH_BATCH): (
                lambda: fa.attn_fwd_split_cuda(q, k, v, mask, rate=RATE,
                                               seed=seed, save=True, **kw),
                lambda: fa.attn_fwd_split_reference(q, k, v, mask,
                                                    rate=RATE, seed=seed,
                                                    save=True, **kw),
                attn_bound("fwd", BENCH_BATCH, S_SERVE, h, 64, 2, RATE,
                           save=True), None),
            ("attn_bwd_split_saved", "training rate 0.1", BENCH_BATCH): (
                lambda: fa.attn_bwd_split_saved_cuda(p, pd, q, k, v, g,
                                                     **kw),
                lambda: fa.attn_bwd_split_saved_reference(p, pd, q, k, v, g,
                                                          **kw),
                attn_bound("bwd_saved", BENCH_BATCH, S_SERVE, h, 64, 2,
                           RATE), None),
            ("attn_bwd_split", "training rate 0.1", BENCH_BATCH): (
                lambda: fa.attn_bwd_split_cuda(q, k, v, mask, seed, g,
                                               rate=RATE, **kw),
                lambda: fa.attn_bwd_split_reference(q, k, v, mask, seed, g,
                                                    rate=RATE, **kw),
                attn_bound("bwd", BENCH_BATCH, S_SERVE, h, 64, 2, RATE),
                None),
            ("attn_bwd_split", "rate 0", BENCH_BATCH): (
                lambda: fa.attn_bwd_split_cuda(q, k, v, mask, 0, g, **kw),
                lambda: fa.attn_bwd_split_reference(q, k, v, mask, 0, g,
                                                    **kw),
                attn_bound("bwd", BENCH_BATCH, S_SERVE, h, 64, 2),
                split_sdpa_calls(q, k, v, mask, g)[1]),
        }
        for (name, mode, b), (run_k, run_p, bound, lib) in modes.items():
            kt, pt = _alternate(run_p, run_k, 20)
            entry = {"ms": float(np.mean(kt)), "plain_ms": float(np.mean(pt)),
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": None}
            note = ""
            if lib is not None:
                _time_ms(lib, 3)
                entry["library_ms"] = float(np.mean(
                    [_time_ms(lib, 20) for _ in range(2)]))
                entry["library"] = (
                    "scaled_dot_product_attention" if name == "attn_fwd_split"
                    else "scaled_dot_product_attention autograd backward "
                         "(dq, dk, dv), rate 0")
                note = f", library {entry['library_ms']:.4f} ms"
            label = f"{mode}, bf16 B={b} S={S_SERVE} H={h} Dh=64"
            print(f"{name} {label} on {card}: kernel {kt} ms, plain {pt} ms "
                  f"per call{note}; bound {bound[0]:.4f} ms ({bound[1]})")
            top = (h == 12 and (mode == "serving rate 0"
                                or mode == "training rate 0.1"))
            if top:
                out[name] = dict(entry, shape=label, modes=dict(
                    out.get(name, {}).get("modes", {})))
            else:
                out.setdefault(name, {"modes": {}})["modes"][label] = entry
        del q, k, v, g, p, pd, serve, modes
        torch.cuda.empty_cache()
    return out


def _tp_model(mesh, impl, dtype, seed, rate=None, shard=True):
    """bert-base MAG-BERT with MOSI dims, built whole from ``seed`` on this
    rank's device (its attention head-sharded over ``mesh`` with
    ``shard``; the card with no mesh); ``rate`` None keeps the default
    dropouts."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
        MultimodalConfig,
    )
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                              attention_impl=impl,
                              tp_attention_mesh=mesh if shard else None)
    mm = MultimodalConfig()
    if rate is not None:
        cfg = dataclasses.replace(cfg, hidden_dropout_prob=rate,
                                  attention_probs_dropout_prob=rate)
        mm = MultimodalConfig(dropout_prob=rate)
    device = mesh.device if mesh is not None else torch.device("cuda")
    return MagBertForSequenceClassification(
        cfg, mm, ds.visual_dim, ds.acoustic_dim, dtype, device=device,
        generator=torch.Generator(device=device).manual_seed(seed))


def tp_serving_rank(rank, seed, split):
    """Phase 4h on one rank: ``Predictor(mesh=)`` of the head-sharded
    fused model serves the split at batch 128. Returns its predictions,
    the kernels' launches during ``predict_split`` and its wall."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import MeshConfig
    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as fa,
    )
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh
    from bert_multimodal_transformer_tpu_torch.serving import Predictor

    mesh = make_mesh(MeshConfig(data_parallel=-1, model_parallel=TP_RANKS))
    model = _tp_model(mesh, "fused", torch.bfloat16, seed)
    predictor = Predictor(model, batch_size=BATCH, mesh=mesh)
    predictor.predict_split(split.take(np.arange(BATCH)))  # warm-up
    torch.cuda.synchronize()
    _zero_counts(fa)
    t0 = time.perf_counter()
    preds = predictor.predict_split(split)
    wall = time.perf_counter() - t0
    return {"preds": preds, "launches": _counts(fa), "wall": wall,
            "backend": mesh.backend, "device": str(mesh.device)}


def tp_serving(args, rng, fa, card):
    """Phase 4h: two ranks sharing the card serve ``TP_SERVE_N`` examples
    through ``Predictor(mesh=)``; #8 once per layer per batch on each rank
    and no other kernel, and the predictions within PRED_ATOL of the
    one-card einsum model's from the same weights. Returns the launch
    counts summed over the ranks."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import run_ranks
    from bert_multimodal_transformer_tpu_torch.serving import Predictor

    ds = DatasetConfig.mosi()
    vocab = BertConfig.bert_base_uncased().vocab_size
    split = make_split(rng, TP_SERVE_N, S_SERVE, vocab, ds.visual_dim,
                       ds.acoustic_dim)
    seed = args.seed + 90
    t0 = time.perf_counter()
    ranks = run_ranks(tp_serving_rank, TP_RANKS, (seed, split),
                      timeout_s=300)
    print(f"Predictor(mesh=) over {TP_RANKS} ranks ({ranks[0]['backend']} on "
          f"{[r['device'] for r in ranks]}): {time.perf_counter() - t0:.2f} "
          f"s for the ranks' start, build and serving")
    layers = BertConfig.bert_base_uncased().num_hidden_layers
    want = _want(fa, attn_fwd_split=layers * (TP_SERVE_N // BATCH))
    for i, r in enumerate(ranks):
        print(f"  rank {i}: launches {r['launches']} (want {want}), "
              f"predict_split {TP_SERVE_N / r['wall']:.1f} examples/s on "
              f"{card} ({r['wall']:.3f} s)")
        if r["launches"] != want:
            raise AssertionError(f"TP serving rank {i} launches "
                                 f"{r['launches']} != {want}")
    preds = ranks[0]["preds"]
    if preds.shape != (TP_SERVE_N,) or not np.isfinite(preds).all():
        raise AssertionError(f"bad TP predictions {preds.shape}")
    if not np.array_equal(preds, ranks[1]["preds"]):
        raise AssertionError("the ranks' gathered predictions differ")
    einsum = _tp_model(None, "einsum", torch.bfloat16, seed)
    want_preds = Predictor(einsum, batch_size=BATCH).predict_split(split)
    err = float(np.abs(preds - want_preds).max())
    print(f"  TP fused vs one-card einsum predictions: max_abs_diff "
          f"{err:.3e} (tolerance {PRED_ATOL}), |pred| max "
          f"{np.abs(want_preds).max():.3f}")
    if not err <= PRED_ATOL:
        raise AssertionError(f"TP predictions differ by {err}")
    del einsum
    torch.cuda.empty_cache()
    return {name: sum(r["launches"][name] for r in ranks)
            for name in ranks[0]["launches"]}


def _tp_step_batches(seed):
    """Two seeded bf16-model batches of 48 (host arrays)."""
    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
    )

    ds = DatasetConfig.mosi()
    rng = np.random.default_rng([seed, 7])
    return [make_split(rng, TRAIN_BATCH, S_SERVE,
                       BertConfig.bert_base_uncased().vocab_size,
                       ds.visual_dim, ds.acoustic_dim).as_tuple()
            for _ in range(2)]


def _grad_gap(got, want):
    """max |got − want| over max |want| (the max |Δ| when want is 0)."""
    d = float((got.float() - want.to(got.device).float()).abs().max())
    m = float(want.float().abs().max())
    return d / m if m > 0 else d


def tp_steps(mesh, shard, seed, dtype_name, ref_grads=None):
    """Two dropout-0 train steps of bert-base from ``seed``'s weights (one
    card when ``mesh`` is None) at lr 1e-5 with no warmup. Returns (the
    losses, the first step's gradients by parameter name); with
    ``ref_grads`` (the one card's) the second item is instead each
    parameter's ``_grad_gap`` of this rank's gradient to its chunk of the
    reference (inf for a parameter the step left without one)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.parallel import tp
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import Trainer

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    model = _tp_model(mesh, "fused", dtype, seed, rate=0.0, shard=shard)
    tr = Trainer(model=model,
                 tx=make_optimizer(1e-5, 10, warmup_proportion=0.0),
                 mesh=mesh, tp_shard_attention=shard)
    st = tr.create_state_from_params(None, seed)
    first, second = _tp_step_batches(seed)
    losses = [float(tr._train_step(st, tr._put_batch(first)))]
    # AdamW reads the gradients and leaves them be; the next step's
    # zero_grad drops them, so these stay the first step's.
    grads = {n: p.grad for n, p in st.model.named_parameters()}
    if ref_grads is not None:
        grads = {n: math.inf if grads.get(n) is None else _grad_gap(
            grads[n], tp.shard_tensor(ref, tp.tp_pspec_for_path(
                n, shard_attention=shard), mesh))
            for n, ref in ref_grads.items()}
    losses.append(float(tr._train_step(st, tr._put_batch(second))))
    return losses, grads


# Phase 6g's step cases: (label, head-sharded attention, FUSED_ATTN_SAVE,
# dtype, the kernels each step launches once per layer).
TP_STEP_CASES = (
    ("head-sharded attention, saved probs", True, "1", "fp32",
     ("attn_fwd_split", "attn_bwd_split_saved")),
    ("head-sharded attention, recompute", True, "0", "fp32",
     ("attn_fwd_split", "attn_bwd_split")),
    ("FFN split only", False, "1", "fp32",
     ("attn_fwd_packed", "attn_bwd_packed_saved")),
    ("head-sharded attention, bf16", True, "1", "bf16",
     ("attn_fwd_split", "attn_bwd_split_saved")),
)
# Faults planted in the fp32 saved-probs case, each of which the gradient
# check must see.
TP_FAULTS = ("qkv gradient not summed over the model axis",
             "#10 returns a zero dq")


@contextlib.contextmanager
def _planted(fault):
    """Inside: the TP step carries ``fault`` (one of TP_FAULTS)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as fa,
    )
    from bert_multimodal_transformer_tpu_torch.parallel import tp

    if fault == TP_FAULTS[0]:
        mod, attr = tp, "sync_grads"
        wrong = lambda model, mesh: None  # noqa: E731
    else:
        mod, attr = fa, "attn_bwd_split_saved"
        right = fa.attn_bwd_split_saved

        def wrong(*args, **kw):
            dq, dk, dv = right(*args, **kw)
            return torch.zeros_like(dq), dk, dv
    saved = getattr(mod, attr)
    setattr(mod, attr, wrong)
    try:
        yield
    finally:
        setattr(mod, attr, saved)


def tp_steps_rank(rank, seed):
    """Phase 6g's step check on one rank: the one-card steps on this
    rank's card (their losses, their gradients kept as the reference),
    then each TP_STEP_CASES case's losses, gradient gaps and launches, and
    each TP_FAULTS fault's gradient gaps."""
    from bert_multimodal_transformer_tpu_torch.config import MeshConfig
    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as fa,
    )
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(data_parallel=-1, model_parallel=TP_RANKS))
    one = {d: tp_steps(None, False, seed, d) for d in TP_STEP_TOL}
    out = {"one card": {d: losses for d, (losses, _) in one.items()}}
    for label, shard, save, dtype_name, _ in TP_STEP_CASES:
        os.environ["FUSED_ATTN_SAVE"] = save
        _zero_counts(fa)
        out[label] = (*tp_steps(mesh, shard, seed, dtype_name,
                                one[dtype_name][1]), _counts(fa))
    os.environ["FUSED_ATTN_SAVE"] = "1"
    for fault in TP_FAULTS:
        with _planted(fault):
            out[fault] = tp_steps(mesh, True, seed, "fp32", one["fp32"][1])
    del os.environ["FUSED_ATTN_SAVE"]
    return out


def tp_driver_path(args, fa, card):
    """Phase 6g: ``driver.main --model_parallel 2 --tp_shard_attention
    --attention_impl fused`` at bert-base over 96/48/48: exit 0, finite
    losses equal on both ranks, #8 once per layer per batch and #10 once
    per layer per train step on each rank; then two dropout-0 steps of the
    two-rank model (TP_STEP_CASES: fp32 head-sharded with the saved-probs
    and the recompute backward, FFN-only; bf16 head-sharded) against the
    one-card model: the first step's gradients parameter by parameter
    within TP_GRAD_TOL and the losses within TP_STEP_TOL, and each planted
    fault of TP_FAULTS past the fp32 gradient bound. Returns {path: launch
    counts summed over the ranks} for the driver run and the recompute
    steps (#9's path)."""
    from bert_multimodal_transformer_tpu_torch import driver
    from bert_multimodal_transformer_tpu_torch.config import BertConfig

    argv = ["--model", "bert-base-uncased", "--dataset", "mosi",
            "--synthetic", "--synthetic_sizes", *map(str, TP_SPLITS),
            "--n_epochs", "1", "--model_parallel", str(TP_RANKS),
            "--tp_shard_attention", "--attention_impl", "fused",
            "--compute_dtype", "bfloat16", "--seed", str(args.seed)]
    os.environ.setdefault("WANDB_MODE", "disabled")
    t0 = time.perf_counter()
    rc, ranks = driver.run(argv, rank_timeout_s=600)
    wall = time.perf_counter() - t0
    print(f"driver.main({' '.join(argv)}) on {card}: exit {rc}, {wall:.2f} "
          f"s wall ({len(ranks)} ranks over {ranks[0]['backend']}: start, "
          f"model build, data, one epoch and its eval)")
    if rc != 0 or len(ranks) != TP_RANKS:
        raise AssertionError(f"TP driver exited {rc} with {len(ranks)} ranks")
    layers = BertConfig.bert_base_uncased().num_hidden_layers
    n_train = -(-TP_SPLITS[0] // TRAIN_BATCH)
    n_eval = sum(-(-n // EVAL_BATCH) for n in TP_SPLITS[1:])
    want = _want(fa, attn_fwd_split=layers * (n_train + n_eval),
                 attn_bwd_split_saved=layers * n_train)
    for i, r in enumerate(ranks):
        (rec,) = r["history"]
        print(f"  rank {i}: epoch {rec['epoch']} train_loss "
              f"{rec['train_loss']} valid_loss {rec['valid_loss']}; "
              f"launches {r['launches']} (want {want})")
        if not all(math.isfinite(rec[k]) for k in ("train_loss",
                                                   "valid_loss")):
            raise AssertionError(f"non-finite TP losses {rec}")
        if r["launches"] != want:
            raise AssertionError(f"TP driver rank {i} launches "
                                 f"{r['launches']} != {want}")
    if any(ranks[0]["history"][0][k] != ranks[1]["history"][0][k]
           for k in ("train_loss", "valid_loss", "test_acc")):
        raise AssertionError("the ranks' epoch records differ")

    return {"tp_driver": {name: sum(r["launches"][name] for r in ranks)
                          for name in _wrappers(fa)},
            "tp_step_recompute": tp_step_check(fa, args.seed + 91)}


def tp_step_check(fa, seed):
    """Phase 6g's step check (TP_STEP_CASES, TP_FAULTS) over TP_RANKS
    ranks. Returns the recompute steps' launch counts summed over the
    ranks."""
    from bert_multimodal_transformer_tpu_torch.config import BertConfig
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import run_ranks

    layers = BertConfig.bert_base_uncased().num_hidden_layers
    t0 = time.perf_counter()
    steps = run_ranks(tp_steps_rank, TP_RANKS, (seed,), timeout_s=300)
    one = steps[0]["one card"]
    print(f"  dropout-0 steps at lr 1e-5, bert-base B={TRAIN_BATCH} "
          f"S={S_SERVE}, one card: losses {one} "
          f"({time.perf_counter() - t0:.2f} s with the ranks)")
    if any(r["one card"] != one for r in steps):
        raise AssertionError("the ranks' one-card steps differ")

    def worst(gaps):
        name = max(gaps, key=gaps.get)
        return gaps[name], name

    for label, _, _, dtype_name, kernels in TP_STEP_CASES:
        want = _want(fa, **{k_: 2 * layers for k_ in kernels})
        for i, r in enumerate(steps):
            losses, gaps, counts = r[label]
            gap = max(abs(a - b) / abs(b)
                      for a, b in zip(losses, one[dtype_name]))
            g_gap, g_name = worst(gaps)
            print(f"  rank {i}, {label}: losses {losses}, relative gap "
                  f"{gap:.3e} (bound {TP_STEP_TOL[dtype_name]}); first-step "
                  f"gradients of {len(gaps)} parameters, worst gap "
                  f"{g_gap:.3e} at {g_name} (bound "
                  f"{TP_GRAD_TOL[dtype_name]}); launches {counts}")
            if (not gap <= TP_STEP_TOL[dtype_name]
                    or not g_gap <= TP_GRAD_TOL[dtype_name]
                    or counts != want):
                raise AssertionError(
                    f"TP step ({label}) rank {i}: loss gap {gap}, gradient "
                    f"gap {g_gap} at {g_name}, launches {counts} (want "
                    f"{want})")
    for fault in TP_FAULTS:
        for i, r in enumerate(steps):
            g_gap, g_name = worst(r[fault][1])
            print(f"  rank {i}, planted fault ({fault}): worst gradient gap "
                  f"{g_gap:.3e} at {g_name} (must exceed "
                  f"{TP_GRAD_TOL['fp32']})")
            if not g_gap > TP_GRAD_TOL["fp32"]:
                raise AssertionError(f"the TP step check cannot see the "
                                     f"planted fault ({fault}) on rank {i}")
    recompute = TP_STEP_CASES[1][0]
    return {name: sum(r[recompute][2][name] for r in steps)
            for name in _wrappers(fa)}


# ---- the QKV projection inside the attention kernels: #18, #19 ------------

# Phase 3j's cases: (dtype, B, S, heads, rates); bert-large width last.
QKVPROJ_CASES = (
    ("bf16", BENCH_BATCH, S_SERVE, 12, (RATE, 0.0)),
    ("fp32", 4, 77, 12, (RATE,)),
    ("bf16", 8, S_SERVE, 16, (RATE,)),
)
# The edges of bf16 #18's plans, from a stream of their own: S = 64 (the
# register plan's last), 65 (the row plan's first) and 122 (the reach with
# a gradient); then the reach without one (qkvproj_fits: S = 468 at
# Dh = 64), the forward alone.
QKVPROJ_EDGES = (
    ("bf16", 8, 64, 12, (RATE, 0.0)),
    ("bf16", 8, 65, 12, (RATE,)),
    ("bf16", 2, 122, 12, (RATE,)),
)
QKVPROJ_FWD_REACH = 468
# Phase 6h: one dropout-0 step with the projection inside the kernels (#18,
# #19) against the split fused step (the dense projection, #1, #3) from one
# copy of the weights, leaf by leaf as in 4b, in fp32. The two take the
# same math in other orders: the projection's sum over D and its bias in
# fp32 against cuBLAS's product and the bias added after it, dx summed by
# #19 against autograd's matmul; fp32 roundings move a leaf by ~1e-6 of its
# norm. dx zeroed in #19's output takes the attention path's gradient from
# every lower layer, a zero dK the k leaves' whole gradient: both must read
# past the bound.
QKVPROJ_GRAD_TOL = 1e-4
# Phase 3j, fp32: a batch row with no real token scores every key at
# −10000 + O(1), which fp32 holds on a grid of ulp(10⁴) = 2^-10. #18's
# projection may differ from the plain one (cuBLAS) in its last bit, and
# that moves such a score by a grid step: a prob by up to 2^-9 relative and
# the output by up to 2^-8 of the row's largest |v|. Such rows are held to
# that (relative to p, pd and max |v|); every other row to FP32_ATOL.
QKVPROJ_PADDED_RTOL = 2.0 ** -8


def qkvproj_case(rng, dtype_name, b, s, h, dh=64):
    """Seeded x [B, S, D] (unit scale, as a LayerNorm output), the packed
    weight as the model holds it ([3D, D], N(0, 1/D), so qkv has unit
    scale) handed over as its [D, 3D] view, the bias, a ragged mask, g, a
    seed and the head count and scale."""
    import torch

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype_name]
    d = h * dh
    x, g = (torch.from_numpy(rng.standard_normal(
        (b, s, d), dtype=np.float32)).to("cuda", dtype) for _ in range(2))
    w_rows = torch.from_numpy(rng.standard_normal(
        (3 * d, d), dtype=np.float32) / np.sqrt(d)).to("cuda", dtype)
    b3 = torch.from_numpy(0.1 * rng.standard_normal(
        3 * d, dtype=np.float32)).to("cuda", dtype)
    mask = torch.from_numpy(_ragged_mask(rng, b, s)).cuda().float()
    return (x, w_rows.t(), b3, mask, g, int(rng.integers(0, 2 ** 63 - 1)),
            dict(n_heads=h, scale=1.0 / dh ** 0.5))


def _qkvproj_grad_errs(name, got, want, dtype_name, bound_args, fa):
    """Max abs err over (dqkv, dx); raises past the stated bounds (bf16:
    ``dqkv_bf16_bound`` and ``qkvproj_dx_bf16_bound``; fp32:
    GRAD_FP32_TOL)."""
    import torch

    if dtype_name == "bf16":
        p, pd, qkv, g, w, kw = bound_args
        bound = fa.dqkv_bf16_bound(want[0], p, pd, qkv, g, **kw)
        bounds = (bound, fa.qkvproj_dx_bf16_bound(want[1], bound, w))
    else:
        bounds = [GRAD_FP32_TOL + GRAD_FP32_TOL * x.float().abs()
                  for x in want]
    errs = []
    for part, x, ref, bnd in zip(("dqkv", "dx"), got, want, bounds):
        err = (x.float() - ref.float()).abs()
        if bool((err > bnd).any()) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name} {part}: {int((err > bnd).sum())} "
                                 f"elements out of tolerance, max_abs_err "
                                 f"{float(err.max())}")
        errs.append(float(err.max()))
    return max(errs)


def _qkvproj_forward_err(tag, got, want, mask, dtype_name):
    """Max abs err of #18's (out, qkv, p, pd) against the plain version's;
    raises past the phase-3 bounds, and in fp32 past QKVPROJ_PADDED_RTOL on
    the batch rows with no real token."""
    names = ("out", "qkv", "p", "pd")
    if dtype_name == "bf16":
        return max(_forward_err(f"#18 {n} {tag}", x, r, dtype_name)
                   for n, x, r in zip(names, got, want))
    live = mask.sum(-1) > 0
    err = max(_forward_err(f"#18 {n} {tag}", x[live], r[live], "fp32")
              for n, x, r in zip(names, got, want) if n != "qkv")
    err = max(err, _forward_err(f"#18 qkv {tag}", got[1], want[1], "fp32"))
    if bool(live.all()):
        return err
    d = got[0].shape[-1]
    v_max = float(want[1][~live][..., 2 * d:].float().abs().max())
    for n, x, r in zip(names, got, want):
        if n == "qkv":
            continue
        x, r = x[~live].float(), r[~live].float()
        bound = QKVPROJ_PADDED_RTOL * (v_max if n == "out" else r.abs())
        gap = (x - r).abs()
        if bool((gap > bound).any()):
            raise AssertionError(f"#18 {n} {tag}, padded rows: "
                                 f"{int((gap > bound).sum())} elements past "
                                 f"{QKVPROJ_PADDED_RTOL}, max_abs_err "
                                 f"{float(gap.max())}")
        err = max(err, float(gap.max()))
    return err


def check_qkvproj_kernels(rng, fa, dtype_name, b, s, h, rate):
    """Phase 3j on one case: #18 with saved probs and the emitted qkv
    against its plain version (out, qkv, p, pd), its keep mask against the
    plain Philox mask, #1 on its emitted qkv (bit for bit in fp32 and, up
    to S = 64, in bf16; past it in bf16 within the phase-3 forward bound
    with the same keep mask), and #1 on the
    plain projection's qkv within the phase-3 bf16 bound (in fp32 too,
    which covers QKVPROJ_PADDED_RTOL's padded rows); #19 reading that qkv
    and #19 re-projecting from x bit for bit alike, and against the plain
    backward; #19 on the plain forward's qkv and probs against
    torch.autograd through the plain forward; the same bits twice. Returns
    the max errors and the case."""
    import torch

    case = qkvproj_case(rng, dtype_name, b, s, h)
    x, w, b3, mask, g, seed, kw = case
    tag = f"{dtype_name} B={b} S={s} H={h} Dh=64 rate={rate}"
    # bf16 #18 runs #1's register plan on its projected head to S = 64;
    # past it #1's fp32 CUDA-core row code, where #1 runs its score tile
    bits = dtype_name == "fp32" or s <= fa.FULL_TC_REG_MAX_SEQ_LEN
    fwd = dict(rate=rate, seed=seed, save=True, emit_qkv=True, **kw)
    out, qkv, p, pd = fa.attn_fwd_qkvproj_cuda(x, w, b3, mask, **fwd)
    want = fa.attn_fwd_qkvproj_reference(x, w, b3, mask, **fwd)
    errs = {"#18": _qkvproj_forward_err(tag, (out, qkv, p, pd), want, mask,
                                        dtype_name)}
    packed = fa.attn_fwd_packed_cuda(qkv, mask, rate=rate, seed=seed,
                                     save=True, **kw)
    same = all(torch.equal(a, b_) for a, b_ in zip((out, p, pd), packed))
    # where both run one plan (fp32, and bf16 to S = 64) the same bits;
    # past it in bf16 within the forward bound, with the same keep mask
    on_packed = max(_forward_err(f"#18 vs #1 on its qkv {tag}", a, b_,
                                 dtype_name)
                    for a, b_ in zip((out, p, pd), packed))
    live = (p > 0) & (packed[1] > 0)
    same_keep = torch.equal((pd > 0)[live], (packed[2] > 0)[live])
    # the mode that keeps no qkv (the backward re-projects) gives the bits
    # of the one that does
    kept = fwd.pop("emit_qkv")
    no_emit = fa.attn_fwd_qkvproj_cuda(x, w, b3, mask, **fwd)
    fwd["emit_qkv"] = kept
    same_modes = no_emit[1] is None and all(
        torch.equal(a, no_emit[i]) for a, i in ((out, 0), (p, 2), (pd, 3)))
    on_plain = _forward_err(f"#18 vs #1 on the plain qkv {tag}", out,
                            fa.attn_fwd_packed_cuda(want[1], mask, rate=rate,
                                                    seed=seed, **kw),
                            "bf16")
    print(f"#18 vs plain {tag}: out/qkv/p/pd max_abs_err={errs['#18']:.3e}"
          + _check_keep(fa, "#18", seed, p, pd, rate, tag)
          + f"; vs #1 on its emitted qkv {on_packed:.3e} (identical bits "
          f"{same}, the same keep mask {same_keep}); = #18 keeping no qkv: "
          f"{same_modes}; vs #1 on the plain projection's qkv "
          f"{on_plain:.3e}")
    if not same_keep or (bits and not same):
        raise AssertionError(f"#18 and #1 on its qkv differ ({tag})")
    if not same_modes:
        raise AssertionError(f"#18 with and without the emitted qkv differ "
                             f"({tag})")

    runs = {"#19 from qkv": lambda: fa.attn_bwd_qkvproj_cuda(
                p, pd, qkv, w, b3, g, recompute=False, **kw),
            "#19 from x": lambda: fa.attn_bwd_qkvproj_cuda(
                p, pd, x, w, b3, g, recompute=True, **kw)}
    got = {name: run() for name, run in runs.items()}
    if not all(torch.equal(a, b_) for a, b_ in zip(*got.values())):
        raise AssertionError(f"#19 from x and from #18's qkv differ ({tag})")
    # bf16 #19 runs #3's compute half on #3's tiles: #3's dqkv, bit for bit
    as_three = dtype_name == "fp32" or torch.equal(
        got["#19 from qkv"][0],
        fa.attn_bwd_packed_saved_cuda(p, pd, qkv, g, **kw))
    if not as_three:
        raise AssertionError(f"bf16 #19's dqkv differs from #3's on the "
                             f"same inputs ({tag})")
    plain = fa.attn_bwd_qkvproj_reference(p, pd, qkv, w, b3, g,
                                          recompute=False, **kw)
    errs["#19 vs plain"] = _qkvproj_grad_errs(
        f"#19 vs plain {tag}", got["#19 from qkv"], plain, dtype_name,
        (p, pd, qkv, g, w, kw), fa)
    if dtype_name == "fp32":
        errs["#19 vs plain"] = max(errs["#19 vs plain"], _qkvproj_grad_errs(
            f"#19 from x vs plain from x {tag}", got["#19 from x"],
            fa.attn_bwd_qkvproj_reference(p, pd, x, w, b3, g, recompute=True,
                                          **kw), dtype_name, None, fa))
    # autograd through the plain forward, and #19 on that forward's qkv
    xs = x.detach().clone().requires_grad_()
    r_qkv = fa._project(xs, w, b3)
    r_qkv.retain_grad()
    fa.attn_fwd_packed_reference(r_qkv, mask, rate=rate, seed=seed,
                                 **kw).backward(g)
    _, r_p, r_pd = fa.attn_fwd_packed_reference(r_qkv.detach(), mask,
                                                rate=rate, seed=seed,
                                                save=True, **kw)
    on_auto = fa.attn_bwd_qkvproj_cuda(r_p, r_pd, r_qkv.detach(), w, b3, g,
                                       recompute=False, **kw)
    errs["#19 vs autograd"] = _qkvproj_grad_errs(
        f"#19 vs autograd {tag}", on_auto, (r_qkv.grad, xs.grad),
        dtype_name, (r_p, r_pd, r_qkv.detach(), g, w, kw), fa)
    twice = [("#18", (out, qkv, p, pd),
              lambda: fa.attn_fwd_qkvproj_cuda(x, w, b3, mask, **fwd))]
    twice += [(name, got[name], run) for name, run in runs.items()]
    differ = [name for name, first, again in twice
              if not all(torch.equal(a, b_) for a, b_ in zip(first, again()))]
    print(f"#19 {tag} (dqkv, dx): from x = from #18's qkv bit for bit"
          + ("; dqkv = #3's on the same inputs bit for bit"
             if dtype_name == "bf16" else "") + "; "
          + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in errs.items()
                      if k_ != "#18")
          + f"; same seed twice, identical bits {not differ}")
    if differ:
        raise AssertionError(f"{', '.join(differ)} not bit-reproducible "
                             f"({tag})")
    return errs, case


def check_qkvproj_serving_mode(rng, fa):
    """#18 as the serving path runs it (bf16 B=128 S=50, rate 0, nothing
    saved) against its plain version and against its own saved-probs mode
    (the same output bits); then the keep mask of the mode that saves
    nothing (rate 0.1), read off the output: with W's and b's q and k
    columns zero the scores are uniform over the real keys, and x_j = e_j
    with W's v columns the identity gives v_j = e_j, so out[q, h·Dh + j] is
    the dropped prob of key j. Returns the max error."""
    import torch

    x, w, b3, mask, _, _, kw = qkvproj_case(rng, "bf16", BATCH, S_SERVE, 12)
    out = fa.attn_fwd_qkvproj_cuda(x, w, b3, mask, **kw)[0]
    err = _forward_err("#18 serving", out, fa.attn_fwd_qkvproj_reference(
        x, w, b3, mask, **kw)[0], "bf16")
    if not torch.equal(out, fa.attn_fwd_qkvproj_cuda(
            x, w, b3, mask, save=True, **kw)[0]):
        raise AssertionError("#18's serving and saved-probs outputs differ")
    b, h, dh = 4, 12, 64
    d = h * dh
    keys = torch.arange(S_SERVE, device="cuda")
    x = torch.zeros((b, S_SERVE, d), device="cuda", dtype=torch.bfloat16)
    x[:, keys, keys] = 1.0
    w_rows = torch.zeros((3 * d, d), device="cuda", dtype=torch.bfloat16)
    for hh in range(h):
        w_rows[2 * d + hh * dh + keys, keys] = 1.0
    b3 = torch.zeros(3 * d, device="cuda", dtype=torch.bfloat16)
    mask = torch.from_numpy(_ragged_mask(rng, b, S_SERVE)).cuda().float()
    seed = int(rng.integers(0, 2 ** 63 - 1))
    out = fa.attn_fwd_qkvproj_cuda(x, w_rows.t(), b3, mask, n_heads=h,
                                   scale=0.125, rate=RATE, seed=seed)[0]
    dropped = out.float().view(b, S_SERVE, h, dh)[..., :S_SERVE]
    keep = fa.dropout_keep_mask(seed, b, h, S_SERVE, S_SERVE, RATE,
                                out.device)
    live = (mask[:, None, None, :] > 0).expand_as(keep)
    same = torch.equal((dropped.permute(0, 2, 1, 3) > 0)[live], keep[live])
    print(f"#18 serving bf16 B={BATCH} S={S_SERVE} rate 0 vs plain: "
          f"max_abs_err={err:.3e}, = its saved-probs output bit for bit; "
          f"the no-save dropout mode at rate {RATE}: keep mask read off the "
          f"output = plain Philox mask on the {int(live.sum())} live probs: "
          f"{same}")
    if not same:
        raise AssertionError("#18's no-save keep mask differs from the "
                             "plain Philox mask")
    return err


def check_qkvproj_reach(rng, fa):
    """bf16 #18 at the last S its plan takes without a gradient
    (``QKVPROJ_FWD_REACH``: the head [S][3·Dh] beside #1's row plan), with
    saved probs, the emitted qkv and dropout, against its plain version
    within the phase-3 bounds, its keep mask the plain Philox mask's; then
    one S further is refused. Returns the max error."""
    s = QKVPROJ_FWD_REACH
    x, w, b3, mask, _, seed, kw = qkvproj_case(rng, "bf16", 2, s, 12)
    tag = f"bf16 B=2 S={s} H=12 Dh=64 rate={RATE} (the reach)"
    fwd = dict(rate=RATE, seed=seed, save=True, emit_qkv=True, **kw)
    got = fa.attn_fwd_qkvproj_cuda(x, w, b3, mask, **fwd)
    err = _qkvproj_forward_err(tag, got, fa.attn_fwd_qkvproj_reference(
        x, w, b3, mask, **fwd), mask, "bf16")
    if not fa.qkvproj_fits(s, 64, 2, False) or fa.qkvproj_fits(s + 1, 64, 2,
                                                               False):
        raise AssertionError(f"qkvproj_fits' bf16 reach moved from S={s}")
    print(f"#18 vs plain {tag}: out/qkv/p/pd max_abs_err={err:.3e}"
          + _check_keep(fa, "#18", seed, got[2], got[3], RATE, tag))
    return err


def qkvproj_bound(kind, b, s, h, dh, itemsize, rate=0.0, save=False,
                  recompute=True):
    """The bound of #18 (``fwd``) or #19 at [B, S, H, Dh], the projection's
    operations included: #18 reads x, W, b3 and the mask and writes out
    (and p, pd with ``save``): 2·B·S·D·3D projection operations plus QKᵀ
    and PV; #19 reads p, pd, its source (x, or the saved qkv), W and g and
    writes dqkv and dx: the re-projection (with ``recompute``), dV, d(pd),
    dQ, dK and the dx product; #19's dx launch alone (``dx``) reads dqkv
    and W and writes dx. Products on the bf16 tensor cores."""
    d = h * dh
    x, w = b * s * d * itemsize, (3 * d * d + 3 * d) * itemsize
    proj = 2 * b * s * d * 3 * d
    dot = 2 * b * h * s * s * dh
    probs = b * h * s * s * itemsize * (2 if rate > 0 else 1)
    if kind == "dx":
        return _bound(3 * x + 3 * d * d * itemsize + x, proj, BF16_FLOPS)
    if kind == "fwd":
        n_bytes = x + w + b * s * 4 + x + (probs if save else 0)
        return _bound(n_bytes, proj + 2 * dot, BF16_FLOPS)
    src = x if recompute else 3 * x
    n_bytes = probs + src + w + x + 3 * x + x
    return _bound(n_bytes, (proj if recompute else 0) + 4 * dot + proj,
                  BF16_FLOPS)


def time_qkvproj_kernels(fa, case, card):
    """#18 and #19 against their plain versions in alternating rounds, beside
    the split structure they replace (``F.linear`` + #1, and #3 + the dx
    ``torch.matmul``) and, at rate 0, the library calls (``F.linear`` +
    SDPA, and its autograd backward to x): #18 at the serving shape (B=128,
    rate 0, nothing saved) and at the training shape (B=256, rate 0.1,
    saved probs); #19 at B=256 re-projecting and from the saved qkv at rate
    0.1, and re-projecting at rate 0; #19's dx launch alone beside
    ``torch.matmul(dqkv, w_rows)`` (context only: the library row for that
    product). Returns {name: entry}."""
    import torch
    import torch.nn.functional as F

    x, w, b3, mask, g, seed, kw = case
    h = kw["n_heads"]
    b, s, d = x.shape
    w_rows = w.t()
    _, qkv, p, pd = fa.attn_fwd_qkvproj_cuda(x, w, b3, mask, rate=RATE,
                                             seed=seed, save=True,
                                             emit_qkv=True, **kw)
    _, _, p0, _ = fa.attn_fwd_qkvproj_cuda(x, w, b3, mask, save=True, **kw)
    xb, mb = x[:BATCH], mask[:BATCH]
    bias = ((1.0 - mb) * -10000.0).to(x.dtype)[:, None, None, :]

    def lib_fwd():
        q, k, v = (F.linear(xb, w_rows) + b3).view(
            BATCH, s, 3, h, d // h).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                              scale=kw["scale"])

    def split_fwd(xx, mm, **extra):
        return lambda: fa.attn_fwd_packed_cuda(F.linear(xx, w_rows) + b3,
                                               mm, **kw, **extra)

    def split_bwd(pp, ppd):
        def run():
            dqkv = fa.attn_bwd_packed_saved_cuda(pp, ppd, qkv, g, **kw)
            return dqkv, torch.matmul(dqkv, w_rows)
        return run

    def lib_bwd():
        xs = x.detach().clone().requires_grad_()
        out = sdpa_call(F.linear(xs, w_rows) + b3, mask, h,
                        kw["scale"])[1]
        return lambda: torch.autograd.grad(out, xs, g, retain_graph=True)

    dqkv = fa.attn_bwd_qkvproj_cuda(p, pd, qkv, w, b3, g, recompute=False,
                                    **kw)[0]
    w_dx = w_rows.contiguous()
    dx = torch.empty_like(x)

    def dx_kernel():
        fa._launch("attn_bwd_qkvproj_dx", dqkv.data_ptr(), w_dx.data_ptr(),
                   dx.data_ptr(), b * s, d, 1, device=x.device)

    modes = {
        ("attn_bwd_qkvproj", "dx launch alone", b): (
            dx_kernel,
            lambda: torch.matmul(dqkv.float(), w_dx.float()).to(dqkv.dtype),
            None, qkvproj_bound("dx", b, s, h, 64, 2),
            lambda: torch.matmul(dqkv, w_dx)),
        ("attn_fwd_qkvproj", "serving rate 0", BATCH): (
            lambda: fa.attn_fwd_qkvproj_cuda(xb, w, b3, mb, **kw),
            lambda: fa.attn_fwd_qkvproj_reference(xb, w, b3, mb, **kw),
            split_fwd(xb, mb), qkvproj_bound("fwd", BATCH, s, h, 64, 2),
            lib_fwd),
        ("attn_fwd_qkvproj", "training rate 0.1, saved probs", b): (
            lambda: fa.attn_fwd_qkvproj_cuda(x, w, b3, mask, rate=RATE,
                                             seed=seed, save=True, **kw),
            lambda: fa.attn_fwd_qkvproj_reference(x, w, b3, mask, rate=RATE,
                                                  seed=seed, save=True,
                                                  **kw),
            split_fwd(x, mask, rate=RATE, seed=seed, save=True),
            qkvproj_bound("fwd", b, s, h, 64, 2, RATE, save=True), None),
        ("attn_bwd_qkvproj", "training rate 0.1, re-projecting", b): (
            lambda: fa.attn_bwd_qkvproj_cuda(p, pd, x, w, b3, g,
                                             recompute=True, **kw),
            lambda: fa.attn_bwd_qkvproj_reference(p, pd, x, w, b3, g,
                                                  recompute=True, **kw),
            split_bwd(p, pd), qkvproj_bound("bwd", b, s, h, 64, 2, RATE),
            None),
        ("attn_bwd_qkvproj", "training rate 0.1, from the saved qkv", b): (
            lambda: fa.attn_bwd_qkvproj_cuda(p, pd, qkv, w, b3, g,
                                             recompute=False, **kw),
            lambda: fa.attn_bwd_qkvproj_reference(p, pd, qkv, w, b3, g,
                                                  recompute=False, **kw),
            split_bwd(p, pd), qkvproj_bound("bwd", b, s, h, 64, 2, RATE,
                                            recompute=False), None),
        ("attn_bwd_qkvproj", "rate 0, re-projecting", b): (
            lambda: fa.attn_bwd_qkvproj_cuda(p0, p0, x, w, b3, g,
                                             recompute=True, **kw),
            lambda: fa.attn_bwd_qkvproj_reference(p0, p0, x, w, b3, g,
                                                  recompute=True, **kw),
            split_bwd(p0, p0), qkvproj_bound("bwd", b, s, h, 64, 2),
            lib_bwd()),
    }
    out = {}
    for (name, mode, bb), (run_k, run_p, run_s, bound, lib) in modes.items():
        kt, pt = _alternate(run_p, run_k, 20)
        split_ms = None
        if run_s is not None:
            _time_ms(run_s, 3)
            split_ms = float(np.mean([_time_ms(run_s, 20)
                                      for _ in range(2)]))
        # No one PyTorch call computes the projection and the attention
        # together (library_ms null); split_ms is the structure #18/#19
        # replace, linear_sdpa_ms the two library calls at rate 0; the dx
        # launch's matmul_ms is cuBLAS's product of the same operands.
        entry = {"ms": float(np.mean(kt)), "plain_ms": float(np.mean(pt)),
                 "bound_ms": bound[0], "bound_by": bound[1],
                 "library_ms": None, "split_ms": split_ms}
        note = ""
        if run_s is None:
            _time_ms(lib, 3)
            entry["matmul_ms"] = float(np.mean(
                [_time_ms(lib, 20) for _ in range(2)]))
            note = f", torch.matmul(dqkv, w_rows) {entry['matmul_ms']:.4f} ms"
        elif lib is not None:
            _time_ms(lib, 3)
            entry["linear_sdpa_ms"] = float(np.mean(
                [_time_ms(lib, 20) for _ in range(2)]))
            what = ("F.linear + SDPA" if name == "attn_fwd_qkvproj"
                    else "F.linear + SDPA autograd backward to x")
            note = f", {what} {entry['linear_sdpa_ms']:.4f} ms"
        label = f"{mode}, bf16 B={bb} S={s} H={h} Dh=64"
        split = ("" if split_ms is None
                 else f", split structure {split_ms:.4f} ms")
        print(f"{name} {label} on {card}: kernel {kt} ms, plain {pt} ms per "
              f"call{split}{note}; bound {bound[0]:.4f} ms ({bound[1]})")
        if mode in ("serving rate 0", "training rate 0.1, re-projecting"):
            out[name] = dict(entry, shape=label, modes=dict(
                out.get(name, {}).get("modes", {})))
        else:
            out.setdefault(name, {"modes": {}})["modes"][label] = entry
    return out


def _qkvproj_bert(cfg, ds, seed, dtype=None, weights=None):
    """bert-base MAG-BERT with MOSI dims on the card, its weights drawn
    from ``seed`` or loaded from ``weights``; the gate's dropout 0 when the
    config's is."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import MultimodalConfig
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )

    mm = (MultimodalConfig() if cfg.hidden_dropout_prob
          else MultimodalConfig(dropout_prob=0.0))
    model = MagBertForSequenceClassification(
        cfg, mm, ds.visual_dim, ds.acoustic_dim, dtype or torch.bfloat16,
        device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(seed))
    if weights is not None:
        model.load_state_dict(weights)
    return model


def qkvproj_serving(args, rng, fa, card):
    """Phase 4i: ``serving_path`` over bert-base with ``qkv_fusion`` (bf16,
    batch 128): #18 once per layer per batch and nothing else, against the
    einsum model on the same weights. Returns the launch counts."""
    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.serving import Predictor

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                              attention_impl="fused", qkv_fusion=True)
    model = _qkvproj_bert(cfg, ds, args.seed + 61)
    split = make_split(rng, N_TEST, S_SERVE, cfg.vocab_size, ds.visual_dim,
                       ds.acoustic_dim)
    requests = [make_split(rng, REQUEST_SIZE, S_SERVE, cfg.vocab_size,
                           ds.visual_dim, ds.acoustic_dim).as_tuple()[:5]
                for _ in range(N_REQUESTS)]
    einsum = dataclasses.replace(cfg, attention_impl="einsum",
                                 qkv_fusion=False)
    return serving_path(
        fa, card, "bert-base qkv_fusion", Predictor(model, batch_size=BATCH),
        lambda: _qkvproj_bert(einsum, ds, 0, weights=model.state_dict()),
        split, requests, "attn_fwd_qkvproj", cfg.num_hidden_layers)


def qkvproj_driver_path(args, rng, fa, card):
    """Phase 6h: ``driver.main --attention_impl fused --qkv_fusion`` and
    ``... --qkv_residual`` at bert-base (bf16, one epoch over 96/48/48):
    exit 0, finite losses, #18 once per layer per batch, #19 two launches
    per layer per train step, nothing else; one step under
    ``FUSED_ATTN_SAVE=0`` (#1, #2, no #18/#19); the dropout-0 gradient
    check (``qkvproj_grad_check``); one profiled B=256 step with and
    without ``qkv_fusion``. Returns {path: counts}."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
        make_train_step,
    )
    from bert_multimodal_transformer_tpu_torch.utils.profiling import (
        device_time_by_kernel,
    )

    layers = BertConfig.bert_base_uncased().num_hidden_layers
    n_train = -(-LONG_SPLITS[0] // TRAIN_BATCH)
    n_eval = sum(-(-n // EVAL_BATCH) for n in LONG_SPLITS[1:])
    want = _want(fa, attn_fwd_qkvproj=layers * (n_train + n_eval),
                 attn_bwd_qkvproj=2 * layers * n_train)
    counts = {}
    for path, extra in (("qkvproj_driver", []),
                        ("qkvproj_driver_residual", ["--qkv_residual"])):
        argv = ["--model", "bert-base-uncased", "--dataset", "mosi",
                "--synthetic", "--synthetic_sizes", *map(str, LONG_SPLITS),
                "--n_epochs", "1", "--attention_impl", "fused",
                "--qkv_fusion", *extra, "--compute_dtype", "bfloat16",
                "--seed", str(args.seed)]
        counts[path] = run_driver(argv, fa, card)
        print(f"kernel launches in {path}: {counts[path]} (want {want}: "
              f"{n_train} train + {n_eval} dev/test batches, {layers} "
              "layers, #19 two launches a call)")
        if counts[path] != want:
            raise AssertionError(f"{path} launches {counts[path]} != {want}")

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                              attention_impl="fused", qkv_fusion=True)
    step = make_train_step()
    state = Trainer(model=_qkvproj_bert(cfg, ds, args.seed + 62),
                    tx=make_optimizer(1e-5, 10, 0.1)
                    ).create_state_from_params(None, args.seed)
    batch = _device_batch(make_split(rng, TRAIN_BATCH, S_SERVE,
                                     cfg.vocab_size, ds.visual_dim,
                                     ds.acoustic_dim).as_tuple())
    os.environ["FUSED_ATTN_SAVE"] = "0"
    _zero_counts(fa)
    try:
        loss = float(step(state, batch))
    finally:
        os.environ.pop("FUSED_ATTN_SAVE")
    counts["qkvproj_recompute_step"] = _counts(fa)
    want = _want(fa, attn_fwd_packed=layers, attn_bwd_packed=layers)
    print(f"one qkv_fusion train step under FUSED_ATTN_SAVE=0: loss "
          f"{loss:.6f}, launches {counts['qkvproj_recompute_step']} (want "
          f"{want}: the split structure)")
    if counts["qkvproj_recompute_step"] != want or not math.isfinite(loss):
        raise AssertionError(f"FUSED_ATTN_SAVE=0 step: "
                             f"{counts['qkvproj_recompute_step']}, {loss}")
    del state
    qkvproj_grad_check(args, rng, fa)

    batch = _device_batch(make_split(rng, BENCH_BATCH, S_SERVE,
                                     cfg.vocab_size, ds.visual_dim,
                                     ds.acoustic_dim).as_tuple())
    weights = _qkvproj_bert(cfg, ds, args.seed + 63).state_dict()
    for fusion in (True, False):
        st = Trainer(model=_qkvproj_bert(
            dataclasses.replace(cfg, qkv_fusion=fusion), ds, 0,
            weights=weights), tx=make_optimizer(1e-5, 10, 0.1)
        ).create_state_from_params(None, args.seed)
        step(st, batch)
        torch.cuda.synchronize()
        print(f"one training step, bf16 bert-base B={BENCH_BATCH} "
              f"S={S_SERVE} qkv_fusion={fusion} on {card}:")
        _print_profile(device_time_by_kernel(lambda: step(st, batch), 1), 1,
                       "step")
        del st
    return counts


def qkvproj_grad_check(args, rng, fa):
    """Phase 6h's gradient check: at dropout 0, from one copy of the
    weights, one training step (bert-base, B=48, S=50) with ``qkv_fusion``
    (#18/#19, both backward variants) against the split fused step (the
    dense projection, #1/#3), leaf by leaf within QKVPROJ_GRAD_TOL in fp32;
    the same step with dx, then the dK columns of dqkv, zeroed in #19's
    output must read past it. In bf16 the gaps of both fused steps to the
    einsum step, side by side."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
        make_train_step,
    )

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                              attention_impl="fused",
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    weights = _qkvproj_bert(cfg, ds, args.seed + 64).state_dict()
    data = _device_batch(make_split(rng, TRAIN_BATCH, S_SERVE,
                                    cfg.vocab_size, ds.visual_dim,
                                    ds.acoustic_dim).as_tuple())
    step = make_train_step()

    def one_step(dtype, **kw):
        m = _qkvproj_bert(dataclasses.replace(cfg, **kw), ds, 0, dtype,
                          weights)
        st = Trainer(model=m, tx=make_optimizer(1e-5, 10, 0.1)
                     ).create_state_from_params(None, args.seed)
        step(st, data)
        return _grad_pieces(m)

    fp32 = {"split (#1/#3)": one_step(torch.float32)}
    for name, residual in (("qkv_fusion (#19 re-projecting)", False),
                           ("qkv_fusion, qkv_residual", True)):
        fp32[name] = one_step(torch.float32, qkv_fusion=True,
                              qkv_residual=residual)
    real = fa.attn_bwd_qkvproj
    faults = ("planted fault: dx zeroed in #19",
              "planted fault: dK zeroed in #19's dqkv")
    for name in faults:
        def faulty(*a, _name=name, **kw):
            dqkv, dx = real(*a, **kw)
            if "dx" in _name:
                return dqkv, torch.zeros_like(dx)
            d = dx.shape[-1]
            dqkv = dqkv.clone()
            dqkv[..., d:2 * d] = 0
            return dqkv, dx

        fa.attn_bwd_qkvproj = faulty
        try:
            fp32[name] = one_step(torch.float32, qkv_fusion=True)
        finally:
            fa.attn_bwd_qkvproj = real
    for name, grads in list(fp32.items())[1:]:
        gaps = _grad_gaps(grads, fp32["split (#1/#3)"])
        print(f"  fp32 step-1 gradients, {name} vs the split fused step: "
              "worst pieces " + ", ".join(f"{k_} {v_:.3e}"
                                          for k_, v_ in gaps[:4])
              + f" (bound {QKVPROJ_GRAD_TOL})")
        if (gaps[0][1] > QKVPROJ_GRAD_TOL) != name.startswith("planted"):
            raise AssertionError(f"fp32 step-1 gradients, {name}: worst gap "
                                 f"{gaps[0]} against {QKVPROJ_GRAD_TOL}")
    bf16 = {"einsum": one_step(torch.bfloat16, attention_impl="einsum"),
            "split fused": one_step(torch.bfloat16),
            "qkv_fusion": one_step(torch.bfloat16, qkv_fusion=True)}
    for name in ("split fused", "qkv_fusion"):
        gaps = _grad_gaps(bf16[name], bf16["einsum"])
        print(f"  bf16 step-1 gradients, {name} vs einsum: worst pieces "
              + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in gaps[:4]))


CKPT_SPLITS = (144, 48, 48)   # phase 6i: 3 train steps an epoch at 48,
#                               one dev and one test batch at 128
CKPT_TIMING_STEPS = 3         # steps timed with and without a save each


def _ckpt_run(argv, fa, card, want, tag, phase="6i"):
    """``driver.main(argv)`` in this process: exit 0 and exactly the
    launch counts ``want`` (``_want``'s keywords). Returns (stdout,
    counts)."""
    import io

    import torch

    from bert_multimodal_transformer_tpu_torch import driver

    os.environ.setdefault("WANDB_MODE", "disabled")
    stdout = io.StringIO()
    _zero_counts(fa)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = driver.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts(fa)
    text = stdout.getvalue()
    print(f"{phase} {tag}: exit {rc}, {wall:.2f} s wall on {card}")
    if rc != 0:
        print(text)
        raise AssertionError(f"{phase} {tag}: driver.main exited {rc}")
    want = _want(fa, **want)
    if counts != want:
        raise AssertionError(f"{phase} {tag}: launch counts {counts} != "
                             f"{want}")
    for line in text.splitlines():
        if line.startswith("epoch:"):
            fields = dict(kv.split(":", 1) for kv in line.split(", "))
            for key in ("train_loss", "valid_loss"):
                if not math.isfinite(float(fields[key])):
                    raise AssertionError(f"{phase} {tag}: non-finite {key}")
    return text, counts


def _same_checkpoints(a_dir, b_dir, tag, phase="6i"):
    """The latest checkpoints of two runs hold the same bits: params,
    moments, count, generator state and step. Names what differs."""
    import torch

    from bert_multimodal_transformer_tpu_torch.utils.checkpoint import (
        TRAIN_STATE_FILE,
        CheckpointManager,
    )

    a, b = CheckpointManager(a_dir), CheckpointManager(b_dir)
    if a.latest_step() != b.latest_step():
        raise AssertionError(f"{phase} {tag}: latest steps "
                             f"{a.latest_step()} != {b.latest_step()}")
    pa, pb = a.restore_params(), b.restore_params()
    ta, tb = (torch.load(os.path.join(m.directory, str(m.latest_step()),
                                      TRAIN_STATE_FILE), weights_only=True)
              for m in (a, b))
    differ = sorted(k for k in pa if not torch.equal(pa[k], pb[k]))
    for key in ("exp_avg", "exp_avg_sq"):
        ma, mb = ta["opt_state"][key], tb["opt_state"][key]
        differ += sorted(f"{key}:{k}" for k in ma
                         if not torch.equal(ma[k], mb[k]))
    if (ta["step"], ta["opt_state"]["count"]) != (
            tb["step"], tb["opt_state"]["count"]):
        differ.append("step/count")
    if not torch.equal(ta["rng"], tb["rng"]):
        differ.append("rng")
    print(f"{phase} {tag}: {len(pa)} params, their moments, count, rng and "
          f"step at step {a.latest_step()}: "
          f"{'bit for bit equal' if not differ else 'DIFFER'}")
    if differ:
        raise AssertionError(f"{phase} {tag}: {len(differ)} entries differ, "
                             f"e.g. {differ[:8]}")


def _fresh_bert(seed, dtype, synthetic_vocab=True):
    """The model the driver builds at bert-base width from ``--synthetic
    --seed seed`` (its vocabulary, the fused attention and gate), with the
    params ``Trainer.init_state(seed)`` draws; bert-base's own vocabulary
    of 30522 when not ``synthetic_vocab``."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
        MultimodalConfig,
    )
    from bert_multimodal_transformer_tpu_torch.data import synthetic
    from bert_multimodal_transformer_tpu_torch.data.tokenization import (
        WordPieceTokenizer,
    )
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )

    ds = DatasetConfig.mosi()
    vocab = WordPieceTokenizer.from_wordlist(synthetic.vocabulary())
    cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                              attention_impl="fused")
    if synthetic_vocab:
        cfg = dataclasses.replace(cfg, vocab_size=max(vocab.vocab_size, 128))
    model = MagBertForSequenceClassification(
        cfg, MultimodalConfig(use_fused_kernel=True), ds.visual_dim,
        ds.acoustic_dim, dtype, device="cuda")
    model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    return model


def _check_warm_start(ckpt_dir, hf_path, fresh, layers, tag):
    """The warm-started run's checkpoint (one step at learning rate 0,
    which moves no param): the encoder equal bit for bit to the HF file
    mapped onto the port's names, MAG and the classifier equal to the
    driver's fresh draw, the encoder not."""
    import torch

    from bert_multimodal_transformer_tpu_torch.utils import convert
    from bert_multimodal_transformer_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    got = CheckpointManager(ckpt_dir).restore_params()
    hf = convert._strip_prefix(convert.load_torch_state_dict(hf_path))
    mapped = convert.convert_bert_params(hf, layers)
    fresh_sd = fresh.state_dict()
    bad = [k for k, v in mapped.items() if not torch.equal(got[k], v)]
    head = [k for k in got if k not in mapped]
    if sorted(head) != sorted(k for k in fresh_sd if ".MAG." in k
                              or k.startswith("classifier.")):
        raise AssertionError(f"6i {tag}: not loaded from the file: {head}")
    bad += [k for k in head if not torch.equal(got[k], fresh_sd[k].cpu())]
    same_enc = [k for k in mapped if torch.equal(got[k],
                                                 fresh_sd[k].cpu())]
    print(f"6i {tag}: {len(mapped)} encoder tensors equal to {hf_path} "
          f"bit for bit, {len(head)} MAG/classifier tensors at the fresh "
          f"init: {'yes' if not bad else 'NO'}")
    if bad or same_enc:
        raise AssertionError(f"6i {tag}: differ {bad[:8]}, encoder left "
                             f"fresh {same_enc[:8]}")


def checkpoint_timing(args, card):
    """The save and restore wall time of a bert-base checkpoint (bf16
    compute, fp32 params and moments, after one step), its bytes, and one
    train step's wall time at the driver's B=48 S=50 with and without a
    save after it (``--save_every_steps 1``). The restore reads files just
    written: warm in the page cache."""
    import shutil
    import tempfile

    import torch

    from bert_multimodal_transformer_tpu_torch.config import DatasetConfig
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
    )
    from bert_multimodal_transformer_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    ds = DatasetConfig.mosi()
    model = _fresh_bert(args.seed, torch.bfloat16,
                        synthetic_vocab=False)
    trainer = Trainer(model=model, tx=make_optimizer(1e-5, 100))
    state = trainer.init_state(args.seed)
    batch = _device_batch(make_split(
        np.random.default_rng([args.seed, 23]), TRAIN_BATCH, S_SERVE,
        model.config.vocab_size, ds.visual_dim, ds.acoustic_dim).as_tuple())
    trainer._train_step(state, batch)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    root = tempfile.mkdtemp(prefix="ckpt_timing_")
    try:
        mgr = CheckpointManager(root)
        t0 = time.perf_counter()
        mgr.save(state, step=state.step)
        save_s = time.perf_counter() - t0
        n_bytes = mgr.step_bytes(state.step)
        t0 = time.perf_counter()
        mgr.restore(state, state.step)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mgr.restore_params()
        params_s = time.perf_counter() - t0

        def steps(save):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CKPT_TIMING_STEPS):
                trainer._train_step(state, batch)
                if save:
                    mgr.save(state, step=state.step)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / CKPT_TIMING_STEPS * 1e3

        rounds = [steps(s) for s in (False, True, True, False)]
    finally:
        shutil.rmtree(root)
    out = {"params": n_params, "bytes": n_bytes, "save_s": save_s,
           "restore_s": restore_s, "restore_params_s": params_s,
           "step_ms": (rounds[0] + rounds[3]) / 2,
           "step_with_save_ms": (rounds[1] + rounds[2]) / 2}
    print(f"6i checkpoint at bert-base on {card}: {n_params} params, "
          f"{n_bytes} bytes on disk; save {save_s:.3f} s, restore "
          f"{restore_s:.3f} s (params only {params_s:.3f} s; warm page "
          f"cache); a B={TRAIN_BATCH} S={S_SERVE} train step "
          f"{out['step_ms']:.1f} ms, with a save after it "
          f"{out['step_with_save_ms']:.1f} ms (rounds {rounds})")
    return out


def checkpoint_driver_path(args, fa, card):
    """Phase 6i: checkpoint, resume and warm start through ``driver.main``
    at bert-base, S=50, bf16, ``--attention_impl fused --use_fused_mag``,
    over 144/48/48 (3 steps an epoch, 2 epochs), in a temporary directory
    deleted afterwards: two uninterrupted runs bit for bit equal; a
    mid-epoch stop (``--save_every_steps 1 --max_steps 2``) and an epoch
    stop (``--max_steps 3``), each ``--resume``d to the same state bit for
    bit; ``--export_hf`` (.bin from the second straight run, .safetensors
    from the epoch resume), each warm-starting a fresh run whose encoder
    is the file's and whose MAG and classifier are the fresh draw;
    ``--predict_only --wire_dtype bfloat16`` with finite scores; a
    MAG-XLNet mid-epoch resume. Then ``checkpoint_timing``. Returns
    ({path: counts}, timing)."""
    import shutil
    import tempfile

    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        XLNetConfig,
    )

    layers = BertConfig.bert_base_uncased().num_hidden_layers
    xl_layers = XLNetConfig.xlnet_base_cased().n_layer

    def bert(steps, evals):
        """#1/#3/#25/#26 launches of a bert-base run with ``steps`` train
        steps and ``evals`` eval batches (a launch a layer a batch; the
        gate once a batch)."""
        return dict(attn_fwd_packed=layers * (steps + evals),
                    attn_bwd_packed_saved=layers * steps,
                    mag_fwd=steps + evals, mag_bwd=steps)

    base = ["--model", "bert-base-uncased", "--dataset", "mosi",
            "--synthetic", "--synthetic_sizes", *map(str, CKPT_SPLITS),
            "--use_fused_mag", "--attention_impl", "fused",
            "--compute_dtype", "bfloat16", "--seed", str(args.seed)]
    two = base + ["--n_epochs", "2"]
    n_steps = CKPT_SPLITS[0] // TRAIN_BATCH
    evals = sum(-(-n // EVAL_BATCH) for n in CKPT_SPLITS[1:])
    paths = {"checkpoint_resume": {}, "checkpoint_warm_start": {},
             "checkpoint_predict": {}, "checkpoint_xlnet": {}}

    def add(path, counts):
        for k, v in counts.items():
            paths[path][k] = paths[path].get(k, 0) + v

    root = tempfile.mkdtemp(prefix="chip_smoke_6i_")
    try:
        d = {name: os.path.join(root, name) for name in (
            "straight", "twin", "mid", "epoch", "warm_bin", "warm_st",
            "xlnet")}
        hf_bin = os.path.join(root, "hf.bin")
        hf_st = os.path.join(root, "hf.safetensors")
        full = bert(2 * n_steps, 2 * evals)
        add("checkpoint_resume", _ckpt_run(
            two + ["--checkpoint_dir", d["straight"]], fa, card, full,
            "straight")[1])
        add("checkpoint_resume", _ckpt_run(
            two + ["--checkpoint_dir", d["twin"], "--export_hf", hf_bin],
            fa, card, full, "straight twin, --export_hf .bin")[1])
        _same_checkpoints(d["straight"], d["twin"], "two uninterrupted runs")
        shutil.rmtree(d["twin"])

        add("checkpoint_resume", _ckpt_run(
            two + ["--checkpoint_dir", d["mid"], "--save_every_steps", "1",
                   "--max_steps", "2"], fa, card, bert(2, 0),
            "mid-epoch stop after 2 steps")[1])
        text, counts = _ckpt_run(
            two + ["--checkpoint_dir", d["mid"], "--resume"], fa, card,
            bert(2 * n_steps - 2, 2 * evals), "mid-epoch resume")
        add("checkpoint_resume", counts)
        if "Resuming at epoch 0, batch 2 (step 2)" not in text:
            raise AssertionError(f"6i: no mid-epoch resume line in {text}")
        _same_checkpoints(d["straight"], d["mid"], "mid-epoch resume")
        shutil.rmtree(d["mid"])

        add("checkpoint_resume", _ckpt_run(
            two + ["--checkpoint_dir", d["epoch"], "--max_steps",
                   str(n_steps)], fa, card, bert(n_steps, evals),
            "stop at epoch 0's end")[1])
        text, counts = _ckpt_run(
            two + ["--checkpoint_dir", d["epoch"], "--resume",
                   "--export_hf", hf_st], fa, card,
            bert(n_steps, evals),
            "epoch resume, --export_hf .safetensors")
        add("checkpoint_resume", counts)
        if f"Resuming at epoch 1, batch 0 (step {n_steps})" not in text:
            raise AssertionError(f"6i: no epoch resume line in {text}")
        _same_checkpoints(d["straight"], d["epoch"], "epoch resume")
        shutil.rmtree(d["epoch"])

        fresh = _fresh_bert(args.seed, torch.bfloat16)
        for name, hf in (("warm_bin", hf_bin), ("warm_st", hf_st)):
            add("checkpoint_warm_start", _ckpt_run(
                base + ["--n_epochs", "1", "--checkpoint_dir", d[name],
                        "--pretrained_checkpoint", hf, "--learning_rate",
                        "0", "--save_every_steps", "1", "--max_steps", "1"],
                fa, card, bert(1, 0),
                f"warm start from {os.path.basename(hf)}")[1])
            _check_warm_start(d[name], hf, fresh, layers, name)
            shutil.rmtree(d[name])
        del fresh

        text, counts = _ckpt_run(
            base + ["--checkpoint_dir", d["straight"], "--predict_only",
                    "--wire_dtype", "bfloat16"], fa, card,
            dict(attn_fwd_packed=layers * (-(-CKPT_SPLITS[2] // EVAL_BATCH)),
                 mag_fwd=-(-CKPT_SPLITS[2] // EVAL_BATCH)),
            "--predict_only --wire_dtype bfloat16")
        add("checkpoint_predict", counts)
        scores = json.loads(text.strip().splitlines()[-1])
        print(f"6i --predict_only: {scores}")
        if (set(scores) != {"test_acc", "test_mae", "test_corr",
                            "test_f_score"}
                or not all(math.isfinite(v) for v in scores.values())):
            raise AssertionError(f"6i: predict_only printed {scores}")

        xl = ["--model", "xlnet-base-cased", "--dataset", "mosi",
              "--synthetic", "--synthetic_sizes", *map(str, CKPT_SPLITS),
              "--use_fused_mag", "--attention_impl", "fused",
              "--compute_dtype", "bfloat16", "--seed", str(args.seed),
              "--n_epochs", "1", "--checkpoint_dir", d["xlnet"]]
        add("checkpoint_xlnet", _ckpt_run(
            xl + ["--save_every_steps", "1", "--max_steps", "1"], fa, card,
            dict(attn_fwd_rel=xl_layers, attn_bwd_rel_saved=xl_layers,
                 mag_fwd=1,
                 mag_bwd=1), "MAG-XLNet stop after 1 step")[1])
        text, counts = _ckpt_run(
            xl + ["--resume"], fa, card,
            dict(attn_fwd_rel=xl_layers * (n_steps - 1 + evals),
                 attn_bwd_rel_saved=xl_layers * (n_steps - 1),
                 mag_fwd=n_steps - 1 + evals, mag_bwd=n_steps - 1),
            "MAG-XLNet resume")
        add("checkpoint_xlnet", counts)
        if "Resuming at epoch 0, batch 1 (step 1)" not in text or \
                "epoch:0" not in text:
            raise AssertionError(f"6i: MAG-XLNet resume printed {text}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    timing = checkpoint_timing(args, card)
    return paths, timing


# ---- the serving artifact (6j) and rematerialized training (6k) -------------

ARTIFACT_N = N_TEST     # phase 6j: 6 batches of 128, the last one padded
ARTIFACT_PASSES = 3     # timed passes over the split, each side
# Phase 6k's peak-memory readings: (family, S, rel_bias_impl), B=48.
REMAT_MEMORY = (("bert", 512, "auto"), ("xlnet", 1024, "stream"),
                ("xlnet", 1024, "auto"))
REMAT_STEPS = 2         # timed steps a reading, after one warm-up step


def _ex_per_s(fn, n):
    """Examples a second of ``fn()`` over ``n`` examples: the median of
    ``ARTIFACT_PASSES`` passes after one warm-up pass, host clock after a
    synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    rates = []
    for _ in range(ARTIFACT_PASSES):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
    return float(np.median(rates))


def artifact_path(args, rng, fa, card):
    """Phase 6j: the serving artifact (``serving.py``) at bert-base and
    xlnet-base width, MOSI's 47/74, S=50, bf16, random seeded weights,
    over a synthetic test split of 685 rows (6 batches of 128, the last
    padded), each artifact saved, loaded with ``device="cuda"`` and served
    by ``predict_batches``:

    * ``export_portable``: the default artifact of a BERT on the fused
      attention and the fused gate, which exports a copy on the einsum
      path and the plain gate: no kernel launches; its predictions against
      the eager fused ``Predictor`` within ``PRED_ATOL`` (phase 4's band
      between the einsum and the fused predictions); the symbolic batch at
      1 and 5 rows too;
    * ``export_fused``: ``keep_attention_impl=True`` at ``batch_size=128``
      of a fused BERT with the plain gate: #1 = 12 a batch and nothing
      else;
    * ``export_fused_xlnet``: the same at xlnet-base (``rel_bias_impl``
      auto) with the fused gate: #11 = 12 a batch and #25 = 1 a batch.

    The fused artifacts run the eager path's kernels on the same inputs;
    their predictions are held to the eager ``Predictor``'s within
    ``PRED_ATOL`` and the script prints whether they are the same bits.
    Each artifact's ex/s beside the eager ``Predictor``'s. Returns
    ({path: counts}, records)."""
    import shutil
    import tempfile

    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.data.pipeline import (
        BatchIterator,
    )
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )
    from bert_multimodal_transformer_tpu_torch.ops.export_ops import ops_in
    from bert_multimodal_transformer_tpu_torch.serving import (
        Predictor,
        export_forward,
        load_artifact,
        predict_batches,
        save_artifact,
    )

    ds = DatasetConfig.mosi()
    n_batches = -(-ARTIFACT_N // BATCH)
    bert_cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                                   attention_impl="fused")
    xl_cfg = XLNetConfig.xlnet_base_cased()
    layers = bert_cfg.num_hidden_layers
    bert_split = make_split(rng, ARTIFACT_N, S_SERVE, bert_cfg.vocab_size,
                            ds.visual_dim, ds.acoustic_dim)
    xl_split = make_xlnet_split(rng, ARTIFACT_N, S_SERVE, xl_cfg.vocab_size,
                                ds.visual_dim, ds.acoustic_dim)

    def bert(fused_mag):
        return MagBertForSequenceClassification(
            bert_cfg, MultimodalConfig(use_fused_kernel=fused_mag),
            ds.visual_dim, ds.acoustic_dim, torch.bfloat16, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(
                args.seed + 24))

    fused = dict(platforms=("cuda",), keep_attention_impl=True,
                 batch_size=BATCH)
    cases = (
        ("export_portable", lambda: bert(True), bert_split, {}, [], {}),
        ("export_fused", lambda: bert(False), bert_split, fused,
         ["attn_fwd_packed"] * layers,
         {"attn_fwd_packed": layers * n_batches}),
        ("export_fused_xlnet",
         lambda: _xlnet(xl_cfg, MultimodalConfig(injection_index=1,
                                                 use_fused_kernel=True),
                        "fused", args.seed + 24), xl_split, fused,
         ["attn_fwd_rel", "mag_fwd"] + ["attn_fwd_rel"] * (layers - 1),
         {"attn_fwd_rel": layers * n_batches, "mag_fwd": n_batches}),
    )
    paths, records = {}, {}
    root = tempfile.mkdtemp(prefix="chip_smoke_6j_")
    try:
        for name, make, split, kw, ops, want in cases:
            model = make()
            t0 = time.perf_counter()
            program = export_forward(
                model, seq_len=S_SERVE, visual_dim=ds.visual_dim,
                acoustic_dim=ds.acoustic_dim, **kw)
            export_s = time.perf_counter() - t0
            path = os.path.join(root, f"{name}.pt2")
            save_artifact(path, program, meta={"path": name})
            serve = load_artifact(path, device="cuda")
            if ops_in(serve.program) != ops:
                raise AssertionError(f"6j {name}: the graph calls "
                                     f"{ops_in(serve.program)}, not {ops}")

            def loader(split=split):
                return BatchIterator(split, BATCH, shuffle=False,
                                     drop_remainder=False)

            predict_batches(serve, loader())  # warm-up
            torch.cuda.synchronize()
            _zero_counts(fa)
            preds, labels = predict_batches(serve, loader())
            torch.cuda.synchronize()
            counts = _counts(fa)
            print(f"6j {name}: kernel launches {counts}")
            if counts != _want(fa, **want):
                raise AssertionError(f"6j {name}: launch counts {counts} "
                                     f"!= {_want(fa, **want)}")
            if (preds.shape != (ARTIFACT_N,) or not np.isfinite(preds).all()
                    or not np.array_equal(labels, split.label_ids)):
                raise AssertionError(f"6j {name}: bad predictions "
                                     f"{preds.shape}")
            eager = Predictor(model, batch_size=BATCH)
            want_preds = eager.predict_split(split)
            diff = float(np.abs(preds - want_preds).max())
            same = bool(np.array_equal(preds, want_preds))
            print(f"6j {name} vs the eager fused Predictor: max_abs_diff "
                  f"{diff:.3e} (tolerance {PRED_ATOL}), same bits: {same}")
            if not diff <= PRED_ATOL:
                raise AssertionError(f"6j {name}: predictions differ by "
                                     f"{diff} > {PRED_ATOL}")
            if not kw:
                # the symbolic batch: a partial batch of 1 and one of 5
                rows = split.as_tuple()[:5]
                for b in (1, 5):
                    out = serve(*(a[:b] for a in rows)).float().cpu()
                    gap = float(np.abs(out.numpy().reshape(-1)
                                       - preds[:b]).max())
                    if out.shape != (b, 1) or not gap <= PRED_ATOL:
                        raise AssertionError(f"6j {name}: b={b} gives "
                                             f"{tuple(out.shape)}, {gap}")
            artifact_eps = _ex_per_s(
                lambda: predict_batches(serve, loader()), ARTIFACT_N)
            eager_eps = _ex_per_s(lambda: eager.predict_split(split),
                                  ARTIFACT_N)
            size = os.path.getsize(path)
            print(f"6j {name} on {card}: export {export_s:.2f} s, "
                  f"{size} bytes; predict_batches {artifact_eps:.1f} ex/s "
                  f"against the eager Predictor's {eager_eps:.1f} ex/s "
                  f"({ARTIFACT_N} rows, batch {BATCH}, S={S_SERVE}, bf16)")
            paths[name] = counts
            records[name] = {"export_s": export_s, "bytes": size,
                             "ex_per_s": artifact_eps,
                             "eager_ex_per_s": eager_eps,
                             "max_abs_diff": diff, "same_bits": same}
            del model, program, serve, eager
            os.remove(path)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return paths, records


def _remat_model(args, family, s, impl, remat):
    """A fresh bf16 model on the card at bert-base or xlnet-base width
    (MOSI dims, the fused attention and gate, ``rel_bias_impl`` ``impl``),
    its weights drawn from ``args.seed``, and a B=48 batch at length
    ``s``."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )
    from bert_multimodal_transformer_tpu_torch.models.xlnet import (
        MagXLNetForSequenceClassification,
    )

    ds = DatasetConfig.mosi()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    batch_rng = np.random.default_rng([args.seed, 24])
    if family == "bert":
        cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                                  attention_impl="fused")
        model = MagBertForSequenceClassification(
            cfg, MultimodalConfig(use_fused_kernel=True), ds.visual_dim,
            ds.acoustic_dim, torch.bfloat16, remat, device="cuda",
            generator=gen)
        split = make_split(batch_rng, TRAIN_BATCH, s, cfg.vocab_size,
                           ds.visual_dim, ds.acoustic_dim)
    else:
        cfg = dataclasses.replace(XLNetConfig.xlnet_base_cased(),
                                  attention_impl="fused",
                                  rel_bias_impl=impl)
        model = MagXLNetForSequenceClassification(
            cfg, MultimodalConfig(injection_index=1, use_fused_kernel=True),
            ds.visual_dim, ds.acoustic_dim, torch.bfloat16, remat,
            device="cuda", generator=gen)
        split = make_xlnet_split(batch_rng, TRAIN_BATCH, s, cfg.vocab_size,
                                 ds.visual_dim, ds.acoustic_dim)
    return model, _device_batch(split.as_tuple())


def remat_memory(args, fa, card):
    """Phase 6k's readings: one training step's peak memory
    (``torch.cuda.max_memory_allocated`` after a reset, model, AdamW
    moments and batch included) and its time (CUDA events, the mean of
    ``REMAT_STEPS`` steps after one warm-up step) with and without remat,
    for BERT at B=48 S=512 and XLNet at B=48 S=1024 under stream and
    auto. The launch counts show the recompute: every attention forward
    kernel twice a layer a step under remat, every other kernel as often
    as without. Returns ({path: counts}, records)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
    )

    paths, records = {}, {}
    for family, s, impl in REMAT_MEMORY:
        tag = f"{family}_s{s}" + (f"_{impl}" if family == "xlnet" else "")
        reading = {}
        for remat in (False, True):
            model, batch = _remat_model(args, family, s, impl, remat)
            trainer = Trainer(model=model, tx=make_optimizer(1e-5, 100))
            state = trainer.init_state(args.seed)
            trainer._train_step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts(fa)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REMAT_STEPS):
                trainer._train_step(state, batch)
            end.record()
            end.synchronize()
            counts = _counts(fa)
            reading["remat" if remat else "plain"] = {
                "step_ms": start.elapsed_time(end) / REMAT_STEPS,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "counts": counts}
            paths[f"remat_memory_{tag}" + ("" if remat else "_off")] = counts
            del model, trainer, state, batch
            torch.cuda.empty_cache()
        plain, on = reading["plain"]["counts"], reading["remat"]["counts"]
        want = {k: v * (2 if k.startswith("attn_fwd") else 1)
                for k, v in plain.items()}
        if on != want or not any(v and k.startswith("attn_fwd")
                                 for k, v in plain.items()):
            raise AssertionError(f"6k {tag}: remat launches {on}, want "
                                 f"{want}")
        records[tag] = {k: {k_: v_ for k_, v_ in r.items()
                            if k_ != "counts"}
                        for k, r in reading.items()}
        print(f"6k {tag} B={TRAIN_BATCH} on {card}: without remat "
              f"{reading['plain']['step_ms']:.2f} ms a step, peak "
              f"{reading['plain']['peak_gib']:.2f} GiB; with remat "
              f"{reading['remat']['step_ms']:.2f} ms, peak "
              f"{reading['remat']['peak_gib']:.2f} GiB; launches a "
              f"{REMAT_STEPS}-step run {plain} -> {on}")
    return paths, records


def remat_driver_path(args, fa, card):
    """Phase 6k: ``driver.main`` at bert-base, S=50, bf16, rate 0.1,
    ``--attention_impl fused --use_fused_mag``, over 144/48/48 (3 steps at
    B=48, one dev and one test batch), with ``--remat`` and with ``--remat
    --remat_policy dots`` against the same run without: the printed
    losses and the final checkpoint (params, moments, generator) bit for
    bit; #1 twice a layer a step (the recompute), #3, #25 and #26 as
    without. The same for MAG-XLNet ``--remat`` with #11. Then
    ``remat_memory``. Returns ({path: counts}, memory records)."""
    import shutil
    import tempfile

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        XLNetConfig,
    )

    layers = BertConfig.bert_base_uncased().num_hidden_layers
    xl_layers = XLNetConfig.xlnet_base_cased().n_layer
    steps = CKPT_SPLITS[0] // TRAIN_BATCH
    evals = sum(-(-n // EVAL_BATCH) for n in CKPT_SPLITS[1:])

    def want(fwd, bwd, n_layers, remat):
        return {fwd: n_layers * ((2 if remat else 1) * steps + evals),
                bwd: n_layers * steps, "mag_fwd": steps + evals,
                "mag_bwd": steps}

    common = ["--dataset", "mosi", "--synthetic", "--synthetic_sizes",
              *map(str, CKPT_SPLITS), "--n_epochs", "1", "--use_fused_mag",
              "--attention_impl", "fused", "--compute_dtype", "bfloat16",
              "--seed", str(args.seed)]
    runs = (
        ("remat_off", "bert-base-uncased", [],
         want("attn_fwd_packed", "attn_bwd_packed_saved", layers, False)),
        ("remat_full", "bert-base-uncased", ["--remat"],
         want("attn_fwd_packed", "attn_bwd_packed_saved", layers, True)),
        ("remat_dots", "bert-base-uncased",
         ["--remat", "--remat_policy", "dots"],
         want("attn_fwd_packed", "attn_bwd_packed_saved", layers, True)),
        ("remat_xlnet_off", "xlnet-base-cased", [],
         want("attn_fwd_rel", "attn_bwd_rel_saved", xl_layers, False)),
        ("remat_xlnet", "xlnet-base-cased", ["--remat"],
         want("attn_fwd_rel", "attn_bwd_rel_saved", xl_layers, True)),
    )
    paths, epochs = {}, {}
    root = tempfile.mkdtemp(prefix="chip_smoke_6k_")
    try:
        for name, model, extra, launches in runs:
            text, counts = _ckpt_run(
                ["--model", model, *common, *extra, "--checkpoint_dir",
                 os.path.join(root, name)], fa, card, launches, name,
                phase="6k")
            paths[name] = counts
            epochs[name] = [x for x in text.splitlines()
                            if x.startswith("epoch:")]
            print(f"6k {name}: {epochs[name]}")
        for name, ref in (("remat_full", "remat_off"),
                          ("remat_dots", "remat_off"),
                          ("remat_xlnet", "remat_xlnet_off")):
            if epochs[name] != epochs[ref] or len(epochs[name]) != 1:
                raise AssertionError(f"6k {name}: losses {epochs[name]} "
                                     f"!= {epochs[ref]}")
            _same_checkpoints(os.path.join(root, ref),
                              os.path.join(root, name), f"{name} vs {ref}",
                              phase="6k")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    memory_paths, memory = remat_memory(args, fa, card)
    paths.update(memory_paths)
    return paths, memory


# ---- MAG-XLNet tensor parallelism (#11-#13, #20-#24 on head shards) and
# ---- MAG-BERT attention_impl="flash" (#6, #7) ------------------------------

# Phase 3d+'s slice: batch rows from OFFSET_B and heads from OFFSET_H of a
# full call (B=4, H=12), run as their own call at those counter offsets.
OFFSET_B, OFFSET_H = 2, 6
XTP_SERVE_N = 256             # phase 4j: two batches of 128
# Phase 6l's dropout step (fp32, rate 0.1): the two-rank step against the
# one-card fused step, its loss within TP_STEP_TOL["fp32"] and every
# gradient within TP_GRAD_TOL["fp32"]; forcing the head offset to 0 on rank
# 1 (its heads then draw rank 0's mask) must move a gradient past that.
XTP_FAULT = "rank 1's rel kernels at head offset 0"
XTP_S512_BATCH = 8            # phase 6l's one S=512 step (#23, #24)
FLASH_S, FLASH_BATCH = 512, 48
FLASH_SERVE_N = 96            # phase 4k: two batches of 48
# Phase 6m's dropout-0 step through #6/#7 against einsum, fp32: the same
# math summed in other orders through 12 layers moves a gradient by ~1e-5
# of its leaf's scale; a zeroed dK moves the q, k projections' by their
# own.
FLASH_GRAD_TOL = 1e-3


def _sliced(x, b0, h0, dh, kind):
    """Rows b0.. and the heads from h0 of one operand: ``kind`` "flat"
    ([B, L, H·Dh]), "heads" ([B, H, ...]), "rows" ([B, ...]) or "cols"
    ([P, H·Dh])."""
    if kind == "flat":
        return x[b0:, :, h0 * dh:].contiguous()
    if kind == "heads":
        return x[b0:, h0:].contiguous()
    if kind == "rows":
        return x[b0:].contiguous()
    return x[:, h0 * dh:].contiguous()


def check_rel_offsets(rng, fa):
    """Phase 3d+: each rel-family kernel that draws the dropout mask (#11
    with saved probs, #12, #20 with saved probs, #21, #23, #24), bf16 and
    fp32 at rate 0.1, full width (H=12, Dh=64), B=4: the call on batch rows
    OFFSET_B.. and heads OFFSET_H.. at (b_off, h_off) = (OFFSET_B, OFFSET_H)
    gives the full call's slice of every output (the mask through p/pd)
    bit for bit; the same slice at offsets (0, 0) draws another mask."""
    import torch

    b, h, dh, b0, h0 = 4, 12, 64, OFFSET_B, OFFSET_H
    nh, off = h - h0, dict(b_off=OFFSET_B, h_off=OFFSET_H)
    report = {}
    for dtype_name in ("bf16", "fp32"):
        q, k, v, eb, g = rel_case(rng, dtype_name, b, S_SERVE, S_SERVE)
        seed = int(rng.integers(0, 2 ** 63 - 1))
        kw = dict(scale=0.125, rate=RATE)
        cases = {}
        cut = lambda xs, kinds: [_sliced(x, b0, h0, dh, kd)  # noqa: E731
                                 for x, kd in zip(xs, kinds)]
        ins = [q, k, v, eb]
        kinds = ["flat"] * 3 + ["heads"]
        cases["#11"] = (
            lambda xs, n, **o: fa.attn_fwd_rel_cuda(
                *xs, n_heads=n, seed=seed, save=True, **kw, **o),
            ins, kinds, ["flat", "heads", "heads"])
        cases["#12"] = (
            lambda xs, n, **o: fa.attn_bwd_rel_cuda(
                *xs[:4], seed, xs[4], n_heads=n, **kw, **o),
            ins + [g], kinds + ["flat"], ["flat"] * 3 + ["heads"])
        for s_len, fwd, bwd, tags in (
                (S_SERVE, fa.attn_fwd_relik_cuda, fa.attn_bwd_relik_cuda,
                 ("#20", "#21")),
                (128, fa.attn_fwd_relik_fs_cuda, fa.attn_bwd_relik_fs_cuda,
                 ("#23", "#24"))):
            c, rseed = relik_case(rng, dtype_name, b, s_len)
            ik = [c[n_] for n_ in RELIK]
            ik_kinds = ["flat", "flat", "cols", "flat", "flat", "heads",
                        "rows", "rows"]
            full_grads = ["flat", "flat", None, "flat", "flat", "heads"]
            if tags[0] == "#20":
                cases["#20"] = (
                    lambda xs, n, f=fwd, sd=rseed, **o: f(
                        *xs, n_heads=n, seed=sd, save=True, **kw, **o),
                    ik, ik_kinds, ["flat", "heads", "heads"])
                cases["#21"] = (
                    lambda xs, n, f=bwd, sd=rseed, **o: f(
                        *xs[:8], sd, xs[8], n_heads=n, **kw, **o),
                    ik + [c["g"]], ik_kinds + ["flat"], full_grads)
            else:
                o_full, lse_full = fwd(*ik, n_heads=h, seed=rseed, **kw)
                cases["#23"] = (
                    lambda xs, n, f=fwd, sd=rseed, **o: f(
                        *xs, n_heads=n, seed=sd, **kw, **o),
                    ik, ik_kinds, ["flat", "heads"])
                cases["#24"] = (
                    lambda xs, n, f=bwd, sd=rseed, **o: f(
                        *xs[:8], sd, *xs[8:], n_heads=n, **kw, **o),
                    ik + [o_full, lse_full, c["g"]],
                    ik_kinds + ["flat", "heads", "flat"], full_grads)
        for tag, (call, xs, in_kinds, out_kinds) in cases.items():
            whole = call(xs, h)
            part = call(cut(xs, in_kinds), nh, **off)
            at0 = call(cut(xs, in_kinds), nh)
            same = all(torch.equal(_sliced(w, b0, h0, dh, kd), p)
                       for w, p, kd in zip(whole, part, out_kinds)
                       if kd is not None)
            moved = any(not torch.equal(p, z)
                        for p, z, kd in zip(part, at0, out_kinds)
                        if kd is not None)
            report[f"{tag} {dtype_name}"] = (same, moved)
            print(f"offsets {tag} {dtype_name}: rows {b0}.. heads {h0}.. at "
                  f"(b_off, h_off) = ({b0}, {h0}) give the full call's "
                  f"slice bit for bit: {same}; at (0, 0) another mask: "
                  f"{moved}")
            if not (same and moved):
                raise AssertionError(f"{tag} {dtype_name}: the shard's "
                                     "counter offsets do not give one "
                                     "card's mask")
        del cases
        torch.cuda.empty_cache()
    return report


def time_rel_one_rank(rng, fa, card):
    """One TP rank's rel kernels (H=6 of xlnet-base's 12, Dh=64), bf16,
    timed against their plain versions: #11′ (saved probs) and #13 at
    B=256 Q=K=50 rate 0.1, #20′ and #22 likewise, #23′ and #24 at B=48
    Q=K=1024 rate 0.1. Returns {name: {ms, plain_ms, bound_ms, bound_by}}."""
    import torch

    h, out = 6, {}
    q, k, v, eb, g = rel_case(rng, "bf16", BENCH_BATCH, S_SERVE, S_SERVE, h)
    kw = dict(n_heads=h, scale=0.125, rate=RATE, seed=5)
    _, p, pd = fa.attn_fwd_rel_cuda(q, k, v, eb, save=True, **kw)
    pairs = {
        "attn_fwd_rel": (
            lambda: fa.attn_fwd_rel_cuda(q, k, v, eb, save=True, **kw),
            lambda: fa.attn_fwd_rel_reference(q, k, v, eb, save=True, **kw),
            rel_bound("fwd", BENCH_BATCH, S_SERVE, S_SERVE, h, 64, 2, RATE,
                      save=True)),
        "attn_bwd_rel_saved": (
            lambda: fa.attn_bwd_rel_saved_cuda(p, pd, q, k, v, g, n_heads=h,
                                               scale=0.125),
            lambda: fa.attn_bwd_rel_saved_reference(p, pd, q, k, v, g,
                                                    n_heads=h, scale=0.125),
            rel_bound("bwd_saved", BENCH_BATCH, S_SERVE, S_SERVE, h, 64, 2,
                      RATE))}
    c, seed = relik_case(rng, "bf16", BENCH_BATCH, S_SERVE, h)
    ik = [c[n_] for n_ in RELIK]
    ikw = dict(n_heads=h, scale=0.125)
    _, ip, ipd = fa.attn_fwd_relik_cuda(*ik, save=True, rate=RATE, seed=seed,
                                        **ikw)
    ik_saved = (ip, ipd, *ik[:5], ik[6], c["g"])
    pairs["attn_fwd_relik"] = (
        lambda: fa.attn_fwd_relik_cuda(*ik, save=True, rate=RATE, seed=seed,
                                       **ikw),
        lambda: fa.attn_fwd_relik_reference(*ik, save=True, rate=RATE,
                                            seed=seed, **ikw),
        relik_full_bound("fwd", BENCH_BATCH, S_SERVE, S_SERVE, h, 64, 2,
                         RATE, save=True))
    pairs["attn_bwd_relik_saved"] = (
        lambda: fa.attn_bwd_relik_saved_cuda(*ik_saved, **ikw),
        lambda: fa.attn_bwd_relik_saved_reference(*ik_saved, **ikw),
        relik_full_bound("bwd_saved", BENCH_BATCH, S_SERVE, S_SERVE, h, 64,
                         2, RATE))
    for name, (kernel, plain, bound) in pairs.items():
        ks, ps = _alternate(plain, kernel, 5)
        out[name] = {"ms": float(np.mean(ks)), "plain_ms": float(np.mean(ps)),
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "shape": "bf16 B=256 Q=K=50 H=6 Dh=64 rate 0.1"}
    del pairs, ik, ik_saved, p, pd, ip, ipd
    torch.cuda.empty_cache()
    c, seed = relik_case(rng, "bf16", TRAIN_BATCH, 1024, h)
    ik = [c[n_] for n_ in RELIK]
    o, lse = fa.attn_fwd_relik_fs_cuda(*ik, rate=RATE, seed=seed, **ikw)
    for name, kernel, kind in (
            ("attn_fwd_relik_fs", lambda: fa.attn_fwd_relik_fs_cuda(
                *ik, rate=RATE, seed=seed, **ikw), "fwd"),
            ("attn_bwd_relik_fs", lambda: fa.attn_bwd_relik_fs_cuda(
                *ik, seed, o, lse, c["g"], rate=RATE, **ikw), "bwd")):
        kernel()
        ks = [_time_ms(kernel, 3) for _ in range(2)]
        bound = relik_bound(kind, TRAIN_BATCH, 1024, h, 64, 2)
        # the plain versions at this size take seconds a call: not timed
        out[name] = {"ms": float(np.mean(ks)), "plain_ms": None,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "shape": "bf16 B=48 Q=K=1024 H=6 Dh=64 rate 0.1"}
    for name, t in out.items():
        print(f"one TP rank's {name} ({t['shape']}) on {card}: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    del ik, o, lse
    torch.cuda.empty_cache()
    return out


def _xlnet_tp_model(mesh, dtype, seed, rate=None, rel_bias_impl="auto",
                    shard=True):
    """xlnet-base-cased MAG-XLNet with MOSI dims, fused attention, built
    whole from ``seed`` on this rank's device (head-sharded over ``mesh``
    with ``shard``; the card with no mesh); ``rate`` None keeps the
    default dropouts."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        DatasetConfig,
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.models.xlnet import (
        MagXLNetForSequenceClassification,
    )

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(XLNetConfig.xlnet_base_cased(),
                              attention_impl="fused",
                              rel_bias_impl=rel_bias_impl,
                              tp_attention_mesh=mesh if shard else None)
    mm = MultimodalConfig(injection_index=1)
    if rate is not None:
        cfg = dataclasses.replace(cfg, dropout=rate,
                                  summary_last_dropout=rate)
        mm = MultimodalConfig(dropout_prob=rate, injection_index=1)
    device = mesh.device if mesh is not None else torch.device("cuda")
    return MagXLNetForSequenceClassification(
        cfg, mm, ds.visual_dim, ds.acoustic_dim, dtype, device=device,
        generator=torch.Generator(device=device).manual_seed(seed))


def xlnet_tp_serving_rank(rank, seed, split):
    """Phase 4j on one rank: ``Predictor(mesh=)`` of the head-sharded
    fused MAG-XLNet serves the split at batch 128. Returns its
    predictions, the kernels' launches during ``predict_split`` and its
    wall."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import MeshConfig
    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as fa,
    )
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh
    from bert_multimodal_transformer_tpu_torch.serving import Predictor

    mesh = make_mesh(MeshConfig(data_parallel=-1, model_parallel=TP_RANKS))
    model = _xlnet_tp_model(mesh, torch.bfloat16, seed)
    predictor = Predictor(model, batch_size=BATCH, mesh=mesh)
    predictor.predict_split(split.take(np.arange(BATCH)))  # warm-up
    torch.cuda.synchronize()
    _zero_counts(fa)
    t0 = time.perf_counter()
    preds = predictor.predict_split(split)
    wall = time.perf_counter() - t0
    return {"preds": preds, "launches": _counts(fa), "wall": wall,
            "backend": mesh.backend, "device": str(mesh.device)}


def xlnet_tp_serving(args, rng, fa, card):
    """Phase 4j: two ranks sharing the card serve ``XTP_SERVE_N`` XLNet
    examples through ``Predictor(mesh=)``: #11 once per layer per batch on
    each rank (H=6 a rank) and no other kernel, the ranks' predictions
    equal, and within PRED_ATOL of the one-card einsum model's from the
    same weights. Returns the launch counts summed over the ranks."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        DatasetConfig,
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import run_ranks
    from bert_multimodal_transformer_tpu_torch.serving import Predictor

    ds = DatasetConfig.mosi()
    cfg = XLNetConfig.xlnet_base_cased()
    split = make_xlnet_split(rng, XTP_SERVE_N, S_SERVE, cfg.vocab_size,
                             ds.visual_dim, ds.acoustic_dim)
    seed = args.seed + 92
    t0 = time.perf_counter()
    ranks = run_ranks(xlnet_tp_serving_rank, TP_RANKS, (seed, split),
                      timeout_s=300)
    print(f"XLNet Predictor(mesh=) over {TP_RANKS} ranks "
          f"({ranks[0]['backend']} on {[r['device'] for r in ranks]}): "
          f"{time.perf_counter() - t0:.2f} s for the ranks' start, build "
          "and serving")
    want = _want(fa, attn_fwd_rel=cfg.n_layer * (XTP_SERVE_N // BATCH))
    for i, r in enumerate(ranks):
        print(f"  rank {i}: launches {r['launches']} (want {want}), "
              f"predict_split {XTP_SERVE_N / r['wall']:.1f} examples/s on "
              f"{card} ({r['wall']:.3f} s)")
        if r["launches"] != want:
            raise AssertionError(f"XLNet TP serving rank {i} launches "
                                 f"{r['launches']} != {want}")
    preds = ranks[0]["preds"]
    if preds.shape != (XTP_SERVE_N,) or not np.isfinite(preds).all():
        raise AssertionError(f"bad XLNet TP predictions {preds.shape}")
    if not np.array_equal(preds, ranks[1]["preds"]):
        raise AssertionError("the ranks' gathered predictions differ")
    one = _xlnet_tp_model(None, torch.bfloat16, seed)
    einsum = _xlnet(cfg, MultimodalConfig(injection_index=1), "einsum", 0,
                    one.state_dict())
    del one
    want_preds = Predictor(einsum, batch_size=BATCH).predict_split(split)
    err = float(np.abs(preds - want_preds).max())
    print(f"  XLNet TP fused vs one-card einsum predictions: max_abs_diff "
          f"{err:.3e} (tolerance {PRED_ATOL}), |pred| max "
          f"{np.abs(want_preds).max():.3f}")
    if not err <= PRED_ATOL:
        raise AssertionError(f"XLNet TP predictions differ by {err}")
    del einsum
    torch.cuda.empty_cache()
    return {name: sum(r["launches"][name] for r in ranks)
            for name in ranks[0]["launches"]}


def _xlnet_step_batches(seed, s=S_SERVE, n=TRAIN_BATCH):
    """Two seeded XLNet-packed batches (host arrays)."""
    from bert_multimodal_transformer_tpu_torch.config import (
        DatasetConfig,
        XLNetConfig,
    )

    ds = DatasetConfig.mosi()
    rng = np.random.default_rng([seed, 8])
    return [make_xlnet_split(rng, n, s, XLNetConfig().vocab_size,
                             ds.visual_dim, ds.acoustic_dim).as_tuple()
            for _ in range(2)]


def xlnet_tp_steps(mesh, seed, dtype_name, rate, ref_grads=None,
                   n_steps=2, s=S_SERVE, n=TRAIN_BATCH, shard=True):
    """``n_steps`` train steps of xlnet-base from ``seed``'s weights (one
    card when ``mesh`` is None) at lr 1e-5 with no warmup and dropout
    ``rate``, the dropout stream from ``seed``. Returns (the losses, the
    first step's gradients by name, or with ``ref_grads`` each parameter's
    ``_grad_gap`` to its chunk of the reference)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.parallel import tp
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import Trainer

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    model = _xlnet_tp_model(mesh, dtype, seed, rate=rate, shard=shard)
    tr = Trainer(model=model,
                 tx=make_optimizer(1e-5, 10, warmup_proportion=0.0),
                 mesh=mesh, tp_shard_attention=mesh is not None and shard)
    st = tr.create_state_from_params(None, seed)
    batches = _xlnet_step_batches(seed, s, n)[:n_steps]
    losses = [float(tr._train_step(st, tr._put_batch(batches[0])))]
    grads = {nm: p.grad for nm, p in st.model.named_parameters()
             if p.grad is not None}
    if ref_grads is not None:
        grads = {nm: math.inf if grads.get(nm) is None else _grad_gap(
            grads[nm], tp.shard_tensor(ref, tp.tp_pspec_for_path(
                nm, shard_attention=shard), mesh))
            for nm, ref in ref_grads.items()}
    for batch in batches[1:]:
        losses.append(float(tr._train_step(st, tr._put_batch(batch))))
    return losses, grads


# Phase 6l's step cases: (label, dtype, dropout rate, the kernels each step
# launches once per layer, a head-sharded model or the FFN split alone).
# The bounds are TP_STEP_TOL's and TP_GRAD_TOL's, but for the bf16
# gradients: XLNet assembles its score bias in bf16 (rel_shift of a bf16
# product), so each rank's bf16 partial products move a gradient further
# than in MAG-BERT (0.124 of its leaf's scale at MAG's w_hv_t, R2 of this
# phase), and they are held at XLNET_GRAD_GAP_TOL, phase 6b's bound for
# XLNet's bf16 gradients; the fp32 cases hold the real check.
XTP_GRAD_TOL = {"fp32": TP_GRAD_TOL["fp32"], "bf16": XLNET_GRAD_GAP_TOL}
XTP_STEP_CASES = (
    ("head-sharded, fp32", "fp32", 0.0,
     ("attn_fwd_rel", "attn_bwd_rel_saved"), True),
    ("head-sharded, bf16", "bf16", 0.0,
     ("attn_fwd_rel", "attn_bwd_rel_saved"), True),
    ("FFN split only, fp32", "fp32", 0.0,
     ("attn_fwd_rel", "attn_bwd_rel_saved"), False),
    ("head-sharded, fp32, dropout 0.1", "fp32", RATE,
     ("attn_fwd_rel", "attn_bwd_rel_saved"), True),
)


@contextlib.contextmanager
def _head_offset_zero():
    """Inside: every rank's full-H rel kernels draw at head offset 0."""
    from bert_multimodal_transformer_tpu_torch.models import xlnet
    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as fa,
    )

    right = xlnet.fused_rel_attention_tp

    def wrong(q, k, v, ebias, *, mesh, n_heads, scale, dropout_rate=0.0,
              dropout_rng=None, deterministic=True):
        return fa._fused_rel(q, k, v, ebias, n_heads, scale, dropout_rate,
                             dropout_rng, deterministic, None,
                             (mesh.data_rank * q.shape[0], 0))

    xlnet.fused_rel_attention_tp = wrong
    try:
        yield
    finally:
        xlnet.fused_rel_attention_tp = right


def xlnet_tp_steps_rank(rank, seed):
    """Phase 6l's step checks on one rank: the one-card steps on this
    rank's card (their losses, their gradients kept as the reference),
    each XTP_STEP_CASES case's losses, gradient gaps and launches, the
    planted head-offset fault's, and one S=512 step (#23, #24)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import MeshConfig
    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as fa,
    )
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(data_parallel=-1, model_parallel=TP_RANKS))
    os.environ["FUSED_ATTN_SAVE"] = "1"
    out = {"one card": {}}
    for label, dtype_name, rate, _, shard in XTP_STEP_CASES:
        key = (dtype_name, rate)
        if key not in out["one card"]:
            one = xlnet_tp_steps(None, seed, dtype_name, rate)
            out["one card"][key] = one
        ref = out["one card"][key][1]
        _zero_counts(fa)
        out[label] = (*xlnet_tp_steps(mesh, seed, dtype_name, rate, ref,
                                      shard=shard), _counts(fa))
        torch.cuda.empty_cache()
    with _head_offset_zero():
        out[XTP_FAULT] = xlnet_tp_steps(mesh, seed, "fp32", RATE,
                                        out["one card"][("fp32", RATE)][1])
    out["one card"] = {k: v[0] for k, v in out["one card"].items()}
    torch.cuda.empty_cache()
    _zero_counts(fa)
    losses, _ = xlnet_tp_steps(mesh, seed, "bf16", RATE, n_steps=1,
                               s=FLASH_S, n=XTP_S512_BATCH)
    out["s512"] = (losses, _counts(fa))
    del os.environ["FUSED_ATTN_SAVE"]
    return out


def xlnet_tp_driver_path(args, fa, card):
    """Phase 6l: ``driver.run --model xlnet-base-cased --model_parallel 2
    --tp_shard_attention --attention_impl fused`` over TP_SPLITS (auto:
    #11 once per layer per batch and #13 once per layer per train step on
    each rank; then ``--rel_bias_impl inkernel``: #20 and #22), exit 0
    and the same epoch records on both ranks; then the step checks
    (``xlnet_tp_steps_rank``): two dropout-0 steps of the two-rank model
    (fp32, bf16, and the FFN split alone) against the one-card model, the
    dropout-0.1 fp32 step against the one-card fused step and the planted
    head-offset fault past its bound, and one S=512 step through #23 and
    #24. Returns {path: launch counts summed over the ranks}."""
    from bert_multimodal_transformer_tpu_torch import driver
    from bert_multimodal_transformer_tpu_torch.config import XLNetConfig
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import run_ranks

    layers = XLNetConfig.xlnet_base_cased().n_layer
    n_train = -(-TP_SPLITS[0] // TRAIN_BATCH)
    n_eval = sum(-(-n // EVAL_BATCH) for n in TP_SPLITS[1:])
    os.environ.setdefault("WANDB_MODE", "disabled")
    paths = {}
    for path, extra, want_kw in (
            ("xlnet_tp_driver", [],
             dict(attn_fwd_rel=layers * (n_train + n_eval),
                  attn_bwd_rel_saved=layers * n_train)),
            ("xlnet_tp_driver_inkernel", ["--rel_bias_impl", "inkernel"],
             dict(attn_fwd_relik=layers * (n_train + n_eval),
                  attn_bwd_relik_saved=2 * layers * n_train))):
        argv = ["--model", "xlnet-base-cased", "--dataset", "mosi",
                "--synthetic", "--synthetic_sizes", *map(str, TP_SPLITS),
                "--n_epochs", "1", "--model_parallel", str(TP_RANKS),
                "--tp_shard_attention", "--attention_impl", "fused",
                "--compute_dtype", "bfloat16", "--seed", str(args.seed),
                *extra]
        t0 = time.perf_counter()
        rc, ranks = driver.run(argv, rank_timeout_s=600)
        print(f"driver.main({' '.join(argv)}) on {card}: exit {rc}, "
              f"{time.perf_counter() - t0:.2f} s wall ({len(ranks)} ranks)")
        if rc != 0 or len(ranks) != TP_RANKS:
            raise AssertionError(f"XLNet TP driver exited {rc}")
        want = _want(fa, **want_kw)
        for i, r in enumerate(ranks):
            (rec,) = r["history"]
            print(f"  rank {i}: train_loss {rec['train_loss']} valid_loss "
                  f"{rec['valid_loss']}; launches {r['launches']} (want "
                  f"{want})")
            if not all(math.isfinite(rec[k]) for k in ("train_loss",
                                                       "valid_loss")):
                raise AssertionError(f"non-finite XLNet TP losses {rec}")
            if r["launches"] != want:
                raise AssertionError(f"XLNet TP driver rank {i} launches "
                                     f"{r['launches']} != {want}")
        if any(ranks[0]["history"][0][k] != ranks[1]["history"][0][k]
               for k in ("train_loss", "valid_loss", "test_acc")):
            raise AssertionError("the ranks' epoch records differ")
        paths[path] = {name: sum(r["launches"][name] for r in ranks)
                       for name in _wrappers(fa)}

    t0 = time.perf_counter()
    steps = run_ranks(xlnet_tp_steps_rank, TP_RANKS, (args.seed + 93,),
                      timeout_s=600)
    one = steps[0]["one card"]
    print(f"  XLNet steps at lr 1e-5, B={TRAIN_BATCH} S={S_SERVE}, one card: "
          f"{one} ({time.perf_counter() - t0:.2f} s with the ranks)")
    if any(r["one card"] != one for r in steps):
        raise AssertionError("the ranks' one-card steps differ")

    def worst(gaps):
        name = max(gaps, key=gaps.get)
        return gaps[name], name

    failed = []
    for label, dtype_name, rate, kernels, _ in XTP_STEP_CASES:
        want = _want(fa, **{k_: 2 * layers for k_ in kernels})
        for i, r in enumerate(steps):
            losses, gaps, counts = r[label]
            gap = max(abs(a - b) / abs(b)
                      for a, b in zip(losses, one[(dtype_name, rate)]))
            g_gap, g_name = worst(gaps)
            print(f"  rank {i}, {label}: losses {losses}, relative gap "
                  f"{gap:.3e} (bound {TP_STEP_TOL[dtype_name]}); first-step "
                  f"gradients of {len(gaps)} parameters, worst gap "
                  f"{g_gap:.3e} at {g_name} (bound "
                  f"{XTP_GRAD_TOL[dtype_name]}); launches {counts}")
            if (not gap <= TP_STEP_TOL[dtype_name]
                    or not g_gap <= XTP_GRAD_TOL[dtype_name]
                    or counts != want):
                failed.append(f"XLNet TP step ({label}) rank {i}: loss gap "
                              f"{gap}, gradient gap {g_gap} at {g_name}, "
                              f"launches {counts} (want {want})")
    g_gap, g_name = worst(steps[1][XTP_FAULT][1])
    print(f"  rank 1, planted fault ({XTP_FAULT}): worst gradient gap "
          f"{g_gap:.3e} at {g_name} (must exceed {TP_GRAD_TOL['fp32']})")
    if not g_gap > TP_GRAD_TOL["fp32"]:
        failed.append("the XLNet TP dropout check cannot see rank 1's head "
                      "offset forced to 0")
    want = _want(fa, attn_fwd_relik_fs=layers, attn_bwd_relik_fs=3 * layers)
    for i, r in enumerate(steps):
        losses, counts = r["s512"]
        print(f"  rank {i}, one S={FLASH_S} step at B={XTP_S512_BATCH} "
              f"(bf16, rate {RATE}): loss {losses}, launches {counts} (want "
              f"{want})")
        if counts != want or not all(math.isfinite(x) for x in losses):
            failed.append(f"XLNet TP S={FLASH_S} step rank {i}: {losses}, "
                          f"launches {counts}")
    if failed:
        raise AssertionError("; ".join(failed))
    paths["xlnet_tp_steps"] = {
        name: sum(r[label][2][name] for r in steps
                  for label, *_ in XTP_STEP_CASES)
        for name in _wrappers(fa)}
    paths["xlnet_tp_step_s512"] = {
        name: sum(r["s512"][1][name] for r in steps)
        for name in _wrappers(fa)}
    return paths


def _flash_bert(cfg, ds, seed, dtype, weights=None):
    import torch

    from bert_multimodal_transformer_tpu_torch.config import MultimodalConfig
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )

    model = MagBertForSequenceClassification(
        cfg, MultimodalConfig(dropout_prob=cfg.hidden_dropout_prob),
        ds.visual_dim, ds.acoustic_dim, dtype, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(seed))
    if weights is not None:
        model.load_state_dict(weights)
    return model


def flash_serving(args, rng, fa, card):
    """Phase 4k: bert-base ``attention_impl="flash"`` at S=512, bf16,
    ``Predictor`` at batch 48 over FLASH_SERVE_N examples: #6 once per
    layer per batch and nothing else, the predictions within PRED_ATOL of
    the einsum model's from the same weights; then #6 at B=48 S=512 timed
    beside ``scaled_dot_product_attention`` with the [B, 1, 1, S] mask.
    Returns (the launch counts, the times)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.serving import Predictor

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                              attention_impl="flash")
    model = _flash_bert(cfg, ds, args.seed + 94, torch.bfloat16)
    split = make_split(rng, FLASH_SERVE_N, FLASH_S, cfg.vocab_size,
                       ds.visual_dim, ds.acoustic_dim)
    predictor = Predictor(model, batch_size=FLASH_BATCH)
    predictor.predict_split(split.take(np.arange(FLASH_BATCH)))  # warm-up
    torch.cuda.synchronize()
    _zero_counts(fa)
    t0 = time.perf_counter()
    preds = predictor.predict_split(split)
    wall = time.perf_counter() - t0
    counts = _counts(fa)
    want = _want(fa, attn_fwd_packed_fs=cfg.num_hidden_layers
                 * (FLASH_SERVE_N // FLASH_BATCH))
    print(f"flash serving (bert-base bf16 S={FLASH_S}, batch {FLASH_BATCH}):"
          f" launches {counts} (want {want}), "
          f"{FLASH_SERVE_N / wall:.1f} examples/s on {card}")
    if counts != want:
        raise AssertionError(f"flash serving launches {counts} != {want}")
    einsum = _flash_bert(dataclasses.replace(cfg, attention_impl="einsum"),
                         ds, 0, torch.bfloat16, model.state_dict())
    want_preds = Predictor(einsum, batch_size=FLASH_BATCH).predict_split(
        split)
    err = float(np.abs(preds - want_preds).max())
    print(f"  flash vs einsum predictions: max_abs_diff {err:.3e} "
          f"(tolerance {PRED_ATOL})")
    if preds.shape != (FLASH_SERVE_N,) or not err <= PRED_ATOL:
        raise AssertionError(f"flash predictions differ by {err}")
    del model, einsum, predictor
    torch.cuda.empty_cache()
    qkv, mask, _, _ = long_case(rng, "bf16", FLASH_BATCH, FLASH_S)
    h, scale = 12, 0.125

    def kernel():
        fa.attn_fwd_packed_fs_cuda(qkv, mask, n_heads=h, scale=scale)

    def plain():
        fa.attn_fwd_packed_fs_reference(qkv, mask, n_heads=h, scale=scale)

    ks, ps = _alternate(plain, kernel, 5)
    sdpa, _ = sdpa_call(qkv, mask, h, scale)
    _time_ms(sdpa, 3)
    lib = [_time_ms(sdpa, 10) for _ in range(2)]
    bound = long_bound("fwd", FLASH_BATCH, FLASH_S, h, 64, 2, fs=True)
    times = {"ms": float(np.mean(ks)), "plain_ms": float(np.mean(ps)),
             "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": float(np.mean(lib)),
             "library": "scaled_dot_product_attention, [B, 1, 1, S] mask",
             "shape": f"bf16 B={FLASH_BATCH} S={FLASH_S} H=12 Dh=64 rate 0"}
    print(f"  #6 at the flash serving shape ({times['shape']}) on {card}: "
          f"kernel {ks} ms, plain {ps} ms, SDPA {lib} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]})")
    return counts, times


def flash_driver_path(args, rng, fa, card):
    """Phase 6m: ``driver.main --attention_impl flash --max_seq_length
    512`` over 96/48/48 (no #6/#7 in training at prob dropout 0.1, #6 once
    per layer per evaluation batch); then one dropout-0 step of bert-base
    (fp32, B=48, S=512) through #6/#7 against the einsum model, every
    parameter's gradient within FLASH_GRAD_TOL of its scale, and the same
    step with #7's dK zeroed past it. Returns {path: launch counts}."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
    )

    layers = BertConfig.bert_base_uncased().num_hidden_layers
    argv = ["--model", "bert-base-uncased", "--dataset", "mosi",
            "--synthetic", "--synthetic_sizes", *map(str, TP_SPLITS),
            "--n_epochs", "1", "--attention_impl", "flash",
            "--max_seq_length", str(FLASH_S), "--compute_dtype",
            "bfloat16", "--seed", str(args.seed)]
    counts = run_driver(argv, fa, card)
    n_eval = sum(-(-n // EVAL_BATCH) for n in TP_SPLITS[1:])
    want = _want(fa, attn_fwd_packed_fs=layers * n_eval)
    print(f"kernel launches in the flash driver: {counts} (want {want})")
    if counts != want:
        raise AssertionError(f"flash driver launches {counts} != {want}")

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                              attention_impl="flash", hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    batch = _device_batch(make_split(
        np.random.default_rng([args.seed, 25]), FLASH_BATCH, FLASH_S,
        cfg.vocab_size, ds.visual_dim, ds.acoustic_dim).as_tuple())

    def grads(model):
        model.zero_grad()
        ids, vis, ac, mask, segs, labels = batch
        logits = model(ids, vis, ac, attention_mask=mask,
                       token_type_ids=segs, deterministic=False,
                       dropout_rng=1)
        torch.mean(torch.square(logits.reshape(-1) - labels)).backward()
        return {n: p.grad.detach().clone()
                for n, p in model.named_parameters()}

    flash = _flash_bert(cfg, ds, args.seed + 95, torch.float32)
    einsum = _flash_bert(dataclasses.replace(cfg, attention_impl="einsum"),
                         ds, 0, torch.float32, flash.state_dict())
    ref = grads(einsum)
    del einsum
    _zero_counts(fa)
    got = grads(flash)
    step_counts = _counts(fa)
    want = _want(fa, attn_fwd_packed_fs=layers,
                 attn_bwd_packed_fs=2 * layers)
    gaps = {n: _grad_gap(got[n], ref[n]) for n in ref}
    worst = max(gaps, key=gaps.get)
    print(f"  dropout-0 step through #6/#7 (fp32 B={FLASH_BATCH} "
          f"S={FLASH_S}) against einsum: worst gradient gap "
          f"{gaps[worst]:.3e} at {worst} (bound {FLASH_GRAD_TOL}); launches "
          f"{step_counts} (want {want})")
    if not gaps[worst] <= FLASH_GRAD_TOL or step_counts != want:
        raise AssertionError(f"flash step: gap {gaps[worst]} at {worst}, "
                             f"launches {step_counts}")
    right = fa.attn_bwd_packed_fs

    def zero_dk(*a, **kw):
        dqkv = right(*a, **kw).clone()
        d = dqkv.shape[-1] // 3
        dqkv[..., d:2 * d] = 0
        return dqkv

    fa.attn_bwd_packed_fs = zero_dk
    try:
        bad = grads(flash)
    finally:
        fa.attn_bwd_packed_fs = right
    gaps = {n: _grad_gap(bad[n], ref[n]) for n in ref}
    worst = max(gaps, key=gaps.get)
    print(f"  planted fault (#7's dK zeroed): worst gradient gap "
          f"{gaps[worst]:.3e} at {worst} (must exceed {FLASH_GRAD_TOL})")
    if not gaps[worst] > FLASH_GRAD_TOL:
        raise AssertionError("the flash step check cannot see a zeroed dK")
    del flash, got, ref, bad
    torch.cuda.empty_cache()
    return {"flash_driver": counts, "flash_step": step_counts}



# ---- phases 6n-6p: the pipelined and the fully-sharded trainers -----------

PP_STAGES, PP_MICRO = 2, 4    # two stages on the one card, microbatches of 12
PP_SPLITS = (96, 48, 48)      # 2 train batches of 48, 1 dev and 1 test batch
# The step checks of 6n-6p: two dropout-0 steps of the pipelined (or
# fully-sharded) model against one card's steps from the same weights and
# batches at lr 1e-5 with no warmup, the first step's gradients leaf by
# leaf (``_grad_gap``, on the rank's part of each leaf) and the losses.
# fp32: the losses within 1e-6 relative and the gradients within 1e-5 of a
# leaf's scale (the pipelined step runs one card's ops in the same order,
# summing its microbatches' gradients in the reverse order; FSDP sums two
# data ranks' partial products). bf16: PAR_BF16_FACTOR times the one card's
# own bf16 drift from its fp32 step on the same weights and batches, read
# in the same run (the largest leaf gap, and the largest loss gap): two
# bf16 results, each within that drift of the fp32 one, sit within twice
# it of each other (ROADMAP C.4, ``xtp_drift.py``).
PAR_FP32_TOL = {"loss": 1e-6, "grad": 1e-5}
PAR_BF16_FACTOR = 2.0
PP_FAULT = "prologue and epilogue gradients not summed over the pipe axis"


def _par_model(family, device, dtype, seed, mesh=None):
    """bert-base or xlnet-base-cased MAG model with MOSI dims, fused
    attention and the fused gate, every dropout 0, built whole from
    ``seed`` on ``device`` (head-sharded over ``mesh`` when given)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )
    from bert_multimodal_transformer_tpu_torch.models.xlnet import (
        MagXLNetForSequenceClassification,
    )

    ds = DatasetConfig.mosi()
    if family == "bert":
        cfg = dataclasses.replace(
            BertConfig.bert_base_uncased(), attention_impl="fused",
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            tp_attention_mesh=mesh)
        cls, inj = MagBertForSequenceClassification, 0
    else:
        cfg = dataclasses.replace(
            XLNetConfig.xlnet_base_cased(), attention_impl="fused",
            dropout=0.0, summary_last_dropout=0.0, tp_attention_mesh=mesh)
        cls, inj = MagXLNetForSequenceClassification, 1
    mm = MultimodalConfig(dropout_prob=0.0, injection_index=inj,
                          use_fused_kernel=True)
    return cls(cfg, mm, ds.visual_dim, ds.acoustic_dim, dtype,
               device=device,
               generator=torch.Generator(device=device).manual_seed(seed))


def _par_steps(family, dtype_name, seed, kind="one", mesh=None,
               grad_accum=1, ref=None, shard=False, n_steps=2):
    """``n_steps`` dropout-0 steps at lr 1e-5, no warmup, from ``seed``'s
    weights on the two seeded batches of 48: ``kind`` "one" (one card's
    Trainer with ``grad_accum``), "pp" (the pipeline trainer, PP_MICRO
    microbatches, over ``mesh``) or "fsdp" (``Trainer(fsdp=True)`` over
    ``mesh``, head-sharded with ``shard``). Returns (the losses, the first
    step's gradients by the model's names, or with ``ref`` each one's
    ``_grad_gap`` to its part of the reference (inf where this rank holds
    the leaf and the step left it no gradient), the peak bytes the model,
    its state and the steps added to this process's allocator, the second
    step's wall ms)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.parallel import tp
    from bert_multimodal_transformer_tpu_torch.parallel.pp import (
        PipelineTrainer,
    )
    from bert_multimodal_transformer_tpu_torch.parallel.pp_xlnet import (
        XLNetPipelineTrainer,
    )
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import Trainer

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    device = mesh.device if mesh is not None else torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = _par_model(family, device, dtype, seed,
                       mesh if shard else None)
    tx = make_optimizer(1e-5, 10, warmup_proportion=0.0)
    if kind == "pp":
        cls = XLNetPipelineTrainer if family == "xlnet" else PipelineTrainer
        tr = cls(model=model, tx=tx, mesh=mesh, n_micro=PP_MICRO)
    else:
        tr = Trainer(model=model, tx=tx, mesh=mesh, grad_accum=grad_accum,
                     fsdp=kind == "fsdp", tp_shard_attention=shard)
    st = tr.create_state_from_params(None, seed)
    batches = (_tp_step_batches(seed) if family == "bert"
               else _xlnet_step_batches(seed))[:n_steps]
    names = (st.model.model_names() if kind == "pp" else
             {n: n for n, _ in st.model.named_parameters()})
    losses, grads, step_ms = [], None, None
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(tr._train_step(st, tr._put_batch(
            batch, grad_accum))))
        if grads is not None:
            # the second step's wall time (the first one warms up)
            step_ms = (time.perf_counter() - t0) * 1e3
        if grads is None:
            # AdamW leaves the gradients be: these are the first step's
            grads = {names[n]: (p, None if p.grad is None
                                else p.grad.detach().clone())
                     for n, p in st.model.named_parameters()}
    # what the steps added to the card's allocator at its peak
    peak = torch.cuda.max_memory_allocated() - base
    if ref is None:
        return losses, {n: g for n, (_, g) in grads.items()
                        if g is not None}, peak, step_ms

    def part(name, p, full):
        if mesh is not None and mesh.model_size > 1:
            full = tp.shard_tensor(full, tp.tp_pspec_for_path(
                name, shard_attention=shard), mesh)
        shard_of = getattr(p, "fsdp_shard", None)
        if shard_of is not None:
            n = full.shape[shard_of[0]] // mesh.data_size
            full = full.narrow(shard_of[0], mesh.data_rank * n, n)
        return full

    # a stage holds its own layers: the others' are not its to compare
    gaps = {n: math.inf if n not in grads or grads[n][1] is None
            else _grad_gap(grads[n][1], part(n, grads[n][0], r))
            for n, r in ref.items() if n in grads or kind != "pp"}
    return losses, gaps, peak, step_ms


def _drift(one):
    """One card's bf16 step against its fp32 step: (the largest relative
    loss gap, the largest leaf gap, its leaf)."""
    (l32, g32), (l16, g16) = one["fp32"][:2], one["bf16"][:2]
    loss = max(abs(a - b) / abs(b) for a, b in zip(l16, l32))
    gaps = {n: _grad_gap(g16[n], g32[n]) for n in g32 if n in g16}
    leaf = max(gaps, key=gaps.get)
    return loss, gaps[leaf], leaf


def _quiet_ms(family, seed, grad_accum):
    """One card's bf16 step wall ms with this phase's other ranks idle:
    rank 0 times it while every other rank waits at a barrier."""
    import torch.distributed as dist

    dist.barrier()
    ms = None
    if dist.get_rank() == 0:
        ms = _par_steps(family, "bf16", seed, grad_accum=grad_accum)[3]
    dist.barrier()
    return ms


def pp_steps_rank(rank, families, seed, model_parallel):
    """Phases 6n-6p's pipelined step checks on one rank, for each of
    ``families``: one card's grad_accum=PP_MICRO steps in fp32 and bf16 on
    this rank's card (the reference, and the bf16 drift), the pipelined
    steps' losses, gradient gaps, launches and second-step wall in each
    dtype, one card's bf16 step timed with the other ranks waiting, and
    (without a model axis) the planted fault's gaps."""
    import torch

    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as fa,
    )
    from bert_multimodal_transformer_tpu_torch.parallel import pp
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
        make_pp_mesh,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_pp_mesh(PP_STAGES, model_parallel=model_parallel)
    result = {}
    for family in families:
        one = {d: _par_steps(family, d, seed, grad_accum=PP_MICRO)
               for d in ("fp32", "bf16")}
        out = {"one card": {d: v[0] for d, v in one.items()},
               "drift": _drift(one), "stage": mesh.pipe_rank}
        for d in ("fp32", "bf16"):
            _zero_counts(fa)
            losses, gaps, _, ms = _par_steps(family, d, seed, "pp", mesh,
                                             ref=one[d][1])
            out[d] = (losses, gaps, _counts(fa), None, ms)
        out["quiet ms"] = _quiet_ms(family, seed, PP_MICRO)
        if model_parallel == 1:
            right = pp.PipelineTrainer._cross_stage_grads
            pp.PipelineTrainer._cross_stage_grads = lambda self, stage: None
            try:
                out[PP_FAULT] = _par_steps(family, "fp32", seed, "pp", mesh,
                                           ref=one["fp32"][1],
                                           n_steps=1)[1]
            finally:
                pp.PipelineTrainer._cross_stage_grads = right
        result[family] = out
    return result


def fsdp_steps_rank(rank, families, seed, model_parallel):
    """Phase 6p's FSDP step checks on one rank of a (2, model_parallel)
    mesh, for each of ``families``: one card's steps in fp32 and bf16 (the
    reference and the drift), the FSDP steps (head-sharded over a model
    axis) in each dtype with their launches, peak memory and second-step
    wall, one card's bf16 step timed with the other ranks waiting, and
    (without a model axis) a plain data-parallel rank's peak in bf16
    beside it."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import MeshConfig
    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as fa,
    )
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(MeshConfig(data_parallel=-1,
                                model_parallel=model_parallel))
    shard = model_parallel > 1
    result = {}
    for family in families:
        one = {d: _par_steps(family, d, seed) for d in ("fp32", "bf16")}
        out = {"one card": {d: v[0] for d, v in one.items()},
               "drift": _drift(one)}
        for d in ("fp32", "bf16"):
            _zero_counts(fa)
            losses, gaps, peak, ms = _par_steps(
                family, d, seed, "fsdp", mesh, ref=one[d][1], shard=shard)
            out[d] = (losses, gaps, _counts(fa), peak, ms)
        out["quiet ms"] = _quiet_ms(family, seed, 1)
        if not shard:
            # the same steps as a plain data-parallel rank holds them
            out["dp peak"] = _par_dp_peak(family, seed, mesh)
        result[family] = out
    return result


def _par_dp_peak(family, seed, mesh):
    """The peak bytes a plain data-parallel rank's model, state and two
    bf16 steps add to this process's allocator (as ``_par_steps``)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import Trainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = _par_model(family, mesh.device, torch.bfloat16, seed)
    tr = Trainer(model=model, mesh=mesh,
                     tx=make_optimizer(1e-5, 10, warmup_proportion=0.0))
    st = tr.create_state_from_params(None, seed)
    for batch in (_tp_step_batches(seed) if family == "bert"
                  else _xlnet_step_batches(seed)):
        tr._train_step(st, tr._put_batch(batch))
    return torch.cuda.max_memory_allocated() - base


def _par_check(label, ranks, fa, want_of, failed, fault=None):
    """Hold every rank's cases of a step check (``pp_steps_rank`` /
    ``fsdp_steps_rank``): the fp32 bounds, the bf16 bound from the rank's
    own one-card drift, the launches ``want_of(rank result)``; the planted
    fault past the fp32 bound. Appends what fails to ``failed``; returns
    the launches summed over the ranks and dtypes."""
    one = ranks[0]["one card"]
    if any(r["one card"] != one for r in ranks):
        failed.append(f"{label}: the ranks' one-card steps differ")
    total = {name: 0 for name in _wrappers(fa)}
    for i, r in enumerate(ranks):
        d_loss, d_grad, d_leaf = r["drift"]
        tol = {"fp32": PAR_FP32_TOL,
               "bf16": {"loss": PAR_BF16_FACTOR * d_loss,
                        "grad": PAR_BF16_FACTOR * d_grad}}
        for d in ("fp32", "bf16"):
            losses, gaps, counts = r[d][:3]
            gap = max(abs(a - b) / abs(b) for a, b in zip(losses, one[d]))
            leaf = max(gaps, key=gaps.get)
            want = want_of(r)
            extra = (f", peak {r[d][3] / 2**30:.3f} GiB"
                     if r[d][3] is not None else "")
            extra += f"; second step {r[d][4]:.2f} ms wall"
            if d == "bf16" and r["quiet ms"] is not None:
                extra += (f" (one card's bf16 step, the other ranks waiting: "
                          f"{r['quiet ms']:.2f} ms)")
            print(f"  {label} rank {i}, {d}: losses {losses} (one card "
                  f"{one[d]}), loss gap {gap:.3e} (bound {tol[d]['loss']:.3e}"
                  f"); {len(gaps)} gradients, worst gap {gaps[leaf]:.3e} at "
                  f"{leaf} (bound {tol[d]['grad']:.3e}); launches "
                  f"{ {k: v for k, v in counts.items() if v} }{extra}")
            if d == "bf16":
                print(f"    one card's bf16 drift from fp32: loss "
                      f"{d_loss:.3e}, worst leaf {d_grad:.3e} at {d_leaf}")
            if (not gap <= tol[d]["loss"] or not gaps[leaf] <= tol[d]["grad"]
                    or counts != want):
                failed.append(f"{label} rank {i} {d}: loss gap {gap}, "
                              f"gradient gap {gaps[leaf]} at {leaf}, "
                              f"launches {counts} (want {want})")
            for k, v in counts.items():
                total[k] += v
        if fault is not None and fault in r:
            gaps = r[fault]
            leaf = max(gaps, key=gaps.get)
            print(f"  {label} rank {i}, planted fault ({fault}): worst gap "
                  f"{gaps[leaf]:.3e} at {leaf} (must exceed "
                  f"{PAR_FP32_TOL['grad']})")
            if not gaps[leaf] > PAR_FP32_TOL["grad"]:
                failed.append(f"{label}: the step check cannot see "
                              f"'{fault}' on rank {i}")
    return total


def _par_driver(argv, fa, card, n_ranks, want_of):
    """``driver.run(argv)`` over ranks sharing the card: exit 0, finite
    losses equal on every rank, each rank's launches ``want_of(i)``.
    Returns the launches summed over the ranks."""
    from bert_multimodal_transformer_tpu_torch import driver

    os.environ.setdefault("WANDB_MODE", "disabled")
    t0 = time.perf_counter()
    rc, ranks = driver.run(argv, rank_timeout_s=600)
    print(f"driver.main({' '.join(argv)}) on {card}: exit {rc}, "
          f"{time.perf_counter() - t0:.2f} s wall ({len(ranks)} ranks)")
    if rc != 0 or len(ranks) != n_ranks:
        raise AssertionError(f"driver exited {rc} with {len(ranks)} ranks")
    for i, r in enumerate(ranks):
        (rec,) = r["history"]
        want = want_of(i)
        print(f"  rank {i}: train_loss {rec['train_loss']} valid_loss "
              f"{rec['valid_loss']}; launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }")
        if not all(math.isfinite(rec[k]) for k in ("train_loss",
                                                   "valid_loss")):
            raise AssertionError(f"non-finite losses {rec}")
        if r["launches"] != want:
            raise AssertionError(f"rank {i} launches {r['launches']} != "
                                 f"{want}")
    if any(r["history"][0][k] != ranks[0]["history"][0][k] for r in ranks
           for k in ("train_loss", "valid_loss", "test_acc")):
        raise AssertionError("the ranks' epoch records differ")
    return {name: sum(r["launches"][name] for r in ranks)
            for name in _wrappers(fa)}


def _family_kernels(family):
    """(forward, saved-probs backward) wrapper names of the family's S=50
    full-H kernels."""
    return (("attn_fwd_packed", "attn_bwd_packed_saved") if family == "bert"
            else ("attn_fwd_rel", "attn_bwd_rel_saved"))


def pp_driver_path(args, fa, card):
    """Phases 6n (BERT) and 6o (XLNet): ``driver.run --pipeline_parallel 2
    --pp_microbatches 4 --attention_impl fused --use_fused_mag`` over
    PP_SPLITS, two stages sharing the card over gloo: exit 0, finite and
    equal records, each stage's 6 layers launching the forward once per
    microbatch (train and eval) and the saved-probs backward once per train
    microbatch, the gate (#25, #26) on stage 0 only; then, in one spawn,
    each family's dropout-0 step checks (``pp_steps_rank``) against one
    card's grad_accum=4 steps and the planted fault. Returns {path: launch
    counts over the ranks}."""
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import run_ranks

    k = 12 // PP_STAGES
    n_train = -(-PP_SPLITS[0] // TRAIN_BATCH) * PP_MICRO
    n_eval = sum(-(-n // EVAL_BATCH) for n in PP_SPLITS[1:]) * PP_MICRO
    paths = {}
    for family, model in (("bert", "bert-base-uncased"),
                          ("xlnet", "xlnet-base-cased")):
        fwd, bwd = _family_kernels(family)
        argv = ["--model", model, "--dataset", "mosi", "--synthetic",
                "--synthetic_sizes", *map(str, PP_SPLITS), "--n_epochs",
                "1", "--pipeline_parallel", str(PP_STAGES),
                "--pp_microbatches", str(PP_MICRO), "--attention_impl",
                "fused", "--use_fused_mag", "--compute_dtype", "bfloat16",
                "--seed", str(args.seed)]

        def want_driver(i, fwd=fwd, bwd=bwd):
            gate = (dict(mag_fwd=n_train + n_eval, mag_bwd=n_train)
                    if i == 0 else {})
            return _want(fa, **{fwd: k * (n_train + n_eval),
                                bwd: k * n_train}, **gate)

        paths[f"{family}_pp_driver"] = _par_driver(argv, fa, card,
                                                   PP_STAGES, want_driver)
    t0 = time.perf_counter()
    ranks = run_ranks(pp_steps_rank, PP_STAGES,
                      (("bert", "xlnet"), args.seed + 95, 1), timeout_s=600)
    print(f"  pipelined steps (B={TRAIN_BATCH}, {PP_MICRO} microbatches), "
          f"both families: {time.perf_counter() - t0:.2f} s with the ranks")
    failed = []
    for family in ("bert", "xlnet"):
        fwd, bwd = _family_kernels(family)

        def want_steps(r, fwd=fwd, bwd=bwd):
            gate = (dict(mag_fwd=2 * PP_MICRO, mag_bwd=2 * PP_MICRO)
                    if r["stage"] == 0 else {})
            return _want(fa, **{fwd: 2 * k * PP_MICRO,
                                bwd: 2 * k * PP_MICRO}, **gate)

        paths[f"{family}_pp_steps"] = _par_check(
            f"{family} PP", [r[family] for r in ranks], fa, want_steps,
            failed, PP_FAULT)
    if failed:
        raise AssertionError("; ".join(failed))
    return paths


def par_driver_paths(args, fa, card):
    """Phase 6p: PP×TP (``--pipeline_parallel 2 --model_parallel 2``, BERT,
    four ranks: #1′/#3 on full heads on every rank) and its step check;
    FSDP (``--fsdp``, XLNet, one process: a data axis of one) and FSDP×TP
    (``--fsdp --model_parallel 2 --tp_shard_attention``, BERT: #8/#10)
    through the driver; the FSDP step checks on two data ranks (BERT and
    XLNet) and FSDP×TP on 2 × 2 (BERT), with each rank's peak memory under
    FSDP beside a plain data-parallel rank's. Returns ({path: launch
    counts over the ranks}, {family: peaks})."""
    from bert_multimodal_transformer_tpu_torch.config import XLNetConfig
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import run_ranks

    n_train = -(-PP_SPLITS[0] // TRAIN_BATCH)
    n_eval = sum(-(-n // EVAL_BATCH) for n in PP_SPLITS[1:])
    base = ["--dataset", "mosi", "--synthetic", "--synthetic_sizes",
            *map(str, PP_SPLITS), "--n_epochs", "1", "--attention_impl",
            "fused", "--use_fused_mag", "--compute_dtype", "bfloat16",
            "--seed", str(args.seed)]
    paths, failed = {}, []
    k = 12 // PP_STAGES

    def want_pptp(i):
        gate = (dict(mag_fwd=(n_train + n_eval) * PP_MICRO,
                     mag_bwd=n_train * PP_MICRO) if i < 2 else {})
        return _want(fa, attn_fwd_packed=k * (n_train + n_eval) * PP_MICRO,
                     attn_bwd_packed_saved=k * n_train * PP_MICRO, **gate)

    paths["pp_tp_driver"] = _par_driver(
        ["--model", "bert-base-uncased", "--pipeline_parallel",
         str(PP_STAGES), "--pp_microbatches", str(PP_MICRO),
         "--model_parallel", "2", *base], fa, card, 4, want_pptp)
    paths["fsdp_tp_driver"] = _par_driver(
        ["--model", "bert-base-uncased", "--fsdp", "--model_parallel", "2",
         "--tp_shard_attention", *base], fa, card, 2,
        lambda i: _want(fa, attn_fwd_split=12 * (n_train + n_eval),
                        attn_bwd_split_saved=12 * n_train,
                        mag_fwd=n_train + n_eval, mag_bwd=n_train))
    layers = XLNetConfig.xlnet_base_cased().n_layer
    counts = run_driver(["--model", "xlnet-base-cased", "--fsdp", *base], fa,
                        card)
    want = _want(fa, attn_fwd_rel=layers * (n_train + n_eval),
                 attn_bwd_rel_saved=layers * n_train,
                 mag_fwd=n_train + n_eval, mag_bwd=n_train)
    print(f"  launches {counts} (want {want})")
    if counts != want:
        raise AssertionError(f"--fsdp XLNet launches {counts} != {want}")
    paths["xlnet_fsdp_driver"] = counts

    t0 = time.perf_counter()
    ranks = [r["bert"] for r in run_ranks(
        pp_steps_rank, 4, (("bert",), args.seed + 96, 2), timeout_s=600)]
    print(f"  PP×TP steps: {time.perf_counter() - t0:.2f} s with the ranks")

    def want_pp(r):
        gate = (dict(mag_fwd=2 * PP_MICRO, mag_bwd=2 * PP_MICRO)
                if r["stage"] == 0 else {})
        return _want(fa, attn_fwd_packed=2 * k * PP_MICRO,
                     attn_bwd_packed_saved=2 * k * PP_MICRO, **gate)

    paths["pp_tp_steps"] = _par_check("BERT PP×TP", ranks, fa, want_pp,
                                      failed)
    peaks = {}
    for families, mp in ((("bert", "xlnet"), 1), (("bert",), 2)):
        t0 = time.perf_counter()
        ranks = run_ranks(fsdp_steps_rank, 2 * mp,
                          (families, args.seed + 97, mp), timeout_s=600)
        print(f"  FSDP{'×TP' if mp > 1 else ''} steps of {families}: "
              f"{time.perf_counter() - t0:.2f} s with the ranks")
        for family in families:
            fwd, bwd = (("attn_fwd_split", "attn_bwd_split_saved")
                        if mp > 1 else _family_kernels(family))
            label = f"{family} FSDP" + ("×TP" if mp > 1 else "")
            paths[f"{family}_fsdp{'_tp' if mp > 1 else ''}_steps"] = (
                _par_check(label, [r[family] for r in ranks], fa,
                           lambda r, fwd=fwd, bwd=bwd: _want(
                               fa, **{fwd: 24, bwd: 24}, mag_fwd=2,
                               mag_bwd=2), failed))
            if mp == 1:
                peaks[family] = {
                    "fsdp_bf16_GiB": [r[family]["bf16"][3] / 2**30
                                      for r in ranks],
                    "dp_bf16_GiB": [r[family]["dp peak"] / 2**30
                                    for r in ranks]}
                print(f"  {family} peak memory a rank, two bf16 steps at "
                      f"B=48 over 2 data ranks on {card}: FSDP "
                      f"{peaks[family]['fsdp_bf16_GiB']} GiB, plain data "
                      f"parallel {peaks[family]['dp_bf16_GiB']} GiB")
    if failed:
        raise AssertionError("; ".join(failed))
    return paths, peaks


# ---- phases 6q-6s: multi-process runs and the data axis --------------------

MP_SPLITS = (192, 96, 96)     # 2 train steps at 96 (48 a rank), 1 dev and
#                               1 test batch of 128 (64 a rank)
MP_BATCH = 96
MP_TIMEOUT_S = 600            # each driver process, and each rank spawn
MEM_LEN_DR = 50               # phase 6r: K = 50 + 50
SM_RATE = 0.1                 # phase 6s: attention and hidden dropout


def _mp_argv(args, *extra):
    """The 6q driver run: bert-base, fused attention and gate, bf16."""
    return ["--model", "bert-base-uncased", "--dataset", "mosi",
            "--synthetic", "--synthetic_sizes", *map(str, MP_SPLITS),
            "--n_epochs", "1", "--max_steps", "2", "--train_batch_size",
            str(MP_BATCH), "--attention_impl", "fused", "--use_fused_mag",
            "--compute_dtype", "bfloat16", "--seed", str(args.seed), *extra]


@contextlib.contextmanager
def _timed_train_steps(ms):
    """Every ``Trainer`` built inside the block times its unmasked train
    steps into ``ms`` (wall ms, each between two synchronizes)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.training import (
        trainer as trainer_lib,
    )

    make = trainer_lib.make_train_step

    def timed_make(*a, **kw):
        step = make(*a, **kw)

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            return out

        return timed

    trainer_lib.make_train_step = timed_make
    try:
        yield
    finally:
        trainer_lib.make_train_step = make


def mp_driver_process(argv) -> int:
    """``python3 chip_smoke.py --mp_driver '<argv as JSON>'``: one driver
    process of a ``--num_processes`` run (``driver.run``), its train steps
    timed; prints its ranks' records, launches and backend, and the step
    times, as the last line."""
    from bert_multimodal_transformer_tpu_torch import driver

    ms = []
    with _timed_train_steps(ms):
        rc, ranks = driver.run(argv, rank_timeout_s=MP_TIMEOUT_S)
    print(json.dumps({"rc": rc, "step_ms": ms, "ranks": [
        {k: r[k] for k in ("history", "launches", "backend")}
        for r in ranks]}))
    return rc


def _two_driver_processes(argv, work):
    """``argv`` as two driver processes (``--num_processes 2``) over a
    loopback coordinator, each under MP_TIMEOUT_S: [(exit status, stdout,
    its last line as JSON)] for process 0 and 1. Every process is stopped
    before this returns."""
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import (
        _free_port,
    )

    port = _free_port()
    env = dict(os.environ, WANDB_MODE="disabled")
    procs, logs = [], []
    try:
        for p in (0, 1):
            log = open(os.path.join(work, f"process{p}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mp_driver",
                 json.dumps(argv + [
                     "--num_processes", "2", "--process_id", str(p),
                     "--coordinator_address", f"127.0.0.1:{port}"])],
                stdout=log, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + MP_TIMEOUT_S
        out = []
        for proc, log in zip(procs, logs):
            rc = proc.wait(max(deadline - time.monotonic(), 1.0))
            log.seek(0)
            text = log.read()
            res = [ln for ln in text.splitlines() if ln.startswith('{"rc"')]
            out.append((rc, text, json.loads(res[-1]) if res else None))
        return out
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()


def mp_ref_rank(rank, argv):
    """One of one process's two spawned ranks on ``argv`` (the driver's own
    rank function over a two-data-rank mesh on the card), its train steps
    timed."""
    import torch

    from bert_multimodal_transformer_tpu_torch import driver

    ms = []
    args = driver.build_parser().parse_args(argv)
    with _timed_train_steps(ms):
        out = driver._rank_main(rank, args, [torch.device("cuda", 0)] * 2)
    return {**out, "step_ms": ms}


def _epoch_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("epoch:")]


def multiprocess_driver_path(args, fa, card, work):
    """Phase 6q: two driver processes (``--num_processes 2``) on the one
    card over gloo, bert-base at 48 rows a rank, against one process's two
    spawned ranks (the same ``Trainer`` on a two-data-rank mesh): the
    records bit for bit, process 1 silent, each process's launches as
    predicted; the second train step's wall beside the two ranks' and one
    card's at the same 96 rows. Returns ({path: launch counts}, {label:
    step ms})."""
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import run_ranks

    n_train = -(-MP_SPLITS[0] // MP_BATCH)
    n_eval = sum(-(-n // EVAL_BATCH) for n in MP_SPLITS[1:])
    want = _want(fa, attn_fwd_packed=12 * (n_train + n_eval),
                 attn_bwd_packed_saved=12 * n_train,
                 mag_fwd=n_train + n_eval, mag_bwd=n_train)
    print(f"  predicted launches a process (and a rank, here and in the "
          f"--fsdp --model_parallel 2 run): "
          f"{ {k: v for k, v in want.items() if v} }")
    argv = _mp_argv(args)
    t0 = time.perf_counter()
    procs = _two_driver_processes(argv, work)
    wall = time.perf_counter() - t0
    for p, (rc, text, res) in enumerate(procs):
        print(f"  process {p}: exit {rc}; "
              + (f"launches { {k: v for k, v in res['ranks'][0]['launches'].items() if v} }, "
                 f"backend {res['ranks'][0]['backend']}, train steps "
                 f"{res['step_ms']} ms" if res else text[-3000:]))
    if any(rc != 0 for rc, _, _ in procs):
        raise AssertionError("a driver process of --num_processes 2 failed")
    print(f"driver --num_processes 2 (two processes on {card}): "
          f"{wall:.2f} s wall")
    print("\n".join(_epoch_lines(procs[0][1])))
    failed = []
    if len(_epoch_lines(procs[0][1])) != 1 or _epoch_lines(procs[1][1]):
        failed.append("process 0 must print one epoch line, process 1 none")
    t0 = time.perf_counter()
    ref = run_ranks(mp_ref_rank, 2, (argv,), timeout_s=MP_TIMEOUT_S,
                    devices=["cuda:0"] * 2)
    print(f"  one process's two ranks: {time.perf_counter() - t0:.2f} s "
          f"with the ranks; train steps {[r['step_ms'] for r in ref]} ms")
    keys = ("train_loss", "valid_loss", "test_acc", "test_mae", "test_corr",
            "test_f_score")
    got = procs[0][2]["ranks"][0]["history"][0]
    ref_rec = ref[0]["history"][0]
    print(f"  two processes {[got[k] for k in keys]}; one process's two "
          f"ranks {[ref_rec[k] for k in keys]}")
    if any(got[k] != ref_rec[k] for k in keys):
        failed.append(f"two processes {got} != two ranks {ref_rec}")
    for p, (_, _, res) in enumerate(procs):
        (r,) = res["ranks"]
        if r["launches"] != want or r["backend"] != "gloo":
            failed.append(f"process {p}: launches {r['launches']} (want "
                          f"{want}), backend {r['backend']}")
    for i, r in enumerate(ref):
        if r["launches"] != want:
            failed.append(f"two ranks, rank {i}: launches {r['launches']}")
    one_ms = []
    with _timed_train_steps(one_ms):
        one = run_driver(argv, fa, card)
    steps = {"two processes": [res["step_ms"][1] for _, _, res in procs],
             "one process, two ranks": [r["step_ms"][1] for r in ref],
             "one card": one_ms[1]}
    print(f"  second train step at {MP_BATCH} rows (48 a rank), wall ms on "
          f"{card} (host-staged gloo on one shared card): {steps}")
    paths = {"mp_driver": {k: sum(res["ranks"][0]["launches"][k]
                                  for _, _, res in procs) for k in want},
             "mp_two_rank_driver": {k: sum(r["launches"][k] for r in ref)
                                    for k in want},
             "mp_one_card_driver": one}
    if failed:
        raise AssertionError("; ".join(failed))
    return paths, steps


def mp_fsdp_tp_path(args, fa, card, work):
    """Phase 6q's ``--fsdp --model_parallel 2`` over two driver processes
    of two ranks each (four ranks on the card): exit 0, finite and equal
    records, each rank's launches as ``multiprocess_driver_path``
    predicts. Prints nothing (it runs beside 6r/6s); returns ({path: launch
    counts over the ranks}, the report's lines)."""
    n_train = -(-MP_SPLITS[0] // MP_BATCH)
    n_eval = sum(-(-n // EVAL_BATCH) for n in MP_SPLITS[1:])
    want = _want(fa, attn_fwd_packed=12 * (n_train + n_eval),
                 attn_bwd_packed_saved=12 * n_train,
                 mag_fwd=n_train + n_eval, mag_bwd=n_train)
    t0 = time.perf_counter()
    fsdp = _two_driver_processes(_mp_argv(args, "--fsdp", "--model_parallel",
                                          "2"), work)
    lines = [f"driver --num_processes 2 --fsdp --model_parallel 2 (four "
             f"ranks on {card}): {time.perf_counter() - t0:.2f} s wall"]
    failed, records = [], []
    total = {k: 0 for k in want}
    for p, (rc, text, res) in enumerate(fsdp):
        if rc != 0 or res is None:
            raise AssertionError(f"--fsdp --model_parallel 2 process {p} "
                                 f"exited {rc}:\n{text[-3000:]}")
        for i, r in enumerate(res["ranks"]):
            (rec,) = r["history"]
            records.append(rec)
            lines.append(
                f"  process {p} rank {i}: train_loss {rec['train_loss']} "
                f"valid_loss {rec['valid_loss']}; launches "
                f"{ {k: v for k, v in r['launches'].items() if v} }")
            if not all(math.isfinite(rec[k]) for k in ("train_loss",
                                                       "valid_loss")):
                failed.append(f"--fsdp --model_parallel 2: non-finite {rec}")
            if r["launches"] != want:
                failed.append(f"--fsdp --model_parallel 2 process {p} rank "
                              f"{i}: launches {r['launches']} != {want}")
            for k in want:
                total[k] += r["launches"][k]
    if any(r[k] != records[0][k] for r in records
           for k in ("train_loss", "valid_loss", "test_acc")):
        failed.append("--fsdp --model_parallel 2: the ranks' records differ")
    if failed:
        raise AssertionError("; ".join(lines + failed))
    return {"mp_fsdp_tp_driver": total}, lines


def _mem_xlnet(dtype, seed, device, mem_len):
    """xlnet-base-cased MAG model with MOSI dims, fused attention and gate,
    every dropout 0, the memory ``mem_len``, built whole from ``seed``."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        DatasetConfig,
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.models.xlnet import (
        MagXLNetForSequenceClassification,
    )

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(
        XLNetConfig.xlnet_base_cased(), attention_impl="fused", dropout=0.0,
        summary_last_dropout=0.0, mem_len=mem_len)
    mm = MultimodalConfig(dropout_prob=0.0, injection_index=1,
                          use_fused_kernel=True)
    return MagXLNetForSequenceClassification(
        cfg, mm, ds.visual_dim, ds.acoustic_dim, dtype, device=device,
        generator=torch.Generator(device=device).manual_seed(seed))


def _mem_runs(dtype_name, seed, device, mesh=None):
    """Two memory steps (lr 1e-5, no warmup) on the two seeded XLNet
    batches of 48, the memory carried, then ``Predictor(mem_len=)`` at
    batch 48 over 96 rows of a fresh model from the same weights: on one
    card (``mesh`` None) or this rank's data shard, on ``device``. Returns
    (losses, the first step's gradients, the predictions)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.serving import Predictor
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import Trainer

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    model = _mem_xlnet(dtype, seed, device, MEM_LEN_DR)
    tr = Trainer(model=model, mesh=mesh, mem_len=MEM_LEN_DR,
                 tx=make_optimizer(1e-5, 10, warmup_proportion=0.0))
    st = tr.create_state_from_params(None, seed)
    batches = _xlnet_step_batches(seed)
    mems = tr._init_mems(batches[0], for_train=True)
    losses, grads = [], None
    for batch in batches:
        loss, mems = tr._train_step_mems(st, tr._put_batch(batch), mems)
        losses.append(float(loss))
        if grads is None:
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()
                     if p.grad is not None}
    del model, tr, st, mems
    rng = np.random.default_rng([seed, 9])
    from bert_multimodal_transformer_tpu_torch.config import (
        DatasetConfig,
        XLNetConfig,
    )

    ds = DatasetConfig.mosi()
    split = make_xlnet_split(rng, 2 * TRAIN_BATCH, S_SERVE,
                             XLNetConfig().vocab_size, ds.visual_dim,
                             ds.acoustic_dim)
    pred = Predictor(_mem_xlnet(dtype, seed, device, MEM_LEN_DR),
                     batch_size=TRAIN_BATCH, mem_len=MEM_LEN_DR, mesh=mesh)
    preds = torch.from_numpy(pred.predict_split(split).astype(np.float32))
    torch.cuda.empty_cache()
    return losses, grads, preds


def _sm_bert(seed, device):
    """bert-base MAG model with MOSI dims, fused attention and gate, bf16,
    attention and hidden dropout SM_RATE, built whole from ``seed``."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
        MultimodalConfig,
    )
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )

    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(
        BertConfig.bert_base_uncased(), attention_impl="fused",
        hidden_dropout_prob=SM_RATE, attention_probs_dropout_prob=SM_RATE)
    mm = MultimodalConfig(dropout_prob=SM_RATE, use_fused_kernel=True)
    return MagBertForSequenceClassification(
        cfg, mm, ds.visual_dim, ds.acoustic_dim, torch.bfloat16,
        device=device,
        generator=torch.Generator(device=device).manual_seed(seed))


def data_ranks_rank(rank, seed):
    """Phases 6r and 6s on one of two data ranks sharing the card. 6r: the
    memory runs (``_mem_runs``) on one card and on this rank's shard, fp32
    and bf16, with the shard's launches. 6s: two bf16 steps of bert-base
    at dropout SM_RATE through the ``Trainer``'s data-parallel step and
    through ``make_shard_map_train_step`` from the same weights and seed:
    the losses, whether every parameter is equal, and each step kind's
    launches."""
    import torch

    from bert_multimodal_transformer_tpu_torch.config import MeshConfig
    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as fa,
    )
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh
    from bert_multimodal_transformer_tpu_torch.parallel.shard_map_step import (
        make_shard_map_train_step,
    )
    from bert_multimodal_transformer_tpu_torch.training.optim import (
        make_optimizer,
    )
    from bert_multimodal_transformer_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(MeshConfig(data_parallel=-1))
    one = {d: _mem_runs(d, seed, mesh.device) for d in ("fp32", "bf16")}
    (l32, g32, p32), (l16, g16, p16) = one["fp32"], one["bf16"]
    # one card's bf16 drift from fp32, read in this rank
    out = {"mem": {"drift": (
        max(abs(a - b) / abs(b) for a, b in zip(l16, l32)),
        max(_grad_gap(g16[n], g32[n]) for n in g32 if n in g16),
        _grad_gap(p16, p32))}}
    for d in ("fp32", "bf16"):
        _zero_counts(fa)
        losses, grads, preds = _mem_runs(d, seed, mesh.device, mesh)
        out["mem"][d] = {
            "one card": one[d][0], "losses": losses,
            "gaps": {n: _grad_gap(g, one[d][1][n])
                     for n, g in grads.items()},
            "pred gap": _grad_gap(preds, one[d][2]),
            "launches": _counts(fa)}
    del one, g32, g16
    sm = {}
    for explicit in (False, True):
        model = _sm_bert(seed, mesh.device)
        start = [p.detach().clone() for p in model.parameters()]
        tr = Trainer(model=model, mesh=mesh,
                     tx=make_optimizer(1e-5, 10, warmup_proportion=0.0))
        st = tr.create_state_from_params(None, seed)
        step = make_shard_map_train_step(mesh) if explicit else tr._train_step
        _zero_counts(fa)
        losses = [float(step(st, tr._put_batch(b)))
                  for b in _tp_step_batches(seed)]
        params = [p.detach().clone() for p in model.parameters()]
        sm[explicit] = (losses, _counts(fa), params, any(
            not torch.equal(p, q) for p, q in zip(params, start)))
        del model, tr, st, start
    out["shard_map"] = {
        "trainer": sm[False][:2], "explicit": sm[True][:2],
        "params equal": all(torch.equal(p, q)
                            for p, q in zip(sm[False][2], sm[True][2])),
        "moved": sm[True][3]}
    return out


def data_ranks_path(args, fa, card):
    """Phases 6r (the XLNet memory over two data ranks: #11′ and #13 at
    K = 100, #11 serving) and 6s (the explicit-collectives step: #1′/#3),
    in one two-rank spawn sharing the card over gloo. Returns {path:
    launch counts over the ranks}."""
    from bert_multimodal_transformer_tpu_torch.parallel.mesh import run_ranks

    layers = 12
    want_mem = _want(fa, attn_fwd_rel=layers * 4, attn_bwd_rel_saved=layers * 2,
                     mag_fwd=4, mag_bwd=2)
    want_sm = _want(fa, attn_fwd_packed=24, attn_bwd_packed_saved=24,
                    mag_fwd=2, mag_bwd=2)
    print(f"  predicted launches a rank and dtype, 6r (2 memory steps and 2 "
          f"predictor batches): { {k: v for k, v in want_mem.items() if v} }"
          f"; 6s (2 steps a kind): "
          f"{ {k: v for k, v in want_sm.items() if v} }")
    t0 = time.perf_counter()
    ranks = run_ranks(data_ranks_rank, 2, (args.seed + 98,),
                      timeout_s=MP_TIMEOUT_S, devices=["cuda:0"] * 2)
    print(f"  6r/6s: {time.perf_counter() - t0:.2f} s with the ranks on "
          f"{card}")
    failed = []
    paths = {k: {n: 0 for n in _wrappers(fa)} for k in (
        "xlnet_mem_data_ranks", "shard_map_steps", "shard_map_trainer_steps")}
    for i, r in enumerate(ranks):
        d_loss, d_grad, d_pred = r["mem"]["drift"]
        for d in ("fp32", "bf16"):
            m = r["mem"][d]
            tol = (PAR_FP32_TOL if d == "fp32" else
                   {"loss": PAR_BF16_FACTOR * d_loss,
                    "grad": PAR_BF16_FACTOR * d_grad})
            pred_tol = (PAR_FP32_TOL["grad"] if d == "fp32"
                        else PAR_BF16_FACTOR * d_pred)
            gap = max(abs(a - b) / abs(b) for a, b in zip(m["losses"],
                                                          m["one card"]))
            leaf = max(m["gaps"], key=m["gaps"].get)
            print(f"  6r rank {i}, {d}: losses {m['losses']} (one card "
                  f"{m['one card']}), loss gap {gap:.3e} (bound "
                  f"{tol['loss']:.3e}); {len(m['gaps'])} gradients, worst "
                  f"gap {m['gaps'][leaf]:.3e} at {leaf} (bound "
                  f"{tol['grad']:.3e}); predictions gap {m['pred gap']:.3e} "
                  f"(bound {pred_tol:.3e}); launches "
                  f"{ {k: v for k, v in m['launches'].items() if v} }")
            if (not gap <= tol["loss"] or not m["gaps"][leaf] <= tol["grad"]
                    or not m["pred gap"] <= pred_tol
                    or m["launches"] != want_mem):
                failed.append(f"6r rank {i} {d}: loss gap {gap}, gradient "
                              f"gap {m['gaps'][leaf]} at {leaf}, predictions "
                              f"gap {m['pred gap']}, launches "
                              f"{m['launches']}")
            for k, v in m["launches"].items():
                paths["xlnet_mem_data_ranks"][k] += v
        print(f"    one card's bf16 drift from fp32: loss {d_loss:.3e}, "
              f"worst leaf {d_grad:.3e}, predictions {d_pred:.3e}")
        sm = r["shard_map"]
        print(f"  6s rank {i}: Trainer step losses {sm['trainer'][0]}, "
              f"explicit step losses {sm['explicit'][0]}; params equal "
              f"{sm['params equal']}, moved {sm['moved']}; launches "
              f"{ {k: v for k, v in sm['explicit'][1].items() if v} }")
        if (sm["trainer"][0] != sm["explicit"][0] or not sm["params equal"]
                or not sm["moved"] or sm["explicit"][1] != want_sm
                or sm["trainer"][1] != want_sm):
            failed.append(f"6s rank {i}: losses {sm['trainer'][0]} and "
                          f"{sm['explicit'][0]}, params equal "
                          f"{sm['params equal']}, moved {sm['moved']}, "
                          f"launches {sm['trainer'][1]} and "
                          f"{sm['explicit'][1]}")
        for k in want_sm:
            paths["shard_map_steps"][k] += sm["explicit"][1][k]
            paths["shard_map_trainer_steps"][k] += sm["trainer"][1][k]
    if ranks[0]["shard_map"]["explicit"][0] != ranks[1]["shard_map"][
            "explicit"][0]:
        failed.append("6s: the ranks' losses differ")
    if failed:
        raise AssertionError("; ".join(failed))
    return paths


# ---- phases run beside others, each in a process of its own ---------------

BESIDE_TIMEOUT_S = 900        # each such process, its ranks' spawns included
_BESIDE_SECONDS = {}


# ---- kernel T: threefry dropout (phases 3k and 6t) ------------------------

# Phase 3k's cases: the hidden dropout at the bench's batch (bf16 [B, S,
# D]), an fp32 ragged shape, and the einsum probs (bf16 [B, H, S, S]).
TF_CASES = (("bf16", (BENCH_BATCH, S_SERVE, 768)), ("fp32", (4, 77, 768)),
            ("bf16", (BENCH_BATCH, 12, S_SERVE, S_SERVE)))
# T's integer operations an element: 20 Threefry rounds of an add, a
# rotate (one funnel shift) and an xor, five key injections of three adds
# and the two initial adds. The H100's INT32 rate: 132 SMs x 64 INT32
# lanes x 1.98 GHz (the Hopper white paper's SM), 16.7 TOP/s.
TF_OPS_PER_ELEMENT = 77
INT32_OPS = 132 * 64 * 1.98e9
# Phase 6t: the card's fp32 step against the CPU's from the same weights
# and key. The masks are the same bits on both, so only the order of fp32
# sums differs: the loss within 1e-5 relative, every gradient within 1e-4
# of its leaf's largest magnitude. A mask from another key moves the loss
# by percents.
TF_STEP_LOSS_RTOL, TF_STEP_GRAD_TOL = 1e-5, 1e-4
THREEFRY_ARGV = ["--model", "bert-base-uncased", "--dataset", "mosi",
                 "--synthetic", "--synthetic_sizes", "96", "48", "48",
                 "--n_epochs", "1", "--use_fused_mag", "--attention_impl",
                 "fused", "--compute_dtype", "bfloat16", "--rng_impl",
                 "threefry2x32"]


def threefry_bound(n, itemsize):
    """T's bound on n elements: x read and out written once; 77 integer
    operations an element at the INT32 rate."""
    return _bound(2 * n * itemsize, TF_OPS_PER_ELEMENT * n, INT32_OPS)


def check_threefry_kernel(rng, card):
    """Phase 3k: kernel T against its plain version, bit for bit, on
    ``TF_CASES``, two slices, the backward; the keep rate; the times.
    Returns the kernels-line fields (max_abs_err 0 when every case is
    bit for bit)."""
    import torch
    import torch.nn.functional as F

    from bert_multimodal_transformer_tpu_torch.ops import dropout as tfd
    from bert_multimodal_transformer_tpu_torch.utils import jax_random

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    out, first = {"cases": {}}, None
    for dtype_name, shape in TF_CASES:
        dt = dtypes[dtype_name]
        x = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            "cuda", dt)
        key = jax_random.PRNGKey(int(rng.integers(2 ** 31 - 1)))
        keep, div = tfd._keep_and_divisor(RATE, dt)
        layout = tfd.threefry_layout(shape, {})
        got = tfd.threefry_dropout_cuda(x, key, keep, div, layout)
        want = tfd.threefry_dropout_plain(x, key, keep, div, layout)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"3k: kernel T != plain on {dtype_name} {shape}: "
                f"{int((got != want).sum())} elements differ")
        n = x.numel()
        rate = float((got != 0).float().mean())
        sigma = math.sqrt(0.9 * 0.1 / n)
        if abs(rate - 0.9) > 5 * sigma:
            raise AssertionError(f"3k: keep rate {rate} on {shape} is more "
                                 f"than 5 sigma ({sigma:.2e}) from 0.9")
        tag = f"{dtype_name} {list(shape)}"
        kernel_ms, plain_ms = _alternate(
            lambda: tfd.threefry_dropout_plain(x, key, keep, div, layout),
            lambda: tfd.threefry_dropout_cuda(x, key, keep, div, layout),
            20)
        context_ms = _time_ms(lambda: F.dropout(x, RATE, True), 20)
        bound, by = threefry_bound(n, x.element_size())
        out["cases"][tag] = {
            "identical_to_plain": True, "keep_rate": rate,
            "ms": min(kernel_ms), "plain_ms": min(plain_ms),
            "bound_ms": bound, "bound_by": by,
            "F_dropout_ms_context": context_ms}
        if first is None:
            first = (x, key, keep, div, got)
    x, key, keep, div, full = first
    # a TP rank's columns and a data rank's rows of the same draw
    half = x.shape[-1] // 2
    cols = x[..., half:].contiguous()
    got = tfd.threefry_dropout_cuda(
        cols, key, keep, div,
        tfd.threefry_layout(cols.shape, {2: (x.shape[-1], half)}))
    rows = x[128:].contiguous()
    got_rows = tfd.threefry_dropout_cuda(
        rows, key, keep, div,
        tfd.threefry_layout(rows.shape, {0: (x.shape[0], 128)}))
    # the backward: the same mask on a cotangent, regenerated from the key
    xr = x.clone().requires_grad_()
    layout = tfd.threefry_layout(x.shape, {})
    y = tfd.ThreefryDropout.apply(xr, key, keep, div, layout)
    g = torch.randn_like(y)
    y.backward(g)
    torch.cuda.synchronize()
    checks = {"column slice from 384": torch.equal(got, full[..., half:]),
              "row slice from 128": torch.equal(got_rows, full[128:]),
              "forward through autograd": torch.equal(y.detach(), full),
              "backward": torch.equal(xr.grad, tfd.threefry_dropout_plain(
                  g, key, keep, div, layout))}
    print(json.dumps({"threefry_kernel": out, "slices_and_backward": checks,
                      "card": card}))
    if not all(checks.values()):
        raise AssertionError(f"3k: {checks}")
    main = out["cases"][f"bf16 {list(TF_CASES[0][1])}"]
    return {"max_abs_err": 0.0, "identical_to_plain": True,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "library_note": ("none: no PyTorch call draws JAX's threefry "
                             "mask (F.dropout's time, a Philox mask, is "
                             "context: F_dropout_ms_context)"),
            "shape": f"bf16 {list(TF_CASES[0][1])} rate 0.1",
            "modes": {tag: c for tag, c in out["cases"].items()}}


def _threefry_model(family, device):
    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        MultimodalConfig,
        XLNetConfig,
    )
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )
    from bert_multimodal_transformer_tpu_torch.models.xlnet import (
        MagXLNetForSequenceClassification,
    )

    mm = MultimodalConfig(dropout_prob=RATE,
                          injection_index=1 if family == "xlnet" else 0)
    if family == "xlnet":
        cfg = dataclasses.replace(XLNetConfig.xlnet_base_cased(),
                                  dropout=RATE)
        return MagXLNetForSequenceClassification(cfg, mm, 47, 74,
                                                 device=device)
    cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                              hidden_dropout_prob=RATE,
                              attention_probs_dropout_prob=RATE)
    return MagBertForSequenceClassification(cfg, mm, 47, 74, device=device)


def _threefry_step(model, batch, key):
    """One fp32 threefry train step of ``model`` from state key ``key``:
    (loss, each parameter's gradient on the CPU)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.ops.dropout import (
        ThreefryStream,
    )
    from bert_multimodal_transformer_tpu_torch.training import optim
    from bert_multimodal_transformer_tpu_torch.training.trainer import (
        Trainer,
    )

    tr = Trainer(model=model, tx=optim.make_optimizer(1e-5, 10),
                 rng_impl="threefry2x32")
    st = tr.create_state_from_params(None, ThreefryStream(key))
    loss = float(tr._train_step(st, tr._put_batch(batch)))
    grads = {n: p.grad.detach().cpu().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    return loss, grads


def threefry_step_check(family, seed, fa, card):
    """Phase 6t's step: the same bert-base or xlnet-base weights (drawn on
    the card from PRNGKey(seed)) and key on the card and on the CPU; one
    fp32 einsum step each at B=8 S=50. Returns (the card step's launch
    counts, the record)."""
    import torch

    from bert_multimodal_transformer_tpu_torch.utils import jax_random

    rng = np.random.default_rng([seed, 28])
    maker = make_xlnet_split if family == "xlnet" else make_split
    split = maker(rng, 8, S_SERVE, 32000 if family == "xlnet" else 30522,
                  47, 74)
    batch = (split.input_ids, split.visual, split.acoustic,
             split.input_mask, split.segment_ids, split.label_ids)
    card_model = _threefry_model(family, "cuda")
    card_model.init_params_threefry(jax_random.PRNGKey(seed))
    weights = {k: v.detach().cpu() for k, v in
               card_model.state_dict().items()}
    key = jax_random.fold_in(jax_random.PRNGKey(seed), 1)
    _zero_counts(fa)
    card_loss, card_grads = _threefry_step(card_model, batch, key)
    torch.cuda.synchronize()
    counts = _counts(fa)
    cpu_model = _threefry_model(family, "cpu")
    cpu_model.load_state_dict(weights)
    cpu_loss, cpu_grads = _threefry_step(cpu_model, batch, key)
    card_model.load_state_dict(weights)
    other_loss, _ = _threefry_step(card_model, batch,
                                   jax_random.fold_in(key, 1))
    gaps = {n: float((card_grads[n] - g).abs().max()
                     / max(float(g.abs().max()), 1e-30))
            for n, g in cpu_grads.items() if float(g.abs().max()) > 0}
    worst = max(gaps, key=gaps.get)
    layers = 12
    # mask sites a step: BERT embeddings, MAG, (probs, attention out, FFN)
    # a layer, pooled; XLNet word embedding, positions, MAG, (probs, out,
    # two FFN) a layer, output, summary; each again in the backward but
    # XLNet's positions, which take no gradient
    t_step = (2 * (3 + 3 * layers) if family == "bert"
              else 2 * (5 + 4 * layers) - 1)
    record = {"loss_card": card_loss, "loss_cpu": cpu_loss,
              "loss_rel_gap": abs(card_loss - cpu_loss) / abs(cpu_loss),
              "loss_other_key": other_loss, "worst_grad_gap": gaps[worst],
              "worst_leaf": worst, "threefry_launches": counts[
                  "threefry_dropout"], "threefry_launches_predicted": t_step}
    print(json.dumps({"threefry_step": family, **record, "card": card}))
    if counts != _want(fa, threefry_dropout=t_step):
        raise AssertionError(f"6t {family}: launches {counts}")
    if record["loss_rel_gap"] > TF_STEP_LOSS_RTOL or \
            gaps[worst] > TF_STEP_GRAD_TOL:
        raise AssertionError(f"6t {family}: card step off the CPU step: "
                             f"{record}")
    if abs(other_loss - cpu_loss) < 100 * TF_STEP_LOSS_RTOL * abs(cpu_loss):
        raise AssertionError(f"6t {family}: another key's masks left the "
                             f"loss within the band: {record}")
    return counts, record


def threefry_driver_path(args, fa, card):
    """Phase 6t: the threefry driver run and its launches, the native
    tokenizer, then ``threefry_step_check`` for both families. Returns
    (launch counts by path, the step records)."""
    from bert_multimodal_transformer_tpu_torch.data import native

    counts = run_driver(THREEFRY_ARGV + ["--seed", str(args.seed)], fa, card)
    layers, n_train, n_eval = 12, 96 // TRAIN_BATCH, 2
    # 27 T sites a step (embeddings, MAG, attention output and FFN of each
    # layer, pooled), forward and backward
    want = _want(fa, attn_fwd_packed=layers * (n_train + n_eval),
                 attn_bwd_packed_saved=layers * n_train,
                 mag_fwd=n_train + n_eval, mag_bwd=n_train,
                 threefry_dropout=2 * (3 + 2 * layers) * n_train)
    print(f"kernel launches in the threefry driver run: {counts} (want "
          f"{want})")
    taken = native._lib is not None
    print(json.dumps({"native_tokenizer": taken}))
    if counts != want:
        raise AssertionError(f"6t: launch counts {counts} != {want}")
    if not taken:
        raise AssertionError("6t: the driver did not take the native "
                             "tokenizer")
    paths, records = {"threefry_driver": counts}, {}
    for family in ("bert", "xlnet"):
        paths[f"threefry_step_{family}"], records[family] = (
            threefry_step_check(family, args.seed, fa, card))
    print(json.dumps({"threefry_steps": records, "card": card}))
    return paths, records


def _beside_6p(args, fa, card):
    return list(par_driver_paths(args, fa, card))


def _beside_6r_6s(args, fa, card):
    import concurrent.futures
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_6r_")
    try:
        # 6q's untimed --fsdp --model_parallel 2 processes beside 6r/6s
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            fsdp = pool.submit(mp_fsdp_tp_path, args, fa, card, work)
            counts = data_ranks_path(args, fa, card)
            fsdp_counts, fsdp_lines = fsdp.result()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("\n".join(fsdp_lines))
    return [{**counts, **fsdp_counts}]


BESIDE_PHASES = {"6p": _beside_6p, "6r/6s": _beside_6r_6s}


def phase_process(name, args) -> int:
    """``python3 chip_smoke.py --phase NAME``: one of ``BESIDE_PHASES`` in
    this process, its launch counts this process's own (the kernels loaded
    from the build the starting process made, or built here when run
    alone); prints the phase's result and its seconds as JSON on the last
    line."""
    import torch

    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as fa,
    )
    from bert_multimodal_transformer_tpu_torch.ops import kernels as tk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    tk.load_kernels()
    result = BESIDE_PHASES[name](args, fa, _card())
    print(json.dumps({"phase_result": result,
                      "seconds": time.perf_counter() - t0}))
    return 0


def _start_phase_process(name, args, work):
    """Starts ``--phase name`` in a session of its own (so that its ranks
    can be stopped with it), its output into a file under ``work``."""
    log = open(os.path.join(work, f"phase_{name.replace('/', '_')}.log"),
               "w+")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(args.seed),
         "--phase", name], stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, WANDB_MODE="disabled"), start_new_session=True)
    return proc, log, time.perf_counter()


def _stop_process_group(proc):
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _join_phase_process(name, proc, log, t0):
    """Waits for a ``--phase`` process (within BESIDE_TIMEOUT_S of its
    start), prints its output, and returns its result; raises when it
    failed."""
    try:
        rc = proc.wait(max(BESIDE_TIMEOUT_S - (time.perf_counter() - t0),
                           1.0))
    finally:
        _stop_process_group(proc)
        log.seek(0)
        lines = log.read().splitlines()
        log.close()
    res = [ln for ln in lines if ln.startswith('{"phase_result"')]
    print("\n".join(ln for ln in lines if not ln.startswith(
        '{"phase_result"')))
    if rc != 0 or not res:
        raise AssertionError(f"phase {name} (its own process) exited {rc}")
    out = json.loads(res[-1])
    _BESIDE_SECONDS[f"{name} (its own process, beside)"] = out["seconds"]
    return out["phase_result"]


_PHASES = []


def _phase(name):
    """Marks where phase ``name`` of ``main`` starts."""
    _PHASES.append((name, time.perf_counter()))


def _phase_seconds():
    """Each marked phase's wall seconds, from its mark to the next (the
    last to now)."""
    marks = _PHASES + [(None, time.perf_counter())]
    return {**{a: tb - ta for (a, ta), (_, tb) in zip(marks, marks[1:])},
            **_BESIDE_SECONDS}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mp_driver", type=str, default=None,
                        help="run one driver process of phase 6q: the "
                             "driver's arguments as a JSON list")
    parser.add_argument("--phase", choices=sorted(BESIDE_PHASES),
                        default=None,
                        help="run one of the phases that run beside "
                             "others, in this process (the kernels built)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if args.mp_driver is not None:
        return mp_driver_process(json.loads(args.mp_driver))
    if args.phase is not None:
        return phase_process(args.phase, args)

    from bert_multimodal_transformer_tpu_torch.config import (
        BertConfig,
        DatasetConfig,
        MultimodalConfig,
    )
    from bert_multimodal_transformer_tpu_torch.models.bert import (
        MagBertForSequenceClassification,
    )
    from bert_multimodal_transformer_tpu_torch.ops import (
        fused_attention as fa,
    )
    from bert_multimodal_transformer_tpu_torch.ops import kernels as tk
    from bert_multimodal_transformer_tpu_torch.ops import mag_fused as mf
    from bert_multimodal_transformer_tpu_torch.serving import Predictor
    from bert_multimodal_transformer_tpu_torch.utils.seeding import (
        set_random_seed,
    )

    # fp32 products in full fp32, so the fp32 comparison means what it says
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    _phase("1")
    # 1. Device
    card = _card()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}")

    _phase("2")
    # 2. Build
    t0 = time.perf_counter()
    lib_path = tk.build_kernels()
    tk.load_kernels()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path}")
    build_log = lib_path.with_suffix(".log").read_text().strip()
    print(build_log)
    for line in tc_ptxas_lines(build_log):
        print(line)

    _phase("3")
    # 3. Kernel against plain, on the card
    rng = np.random.default_rng(args.seed)
    serve_err, serve_case = check_kernel(rng, fa, "bf16", BATCH, S_SERVE)
    check_kernel(rng, fa, "bf16", 8, 512)
    check_kernel(rng, fa, "fp32", 4, 77)
    # bf16 #1's tensor-core plans at their edges, from a stream of their
    # own (phase 3b's too) so that every later phase sees the inputs it saw
    # before
    tc_rng = np.random.default_rng([args.seed, 16])
    for b, s, h, dh in FULL_TC_SERVE_EDGES:
        serve_err = max(serve_err,
                        check_kernel(tc_rng, fa, "bf16", b, s, h, dh)[0])
    qkv, mask, scale, h = serve_case

    def run_kernel():
        fa.attn_fwd_packed_cuda(qkv, mask, n_heads=h, scale=scale)

    def run_plain():
        fa.attn_fwd_packed_reference(qkv, mask, n_heads=h, scale=scale)

    for fn in (run_plain, run_kernel):
        _time_ms(fn, 10)  # warm-up
    rounds = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        rounds[name].append(_time_ms(
            run_kernel if name == "kernel" else run_plain, 100))
    kernel_ms = float(np.mean(rounds["kernel"]))
    plain_ms = float(np.mean(rounds["plain"]))
    sdpa, lib_out = sdpa_call(qkv, mask, h, scale)
    _time_ms(sdpa, 10)
    lib_rounds = [_time_ms(sdpa, 100) for _ in range(2)]
    library_ms = float(np.mean(lib_rounds))
    serve_bound = attn_bound("fwd", BATCH, S_SERVE, h, 64, 2)
    lib_err = float((lib_out.float() - fa.attn_fwd_packed_cuda(
        qkv, mask, n_heads=h, scale=scale).float()).abs().max())
    print(f"attn_fwd_packed bf16 B={BATCH} S={S_SERVE} H=12 Dh=64 on "
          f"{card}: kernel {rounds['kernel']} ms, plain {rounds['plain']} "
          f"ms, scaled_dot_product_attention {lib_rounds} ms per call "
          f"(max |Δ| to the kernel {lib_err:.3e}); bound "
          f"{serve_bound[0]:.4f} ms ({serve_bound[1]})")

    _phase("3b")
    # 3b. Training kernels against plain, on the card
    train_errs = {}
    bench_case = None
    for dtype_name, b, s in (("bf16", BENCH_BATCH, S_SERVE),
                             ("fp32", 4, 77)):
        for rate in (RATE, 0.0):
            errs, case = check_training_kernels(rng, fa, dtype_name, b, s,
                                                rate)
            for k, v in errs.items():
                train_errs[k] = max(train_errs.get(k, 0.0), v)
            if dtype_name == "bf16" and rate > 0:
                bench_case = case
    for b, s, h, dh in FULL_TC_EDGES:
        for rate in (RATE, 0.0):
            errs, _ = check_training_kernels(tc_rng, fa, "bf16", b, s, rate,
                                             h, dh)
            for k, v in errs.items():
                train_errs[k] = max(train_errs[k], v)
    for b, s, h, dh in FULL_TC_FWD_EDGES:
        for rate in (RATE, 0.0):
            train_errs["fwd"] = max(train_errs["fwd"], check_forward_modes(
                tc_rng, fa, b, s, rate, h, dh))
    train_times = time_training_kernels(fa, bench_case, card)
    full_tc_times = time_full_tc(tc_rng, fa, card, bench_case, serve_case)
    del bench_case
    torch.cuda.empty_cache()

    _phase("3c")
    # 3c. The fused MAG gate's kernels against plain, on the card
    mag_errs = check_mag_kernels(rng, mf)
    mag_times = time_mag_kernels(rng, mf, card)

    _phase("3d")
    # 3d. The rel-attention kernels against plain, on the card
    rel_errs = {}
    rel_case_b256 = None
    for dtype_name, b, q_len, k_len, rates in (
            ("bf16", BENCH_BATCH, S_SERVE, S_SERVE, (RATE, 0.0)),
            ("fp32", 4, S_SERVE, 77, (RATE,))):
        for rate in rates:
            errs, case = check_rel_kernels(rng, fa, dtype_name, b, q_len,
                                           k_len, rate)
            for k_, v_ in errs.items():
                rel_errs[k_] = max(rel_errs.get(k_, 0.0), v_)
            if dtype_name == "bf16" and rate > 0:
                rel_case_b256 = case
    # bf16 #11's and #13's tensor-core plans at their edges, from a stream
    # of their own so that every later phase sees the inputs it saw before
    rel_tc_rng = np.random.default_rng([args.seed, 17])
    mem_case = None
    for b, q_len, k_len, h, dh, rates, masked in REL_TC_EDGES:
        for rate in rates:
            errs, case = check_rel_kernels(rel_tc_rng, fa, "bf16", b, q_len,
                                           k_len, rate, h, dh, masked)
            for k_, v_ in errs.items():
                rel_errs[k_] = max(rel_errs.get(k_, 0.0), v_)
            if (b, q_len, k_len, rate) == (BENCH_BATCH, S_SERVE,
                                           2 * S_SERVE, RATE):
                mem_case = case
    rel_times = time_rel_kernels(fa, rel_case_b256, mem_case, card)
    del rel_case_b256, mem_case
    torch.cuda.empty_cache()
    # the shard's counter offsets of the rel family (#11, #12, #20, #21,
    # #23, #24), from a stream of their own
    offset_rng = np.random.default_rng([args.seed, 26])
    offsets = check_rel_offsets(offset_rng, fa)
    one_rank_times = time_rel_one_rank(offset_rng, fa, card)

    _phase("3e")
    # 3e. The long-sequence kernels against plain, on the card
    long_errs = {}
    cases = [("bf16", 8, s, rate) for s in LONG_S for rate in (RATE, 0.0)]
    cases += [("fp32", 2, 600, RATE), ("fp32", 2, 700, RATE)]
    for dtype_name, b, s, rate in cases:
        errs, _ = check_long_kernels(rng, fa, dtype_name, b, s, rate)
        for k_, v_ in errs.items():
            long_errs[k_] = max(long_errs.get(k_, 0.0), v_)
    # The tensor-core plan's edges (#6, #23 bf16), from a stream of their
    # own so that every later phase sees the inputs it saw before
    edge_rng = np.random.default_rng([args.seed, 11])
    for b, s, h, dh in FS_EDGES:
        for rate in (RATE, 0.0):
            errs, _ = check_long_kernels(edge_rng, fa, "bf16", b, s, rate, h,
                                         dh)
            for k_, v_ in errs.items():
                long_errs[k_] = max(long_errs.get(k_, 0.0), v_)
    # #4's and #7's, from a stream of their own likewise
    hb_edge_rng = np.random.default_rng([args.seed, 12])
    for b, s, h, dh in HB_EDGES:
        for rate in (RATE, 0.0):
            errs, _ = check_long_kernels(hb_edge_rng, fa, "bf16", b, s, rate,
                                         h, dh)
            for k_, v_ in errs.items():
                long_errs[k_] = max(long_errs.get(k_, 0.0), v_)
    # #5's, from a stream of their own likewise
    hb_bwd_edge_rng = np.random.default_rng([args.seed, 13])
    for b, s, h, dh in HB_BWD_EDGES:
        for rate in (RATE, 0.0):
            errs, _ = check_long_kernels(hb_bwd_edge_rng, fa, "bf16", b, s,
                                         rate, h, dh)
            for k_, v_ in errs.items():
                long_errs[k_] = max(long_errs.get(k_, 0.0), v_)
    check_long_against_full(rng, fa)
    check_long_masks(rng, fa)
    long_times = time_long_kernels(rng, fa, card)

    _phase("3f")
    # 3f. The long-sequence rel kernels against plain, on the card
    long_rel_errs = {}
    cases = [("bf16", 8, s, rate) for s in XLNET_LONG_S
             for rate in (RATE, 0.0)]
    cases += [("fp32", 2, 600, RATE)]
    for dtype_name, b, s, rate in cases:
        for k_, v_ in check_long_rel_kernels(rng, fa, dtype_name, b, s,
                                             rate).items():
            long_rel_errs[k_] = max(long_rel_errs.get(k_, 0.0), v_)
    for b, s, k_len, h, dh in RELIK_FS_EDGES:
        for rate in (RATE, 0.0):
            for k_, v_ in check_long_rel_kernels(edge_rng, fa, "bf16", b, s,
                                                 rate, h, dh,
                                                 k_len).items():
                long_rel_errs[k_] = max(long_rel_errs.get(k_, 0.0), v_)
    check_long_rel_against_full(rng, fa)
    check_relik_mask(rng, fa)
    long_rel_times = time_long_rel_kernels(rng, fa, card)

    _phase("3g")
    # 3g. The rel flash-streamed kernels against plain, on the card
    rel_fs_errs = {}
    for dtype_name, b, q_len, k_len in REL_FS_CASES:
        for rate in (RATE, 0.0):
            for k_, v_ in check_rel_fs_kernels(rng, fa, dtype_name, b, q_len,
                                               k_len, rate).items():
                rel_fs_errs[k_] = max(rel_fs_errs.get(k_, 0.0), v_)
    # bf16 #16's edges, from a stream of their own
    rel_fs_edge_rng = np.random.default_rng([args.seed, 14])
    for b, q_len, k_len, h, dh in REL_FS_EDGES:
        for rate in (RATE, 0.0):
            for k_, v_ in check_rel_fs_kernels(
                    rel_fs_edge_rng, fa, "bf16", b, q_len, k_len, rate, h, dh,
                    masked=True).items():
                rel_fs_errs[k_] = max(rel_fs_errs.get(k_, 0.0), v_)
    torch.cuda.empty_cache()
    check_rel_fs_against_hb(rng, fa)
    # #15's and #17's keep masks, from a stream of their own
    check_rel_bwd_masks(np.random.default_rng([args.seed, 15]), fa)
    rel_fs_times = time_rel_fs_kernels(rng, fa, card)

    _phase("3h")
    # 3h. The full-H ingredients kernels (rel_bias_impl="inkernel"). Its
    # phases (3h, 4g, 6f) draw from a stream of their own, so every other
    # phase sees the inputs it saw before they were added.
    ik_rng = np.random.default_rng([args.seed, 8])
    relik_errs, relik_same, relik_train_case = {}, {}, None
    for dtype_name, b, q_len, k_len, rates in RELIK_FULL_CASES:
        for rate in rates:
            errs, same, case = check_relik_full_kernels(
                ik_rng, fa, dtype_name, b, q_len, k_len, rate)
            for k_, v_ in errs.items():
                relik_errs[k_] = max(relik_errs.get(k_, 0.0), v_)
            for k_, v_ in same.items():
                relik_same[k_] = relik_same.get(k_, True) and v_
            if (dtype_name, b, k_len, rate) == ("bf16", BENCH_BATCH,
                                                S_SERVE, RATE):
                relik_train_case = case
    # bf16 #20's and #21's tensor-core plans at their edges, from a stream
    # of their own so that every later phase sees the inputs it saw before
    relik_tc_rng = np.random.default_rng([args.seed, 18])
    for b, q_len, k_len, h, dh in RELIK_TC_EDGES:
        for rate in (RATE, 0.0):
            errs, same, _ = check_relik_full_kernels(
                relik_tc_rng, fa, "bf16", b, q_len, k_len, rate, h, dh)
            for k_, v_ in errs.items():
                relik_errs[k_] = max(relik_errs.get(k_, 0.0), v_)
            for k_, v_ in same.items():
                relik_same[k_] = relik_same.get(k_, True) and v_
    torch.cuda.empty_cache()
    check_relik_full_against_rel(fa, relik_train_case)
    relik_times = time_relik_full_kernels(fa, relik_train_case, card)
    del relik_train_case
    torch.cuda.empty_cache()

    _phase("3i")
    # 3i. The split-layout kernels #8-#10 (tensor parallelism), at all
    # heads and at one rank's; they and 4h draw from a stream of their own
    tp_rng = np.random.default_rng([args.seed, 9])
    split_errs = {}
    for dtype_name, b, s, h, rates, offs in SPLIT_CASES:
        for rate in rates:
            for k_, v_ in check_split_kernels(tp_rng, fa, dtype_name, b, s, h,
                                              rate, offs).items():
                split_errs[k_] = max(split_errs.get(k_, 0.0), v_)
    split_times = time_split_kernels(tp_rng, fa, card)
    torch.cuda.empty_cache()

    _phase("3j")
    # 3j. The QKV-projection kernels #18/#19 (qkv_fusion); they, 4i and 6h
    # draw from a stream of their own
    qp_rng = np.random.default_rng([args.seed, 10])
    qkvproj_errs, qkvproj_train_case = {}, None
    for dtype_name, b, s, h, rates in QKVPROJ_CASES:
        for rate in rates:
            errs, case = check_qkvproj_kernels(qp_rng, fa, dtype_name, b, s,
                                               h, rate)
            for k_, v_ in errs.items():
                qkvproj_errs[k_] = max(qkvproj_errs.get(k_, 0.0), v_)
            if (dtype_name, b, h, rate) == ("bf16", BENCH_BATCH, 12, RATE):
                qkvproj_train_case = case
    qkvproj_errs["#18"] = max(qkvproj_errs["#18"],
                              check_qkvproj_serving_mode(qp_rng, fa))
    edge_qp_rng = np.random.default_rng([args.seed, 23])
    for dtype_name, b, s, h, rates in QKVPROJ_EDGES:
        for rate in rates:
            errs, _ = check_qkvproj_kernels(edge_qp_rng, fa, dtype_name, b,
                                            s, h, rate)
            for k_, v_ in errs.items():
                qkvproj_errs[k_] = max(qkvproj_errs.get(k_, 0.0), v_)
    qkvproj_errs["#18"] = max(qkvproj_errs["#18"],
                              check_qkvproj_reach(edge_qp_rng, fa))
    qkvproj_times = time_qkvproj_kernels(fa, qkvproj_train_case, card)
    del qkvproj_train_case
    torch.cuda.empty_cache()

    _phase("3k")
    # 3k. Kernel T, the threefry dropout, from a stream of its own
    threefry_fields = check_threefry_kernel(
        np.random.default_rng([args.seed, 28]), card)
    torch.cuda.empty_cache()

    _phase("4")
    # 4. Main path
    ds = DatasetConfig.mosi()
    cfg = dataclasses.replace(BertConfig.bert_base_uncased(),
                              attention_impl="fused")
    gen = set_random_seed(args.seed, device="cuda")
    model = MagBertForSequenceClassification(
        cfg, MultimodalConfig(), ds.visual_dim, ds.acoustic_dim,
        torch.bfloat16, device="cuda", generator=gen)
    split = make_split(rng, N_TEST, S_SERVE, cfg.vocab_size, ds.visual_dim,
                       ds.acoustic_dim)
    requests = [make_split(rng, REQUEST_SIZE, S_SERVE, cfg.vocab_size,
                           ds.visual_dim, ds.acoustic_dim).as_tuple()[:5]
                for _ in range(N_REQUESTS)]
    predictor = Predictor(model, batch_size=BATCH)

    def bert_einsum():
        m = MagBertForSequenceClassification(
            dataclasses.replace(cfg, attention_impl="einsum"),
            MultimodalConfig(), ds.visual_dim, ds.acoustic_dim,
            torch.bfloat16, device="cuda")
        m.load_state_dict(model.state_dict())
        return m

    serve_counts = serving_path(fa, card, "bert-base", predictor,
                                bert_einsum, split, requests,
                                "attn_fwd_packed", cfg.num_hidden_layers)

    _phase("4b")
    # 4b. Training path
    model_args = (cfg, MultimodalConfig(), ds.visual_dim, ds.acoustic_dim)
    train_counts, recompute_counts, weights = train_path(
        args, rng, fa, model_args, card)

    _phase("4c")
    # 4c. XLNet serving
    xlnet_serve_counts = xlnet_serving(args, rng, fa, card)

    _phase("4d")
    # 4d. Long-sequence BERT serving (S = 640, 1024)
    long_serve_counts = long_serving(args, rng, fa, card)

    _phase("4e")
    # 4e. Long-sequence XLNet serving (S = 640, 1024)
    xlnet_long_serve_counts = xlnet_long_serving(args, rng, fa, card)

    _phase("4f")
    # 4f. XLNet serving through the rel fs tier: stream at S = 1024, and
    # the memory at S = 512
    xlnet_fs_serve_counts = xlnet_fs_serving(args, rng, fa, card)

    _phase("4g")
    # 4g. XLNet serving under rel_bias_impl="inkernel" (#20)
    xlnet_ik_serve_counts = xlnet_inkernel_serving(args, ik_rng, fa, card)

    _phase("4h")
    # 4h. Tensor-parallel serving: Predictor(mesh=) over two ranks (#8)
    tp_serve_counts = tp_serving(args, tp_rng, fa, card)

    _phase("4i")
    # 4i. Serving with the QKV projection inside the kernel (#18)
    qkvproj_serve_counts = qkvproj_serving(args, qp_rng, fa, card)

    _phase("4j")
    # 4j. Tensor-parallel MAG-XLNet serving: Predictor(mesh=), #11 at H=6
    # a rank; 4k. flash serving at S=512 (#6). From streams of their own.
    xtp_serve_counts = xlnet_tp_serving(
        args, np.random.default_rng([args.seed, 27]), fa, card)
    flash_serve_counts, flash_times = flash_serving(
        args, np.random.default_rng([args.seed, 28]), fa, card)

    _phase("5")
    # 5. Profile
    profile_batch(predictor, split, card)
    del predictor, model

    _phase("5b")
    # 5b. Training speed and profile
    def bert_model(impl):
        m = MagBertForSequenceClassification(
            dataclasses.replace(cfg, attention_impl=impl), MultimodalConfig(),
            ds.visual_dim, ds.acoustic_dim, torch.bfloat16, device="cuda")
        m.load_state_dict(weights)
        return m

    train_speed(args, bert_model, _device_batch(make_split(
        rng, BENCH_BATCH, S_SERVE, cfg.vocab_size, ds.visual_dim,
        ds.acoustic_dim).as_tuple()), card, "bert-base")

    _phase("6")
    # 6. The driver on the card, with the fused gate
    driver_counts = driver_path(args, rng, fa, card)

    _phase("6b")
    # 6b. The XLNet driver on the card
    xlnet_train_counts, xlnet_recompute_counts = xlnet_driver_path(
        args, rng, fa, card)

    _phase("6c")
    # 6c. The driver at --max_seq_length 512 and 1024, and what sets a
    # long-S step
    long_driver_counts = long_driver_path(args, fa, card)
    long_step_profile(args, rng, card)

    _phase("6d")
    # 6d. The XLNet driver at --max_seq_length 512 and 1024, and with
    # --rel_bias_impl stream at 512; the gradient check; a long-S step
    xlnet_long_driver_counts = xlnet_long_driver_path(args, rng, fa, card)

    _phase("6e")
    # 6e. The XLNet driver through the rel fs tier and with --mem_len; the
    # S=1024 stream gradient check
    xlnet_fs_driver_counts = xlnet_fs_driver_path(args, rng, fa, card)

    _phase("6f")
    # 6f. The XLNet driver under --rel_bias_impl inkernel (#20-#22); the
    # S=50 gradient check; the B=256 step under inkernel and auto
    xlnet_ik_driver_counts = xlnet_inkernel_driver_path(args, ik_rng, fa,
                                                        card)

    _phase("6g")
    # 6g. The tensor-parallel driver (--model_parallel 2
    # --tp_shard_attention: #8, #10) and the two-rank step against one card
    tp_driver_counts = tp_driver_path(args, fa, card)

    _phase("6h")
    # 6h. The driver with --qkv_fusion (#18, #19), its gradient check and
    # the B=256 step with and without it
    qkvproj_driver_counts = qkvproj_driver_path(args, qp_rng, fa, card)

    _phase("6i")
    # 6i. Checkpoint, resume and warm start through the driver; the
    # checkpoint's save and restore times and bytes
    ckpt_driver_counts, ckpt_timing = checkpoint_driver_path(args, fa, card)
    print(json.dumps({"checkpoint": ckpt_timing, "card": card}))

    _phase("6j")
    # 6j. The serving artifact: portable, and fused (#1; #11 and #25)
    artifact_counts, artifact = artifact_path(
        args, np.random.default_rng([args.seed, 24]), fa, card)
    print(json.dumps({"artifact": artifact, "card": card}))

    _phase("6k")
    # 6k. Rematerialized training through the driver; peak memory and step
    # time with and without remat at long S
    remat_counts, remat = remat_driver_path(args, fa, card)
    print(json.dumps({"remat_memory": remat, "card": card}))

    _phase("6t")
    # 6t. The driver under --rng_impl threefry2x32 (T, #1′/#3, #25/#26) and
    # the card's threefry steps against the CPU's
    threefry_counts, _ = threefry_driver_path(args, fa, card)
    torch.cuda.empty_cache()

    # 6l-6s: the rank phases. 6p, and 6r/6s with 6q's --fsdp
    # --model_parallel 2 run, each run in a process of their own (their
    # launch counts their own) beside 6l-6o in this one: 6p from 6l's start,
    # 6r/6s from 6n's, after 6l's S=512 steps. Their ranks share the card
    # and the host's cores, so no wall they print has either to itself.
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_6q_")
    beside = {}
    try:
        _phase("6l")
        beside["6p"] = _start_phase_process("6p", args, work)
        # 6l. The tensor-parallel MAG-XLNet driver (#11/#13; inkernel
        # #20/#22) and its step checks (#23/#24 at S=512); 6m. the flash
        # driver and the dropout-0 step through #6/#7
        xtp_driver_counts = xlnet_tp_driver_path(args, fa, card)
        _phase("6m")
        flash_driver_counts = flash_driver_path(args, rng, fa, card)

        _phase("6n/6o")
        beside["6r/6s"] = _start_phase_process("6r/6s", args, work)
        # 6n. The pipelined BERT driver (#1′/#3 on each stage's layers,
        # #25/#26 on stage 0) and its step checks; 6o. the same for XLNet
        # (#11′/#13)
        pp_counts = pp_driver_path(args, fa, card)
        # 6p. PP×TP, FSDP and FSDP×TP (#8/#10), with the peak memory under
        # FSDP; 6r. the XLNet memory over two data ranks (#11′ and #13 at
        # K = 100, #11) and 6s. the explicit-collectives step (#1′/#3),
        # beside 6q's --fsdp --model_parallel 2 over two processes
        _phase("6p, 6r/6s: the rest")
        par_counts, fsdp_peaks = _join_phase_process("6p", *beside.pop("6p"))
        print(json.dumps({"fsdp_peak_memory": fsdp_peaks, "card": card}))
        (mp_counts,) = _join_phase_process("6r/6s", *beside.pop("6r/6s"))

        # 6q. Two driver processes (--num_processes 2) on the card against
        # one process's two ranks (#1′/#3, #25/#26), alone, for the walls
        _phase("6q")
        q_counts, mp_steps = multiprocess_driver_path(args, fa, card, work)
        mp_counts.update(q_counts)
        print(json.dumps({"multiprocess_step_ms": mp_steps, "card": card,
                          "note": "host-staged gloo on one shared card"}))
    finally:
        for proc, _ in beside.values():
            _stop_process_group(proc)
        shutil.rmtree(work, ignore_errors=True)

    _phase("7")
    # 7. Result
    def by_path(name):
        paths = {"serving": serve_counts[name],
                 "train": train_counts[name],
                 "train_recompute": recompute_counts[name],
                 "driver": driver_counts[name],
                 "xlnet_serving": xlnet_serve_counts[name],
                 "xlnet_train": xlnet_train_counts[name],
                 "xlnet_recompute": xlnet_recompute_counts[name],
                 "serving_s640": long_serve_counts[640][name],
                 "serving_s1024": long_serve_counts[1024][name],
                 "driver_s512": long_driver_counts[512][name],
                 "driver_s1024": long_driver_counts[1024][name],
                 "xlnet_serving_s640": xlnet_long_serve_counts[640][name],
                 "xlnet_serving_s1024": xlnet_long_serve_counts[1024][name],
                 **{path: c[name] for path, c in
                    xlnet_long_driver_counts.items()},
                 **{path: c[name] for path, c in
                    xlnet_fs_serve_counts.items()},
                 **{path: c[name] for path, c in
                    xlnet_fs_driver_counts.items()},
                 "xlnet_serving_inkernel": xlnet_ik_serve_counts[name],
                 **{path: c[name] for path, c in
                    xlnet_ik_driver_counts.items()},
                 "tp_serving": tp_serve_counts[name],
                 **{path: c[name] for path, c in tp_driver_counts.items()},
                 "qkvproj_serving": qkvproj_serve_counts[name],
                 **{path: c[name] for path, c in
                    qkvproj_driver_counts.items()},
                 **{path: c[name] for path, c in
                    ckpt_driver_counts.items()},
                 **{path: c[name] for path, c in artifact_counts.items()},
                 **{path: c[name] for path, c in remat_counts.items()},
                 "xlnet_tp_serving": xtp_serve_counts[name],
                 **{path: c[name] for path, c in xtp_driver_counts.items()},
                 "flash_serving": flash_serve_counts[name],
                 **{path: c[name] for path, c in
                    flash_driver_counts.items()},
                 **{path: c[name] for path, c in pp_counts.items()},
                 **{path: c[name] for path, c in par_counts.items()},
                 **{path: c[name] for path, c in mp_counts.items()},
                 **{path: c[name] for path, c in threefry_counts.items()}}
        return sum(paths.values()), paths

    src = "bert_multimodal_transformer_tpu_torch/csrc/"
    tpu = "bert_multimodal_transformer_tpu/ops/"
    train_bounds = {
        "attn_fwd_packed": attn_bound("fwd", BENCH_BATCH, S_SERVE, 12, 64, 2,
                                      RATE, save=True),
        "attn_bwd_packed_saved": attn_bound("bwd_saved", BENCH_BATCH,
                                            S_SERVE, 12, 64, 2, RATE),
        "attn_bwd_packed": attn_bound("bwd", BENCH_BATCH, S_SERVE, 12, 64,
                                      2, RATE)}
    kernels = []
    for name, line, tag in (("attn_fwd_packed", 996, "#1"),
                            ("attn_bwd_packed_saved", 1108, "#3"),
                            ("attn_bwd_packed", 1051, "#2")):
        total, paths = by_path(name)
        bound, by = train_bounds[name]
        entry = {"name": name, "route": "cuda", "source": f"{src}{name}.cu",
                 "replaces": f"{tpu}fused_attention.py:{line}",
                 "launches": total, "launches_by_path": paths,
                 "max_abs_err": train_errs[
                     "fwd" if tag == "#1" else f"{tag} vs plain"],
                 "ms": train_times[name][0],
                 "plain_ms": train_times[name][1],
                 "bound_ms": bound, "bound_by": by,
                 # no one PyTorch call computes the Philox-masked attention
                 # or either backward
                 "library_ms": None,
                 "shape": "bf16 B=256 S=50 H=12 Dh=64 rate 0.1"}
        if tag != "#1":
            entry["max_abs_err_vs_autograd"] = train_errs[
                f"{tag} vs autograd"]
        if name == "attn_fwd_packed":
            entry["max_abs_err"] = max(entry["max_abs_err"], serve_err)
            entry["shape"] += ", saved probs"
            entry["modes"] = {
                "serving rate 0, bf16 B=128 S=50": {
                    "ms": kernel_ms, "plain_ms": plain_ms,
                    "max_abs_err": serve_err,
                    "bound_ms": serve_bound[0],
                    "bound_by": serve_bound[1],
                    "library_ms": library_ms,
                    "library": "scaled_dot_product_attention"},
                f"evaluation rate 0, bf16 B={TRAIN_BATCH} S=512":
                    full_tc_times["eval_s512"]}
        if name in ("attn_fwd_packed", "attn_bwd_packed_saved"):
            entry["device_ms"] = {
                k_: v_ for k_, v_ in full_tc_times["device_ms"].items()
                if k_.startswith("#3" if tag == "#3" else "#1")}
        if name == "attn_bwd_packed_saved":
            entry["pair_vs_head_blocked"] = full_tc_times["pairs"]
        if name == "attn_bwd_packed":
            entry["modes"] = {"rate 0, bf16 B=256 S=50":
                              train_times["attn_bwd_packed rate 0"]}
        kernels.append(entry)
    for name, line in (("mag_fwd", 50), ("mag_bwd", 186)):
        total, paths = by_path(name)
        top = mag_times[BENCH_BATCH * S_SERVE][name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{name}.cu",
            "replaces": f"{tpu}mag_pallas.py:{line}", "launches": total,
            "launches_by_path": paths,
            "max_abs_err": mag_errs[name.split("_")[1]],
            **top, "library_ms": None,
            "shape": "bf16 N=12800 D=768 Dv=47 Da=74",
            "modes": {f"bf16 N={n}": times[name]
                      for n, times in mag_times.items()}})
    rel_bounds = {
        "attn_fwd_rel": rel_bound("fwd", BENCH_BATCH, S_SERVE, S_SERVE, 12,
                                  64, 2, RATE, save=True),
        "attn_bwd_rel_saved": rel_bound("bwd_saved", BENCH_BATCH, S_SERVE,
                                        S_SERVE, 12, 64, 2, RATE),
        "attn_bwd_rel": rel_bound("bwd", BENCH_BATCH, S_SERVE, S_SERVE, 12,
                                  64, 2, RATE)}
    for name, line, tag in (("attn_fwd_rel", 1413, "#11"),
                            ("attn_bwd_rel_saved", 1521, "#13"),
                            ("attn_bwd_rel", 1463, "#12")):
        total, paths = by_path(name)
        bound, by = rel_bounds[name]
        entry = {"name": name, "route": "cuda", "source": f"{src}{name}.cu",
                 "replaces": f"{tpu}fused_attention.py:{line}",
                 "launches": total, "launches_by_path": paths,
                 "max_abs_err": rel_errs[
                     "fwd" if tag == "#11" else f"{tag} vs plain"],
                 "ms": rel_times[name][0], "plain_ms": rel_times[name][1],
                 "bound_ms": bound, "bound_by": by,
                 # the training modes draw the Philox mask (SDPA draws
                 # another) and no one PyTorch call is either backward
                 "library_ms": None,
                 "shape": "bf16 B=256 Q=K=50 H=12 Dh=64 rate 0.1"}
        mem_mode = {"training rate 0.1, saved probs, bf16 B=256 Q=50 K=100"
                    if tag == "#11" else "bf16 B=256 Q=50 K=100 rate 0.1":
                    rel_times["mem"][name]} if name in rel_times["mem"] else {}
        if tag == "#11":
            # the top-level numbers at the serving mode, where one PyTorch
            # call (SDPA with the ebias as its float mask) computes the
            # same function; the training modes beside it
            training = {k_: entry[k_] for k_ in ("ms", "plain_ms",
                                                 "bound_ms", "bound_by")}
            training["library_ms"] = None
            entry.update(rel_times["serving"])
            entry["shape"] = "bf16 B=128 Q=K=50 H=12 Dh=64 rate 0"
            entry["modes"] = {
                "training rate 0.1, saved probs, bf16 B=256 Q=K=50":
                    training, **mem_mode}
        else:
            entry["max_abs_err_vs_autograd"] = rel_errs[f"{tag} vs autograd"]
            if mem_mode:
                entry["modes"] = mem_mode
            if tag == "#12":
                entry["modes"] = {"rate 0, bf16 B=256 Q=K=50":
                                  rel_times["attn_bwd_rel rate 0"]}
        if name in rel_times["mem"]:
            entry["device_ms_per_launch"] = {
                k_: v_ for k_, v_ in rel_times["device_ms"].items()
                if k_.startswith(tag)}
        kernels.append(entry)
    for name, line, tag, shape in (
            ("attn_fwd_packed_hb", 1146, "#4", "S=512"),
            ("attn_bwd_packed_hb", 1195, "#5", "S=512"),
            ("attn_fwd_packed_fs", 1256, "#6", "S=1024"),
            ("attn_bwd_packed_fs", 1328, "#7", "S=1024")):
        total, paths = by_path(name)
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{name}.cu",
            "replaces": f"{tpu}fused_attention.py:{line}",
            "launches": total, "launches_by_path": paths,
            "max_abs_err": long_errs[tag],
            **long_times[name],
            "shape": f"bf16 B={TRAIN_BATCH} {shape} H=12 Dh=64 rate 0"})
    kernels[-3]["launches_note"] = ("two kernel launches a call in bf16: the "
                                    "statistics + dQ pass and the dK/dV pass")
    kernels[-1]["launches_note"] = ("two kernel launches a call: the dK/dV "
                                    "pass and the dQ pass")
    for name, line, tag, shape in (
            ("attn_fwd_rel_hb", 1560, "#14", "S=512"),
            ("attn_bwd_rel_hb", 1601, "#15", "S=512"),
            ("attn_fwd_relik_fs", 4272, "#23", "S=1024"),
            ("attn_bwd_relik_fs", 4345, "#24", "S=1024")):
        total, paths = by_path(name)
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{name}.cu",
            "replaces": f"{tpu}fused_attention.py:{line}",
            "launches": total, "launches_by_path": paths,
            "max_abs_err": max(long_rel_errs[tag],
                               rel_fs_errs.get(tag, 0.0)),
            **long_rel_times[name],
            "shape": f"bf16 B={TRAIN_BATCH} {shape} H=12 Dh=64 rate 0"})
    kernels[-3]["launches_note"] = ("two kernel launches a call in bf16: the "
                                    "statistics + dQ + debias pass and the "
                                    "dK/dV pass")
    kernels[-1]["launches_note"] = ("three kernel launches a call: the dK/dV "
                                    "pass, the drw/drr/ded/dr-window pass and "
                                    "the dr sum over the batch")
    for name, line, tag in (("attn_fwd_rel_fs", 1661, "#16"),
                            ("attn_bwd_rel_fs", 1722, "#17")):
        total, paths = by_path(name)
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{name}.cu",
            "replaces": f"{tpu}fused_attention.py:{line}",
            "launches": total, "launches_by_path": paths,
            "max_abs_err": rel_fs_errs[tag],
            **rel_fs_times[name],
            "shape": f"bf16 B={TRAIN_BATCH} Q=K=1024 H=12 Dh=64 rate 0"})
    kernels[-1]["launches_note"] = ("two kernel launches a call: the dK/dV "
                                    "pass and the dQ/debias pass")
    for name, line, tag in (("attn_fwd_relik", 3690, "#20"),
                            ("attn_bwd_relik_saved", 3809, "#22"),
                            ("attn_bwd_relik", 3758, "#21")):
        total, paths = by_path(name)
        entry = {"name": name, "route": "cuda", "source": f"{src}{name}.cu",
                 "replaces": f"{tpu}fused_attention.py:{line}",
                 "launches": total, "launches_by_path": paths,
                 "max_abs_err": relik_errs[tag],
                 "identical_to_plain": relik_same[tag], **relik_times[name]}
        if tag != "#20":
            entry["launches_note"] = ("two kernel launches a call: the "
                                      "(head, batch row) pass and the dr sum "
                                      "over the batch")
        kernels.append(entry)
    for name, line, tag in (("attn_fwd_split", 852, "#8"),
                            ("attn_bwd_split_saved", 962, "#10"),
                            ("attn_bwd_split", 905, "#9")):
        total, paths = by_path(name)
        entry = {"name": name, "route": "cuda", "source": f"{src}{name}.cu",
                 "replaces": f"{tpu}fused_attention.py:{line}",
                 "launches": total, "launches_by_path": paths,
                 "max_abs_err": split_errs[
                     tag if tag == "#8" else f"{tag} vs plain"],
                 **split_times[name]}
        if tag != "#8":
            entry["max_abs_err_vs_autograd"] = split_errs[
                f"{tag} vs autograd"]
        if tag == "#9":
            entry["launches_note"] = ("the TP driver saves the probs; #9 "
                                      "runs past the 256 MB cap or under "
                                      "FUSED_ATTN_SAVE=0 (the recompute "
                                      "steps of phase 6g)")
        kernels.append(entry)
    for name, line, tag in (("attn_fwd_qkvproj", 3082, "#18"),
                            ("attn_bwd_qkvproj", 3140, "#19")):
        total, paths = by_path(name)
        entry = {"name": name, "route": "cuda", "source": f"{src}{name}.cu",
                 "replaces": f"{tpu}fused_attention.py:{line}",
                 "launches": total, "launches_by_path": paths,
                 "max_abs_err": qkvproj_errs[
                     tag if tag == "#18" else f"{tag} vs plain"],
                 **qkvproj_times[name]}
        if tag == "#19":
            entry["max_abs_err_vs_autograd"] = qkvproj_errs[
                "#19 vs autograd"]
            entry["launches_note"] = ("two kernel launches a call: the "
                                      "(head, batch row) pass and the dx "
                                      "product")
        kernels.append(entry)
    offset_tags = {"attn_fwd_rel": "#11", "attn_bwd_rel": "#12",
                   "attn_fwd_relik": "#20", "attn_bwd_relik": "#21",
                   "attn_fwd_relik_fs": "#23", "attn_bwd_relik_fs": "#24"}
    for entry in kernels:
        name = entry["name"]
        if name in one_rank_times:
            entry.setdefault("modes", {})[
                f"one TP rank, {one_rank_times[name]['shape']}"] = (
                    one_rank_times[name])
        if name in offset_tags:
            entry["counter_offsets_bit_exact"] = {
                k_: v_[0] for k_, v_ in offsets.items()
                if k_.startswith(offset_tags[name] + " ")}
        if name == "attn_fwd_packed_fs":
            entry.setdefault("modes", {})[
                "attention_impl=flash serving, " + flash_times["shape"]] = (
                    flash_times)
    # T: no Pallas kernel; the JAX model's dropout under threefry2x32 is
    # XLA's threefry with jax.random.bernoulli in flax's nn.Dropout
    total, paths = by_path("threefry_dropout")
    kernels.append({
        "name": "threefry_dropout", "route": "cuda",
        "source": f"{src}threefry_dropout.cu",
        "replaces": ("none (not a Pallas kernel): flax nn.Dropout on "
                     "jax.random.bernoulli under threefry2x32, "
                     "bert_multimodal_transformer_tpu/models/bert.py:91"),
        "launches": total, "launches_by_path": paths, **threefry_fields})
    for entry in kernels:
        if entry["launches"] == 0:
            raise AssertionError(f"{entry['name']} never ran on the path")
    print(json.dumps({"phase_seconds": _phase_seconds(), "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
