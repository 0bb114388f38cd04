#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases, in order; any failure raises and the script exits non-zero:

  1. build        compile the four CUDA sources of
                  `paddle_tpu_torch/kernels/csrc`, one nvcc each, all started
                  together; count the HGMMA (wgmma) instructions of every
                  instantiation of the TMA kernels (B1, B2, B3, B8's
                  prefill) and the HMMA (mma.sync) instructions of B5's,
                  B4's and B6/B7's (decode_mma_kernel, by key source:
                  CacheKeys for B4, PagedKeys for B6/B7) and B8's GEMV
                  kernels in their SASS (cuobjdump), B4-B7's in bf16 and
                  fp16; B1's (every type and head_dim), B2's, B3's,
                  B4-B7's, the GEMV's and B10's must compile without spills
                  (ptxas' report).
  2. parity       each kernel against its plain PyTorch version on the same
                  inputs, each error beside its bar: B4 decode (also at
                  B4_CASES: a 1029-key cache, g 1-64, both head dims, rows
                  at 0, mid-tile and len - 1, in bf16 each output vector
                  against the plain version run in f32, a second call
                  bit-identical, and the same bits over a cache holding
                  NaN past each row's pos; GPT-2's decode shape, 12 heads
                  of 64, len 1024, and its 64-row prefill bucket for B5;
                  then planted faults the B4 bar
                  must reject: a split dropped, a split's weight wrong, a
                  key past a row's end, V past pos left in P V), B5 window, B6
                  paged decode, B7 paged decode over int8 pages (ps 16 and 64,
                  GQA), B8 weight-only int8 matmul (the four decode shapes,
                  prefill M 512 and 2048, ragged M/K/N), in bf16 and f32,
                  B4-B7 also in fp16 at bf16's bars (B4_CASES, B5_CASES and
                  PAGED_CASES too, and the planted faults of their bars);
                  B5 at the edges of its key split and row tiles
                  (B5_CASES) and B8's GEMV at M 1-16 with the four decode
                  (K, N), a K tail, N off the vector gate and a weight off
                  16-byte alignment, each output vector also within its own
                  bar of the plain version run in f32 and a second call
                  bit-identical; planted faults the B5 bar must reject (a
                  key split dropped, splits combined without the max
                  rescale, the keys of a split wholly past a row's limit at
                  exp(0), the last partial tile unmasked); B6 and B7 at the
                  edges of their key split (PAGED_CASES: pages of 8-128,
                  g 1-64, rows at 0, 1, mid-page and the full table), in
                  bf16 each output vector also against the plain version
                  run in f32 and a second call bit-identical, then planted
                  faults the B6/B7 bar must reject (the middle of a row's
                  key splits dropped, a split's weight wrong, the last key
                  of a row off by one, B7: a scale from the wrong page);
                  B8's prefill routes in bf16 at their tile edges (M 17-2047
                  with the four serving (K, N), a ragged shape on the TMA
                  gate, two off it: K % 8 != 0, x 2 bytes off alignment),
                  each call's route read off the counters, then planted
                  faults B8's bar must reject (a K tile of the weight left
                  out, one column tile's scales from its neighbour, the /127
                  missing, the K tail left out, every scale from the next
                  channel), at a prefill shape and at a GEMV shape with a K
                  tail (per row); B1 flash forward and B2 + B3 flash
                  backward (the 7B leg's micro-batch, GQA up to groups of
                  8, non-causal,
                  cross-length, ragged, rows that see no key, 129 rows over
                  127 keys and 65 over 129, head_dim 64, f32), each output
                  vector within its own bar; B1 alone in fp16 (head_dim 64
                  and 128) and at head_dim 32 (bf16, fp16, f32)
                  (FLASH_FWD_CASES: config 5's UNet shapes, causal and
                  full, GQA, Sq != Sk, ragged, rows that see no key), at
                  the bf16 bar for fp16 and 1e-5 in f32, a second call
                  bit-identical, one launch a call;
                  then planted faults that the B1-B3 bar must reject (at
                  the GQA case, an fp16 case and a head_dim-32 case); B9 and
                  B10 (RMSNorm forward and backward) at the training legs'
                  micro-batches, the decode rows, a ragged row count, in
                  f32 and in fp16, each row of y and dx within its bar,
                  B10 twice with the same bits and one launch a call, then
                  planted faults their bars must reject (B10's dw: a row
                  group left out, a cluster's partial counted twice or left
                  out).
  2'. c2          fault C2: one row through B4, B5, B6 and B7 in bf16 and in
                  fp16 alone, among 7 rows with the batch's max_pos and
                  among 3 with pos on the card (7B's and GPT-2's decode
                  shapes), bit-identical outputs; one x row through B8's
                  GEMV at M 1, 8, 9 and 16.
      c3          fault C3: B10 on two streams at once, each call its solo
                  bits.
      tune        the block tuner on B8's tile (M 2048 and 8192, K 4096, N
                  11008), on an empty cache: measured, a cache hit, read from
                  disk, the PADDLE_TUNE_BLOCKS pin; the output within B8's
                  bar under each pick.
  2a. train-check the loss and full grad tree of `forward_and_loss` (B1-B3,
                  fused CE) at Llama-2-7B width, 2 layers, s 1024, against an
                  f32 forward written here (materialized attention, unfused
                  CE, plain autograd): f32 weights, then the same weights in
                  bf16 through the bf16 kernels, beside the plain bf16
                  attention (use_flash=False).
  2a'. eager      the eager surface (`import paddle_tpu_torch as paddle`):
                  a to_tensor with no place lands on cuda:0; a Llama loss
                  written against the surface (`eager_llama_loss`:
                  index_select, mean/rsqrt, split/concat RoPE,
                  nn.functional.flash_attention, sigmoid SwiGLU,
                  logsumexp/take_along_axis CE) at Llama-2-7B width, 2
                  layers, b 1 s 2048, causal, against `forward_and_loss`
                  (remat off) on the same weights: f32 loss rel <= 1e-5 and
                  worst grad leaf <= 1e-3, bf16 loss rel <= 1e-3; B1
                  launched >= 2 times in its forward, B2 and B3 >= 2 in its
                  backward. The bf16 step's ms, aten ops and device-busy
                  share beside the functional path's (recorded).
      functional  the op cases of A10a part 2 on the card (see
                  phase_functional).
      namespaces  signal, geometric (with incubate's graph ops), sparse and
                  distribution (ROADMAP A10g part 1) on cuda:0, each output
                  against the port on the CPU from the same seeded inputs,
                  TF32 off: a graph of ogbn-arxiv's size (169,343 nodes,
                  1,166,243 edges, 128 f32 features, made from a seed)
                  through send_u_recv (sum, mean, max, min), send_ue_recv,
                  send_uv, the segment ops, graph_send_recv,
                  sample_neighbors (10) and khop_sampler ([15, 10]) from 1024
                  seeds; stft/istft of 8 x 160,000 samples (n_fft 512, hop
                  160, Hann), frame, overlap_add; a 16384^2 COO and CSR
                  matrix at 0.1% density times a dense [16384, 128],
                  masked_matmul, addmm, value-wise ops; log_prob, entropy
                  and kl_divergence of Normal, MultivariateNormal (d 64),
                  Categorical (32000 classes), Dirichlet, Gamma, Beta, and
                  10^6 draws each repeating under a seed and meeting their
                  moments. Bars: max, min, integer and host-side outputs
                  exact; sums the card adds in another order within 1e-5 of
                  the sum of |terms|; the rest rtol 1e-5, atol 1e-6. One
                  timed call a namespace.
  2a''. layers    the training API (ROADMAP A10b) through the public
                  surface, with no set_device: (a) BASELINE config 1,
                  `paddle.Model(LeNet()).fit` on the synthetic MNIST (batch
                  64, Adam 1e-3, 30 steps, 2 DataLoader workers forked after
                  CUDA is up, whose batches must equal num_workers=0's): the
                  fixed 32-sample loss must fall (< 0.1 recorded), evaluate
                  and a save/load round trip (equal eval outputs); the train
                  step's ms, samples/s and host share (recorded); (b) the
                  layer-built `LlamaForCausalLM` at Llama-2-7B width (2
                  layers, b 1 s 2048, f32, seed 0) against
                  `forward_and_loss` on `params_from_layer` (loss rel <= 1e-5,
                  worst grad leaf <= 1e-3), B1 2 launches a forward, B2/B3 2
                  a backward, B9 5 a forward, B10 5 a backward, from the
                  nn.Layers; then 3 AdamW steps in f32 and 3 under
                  amp.decorate (O2, bf16, f32 masters), each loss below the
                  last, the step's ms and AdamW's share (recorded); (c)
                  nn.MultiHeadAttention(4096, 32) bf16 at s 2048: B1-B3 one
                  launch each, the attention output within B1's bar of
                  `flash_fwd_plain` on the layer's q/k/v; (d) auto_cast makes
                  matmul bf16, keeps softmax f32 and hands B1 bf16 from
                  f32 q/k/v, a float16 GradScaler over an fp16 Linear and
                  RMSNorm (B9 and B10 in fp16, once each) skips a step with
                  a planted inf and halves its scale.
      dist        `paddle.distributed` at world size 1 on NCCL (ROADMAP A9a,
                  A9b's base), no set_device: `init_parallel_env()` takes the
                  card, get_backend() "NCCL"; every collective on a CUDA
                  tensor against its definition at world size 1, bit for bit
                  (point to point needs a peer: CPU tests only); then the
                  layer Llama of the layers leg (7B width, 2 layers, b 1 s
                  2048, f32, seed 0, AdamW, 3 steps) plain, through
                  `paddle.DataParallel` and through `fleet.init` /
                  `distributed_model` / `distributed_optimizer`, one after
                  another: the two wrapped ways give the plain way's losses
                  and parameters bit for bit and its launches a step (B1-B3
                  2, B9/B10 5), the reducer saw every parameter and made its
                  bucket count of all-reduces a step; each way's step ms.
  2a'''. configs BASELINE configs 3 and 2 on one card (ROADMAP A10c/A10d),
                  through the public API with no set_device: (a) config 3,
                  `bert_base()` (dropout 0.1) through `distributed.Engine(
                  dp=1, sharding_stage=2)`, AdamW 5e-5, b 64 s 128 with
                  bench.py's synthetic MLM/NSP labels, 3 warm-up and 16
                  timed steps in f32 (TF32 off) and under amp_level O1: the
                  loss finite and falling, step ms, tokens/s and MFU (6 N
                  tokens/s over the bf16 peak) recorded; two engines from
                  seed 0 give equal losses; eval_batch launches B1 12 times;
                  bert_tiny's 3 Engine steps on the card within rel 1e-4 of
                  the CPU's (losses, every parameter after sync_to_model);
                  (b) bert_base(hidden_dropout_prob=0.0), no mask, Engine
                  O2: B1 12 launches a forward, B2/B3 12 a backward, the
                  first step's loss within rel 1e-2 of the route's predicate
                  false, step ms and MFU; (c) config 2, `Model(resnet50(
                  1000)).fit`, Momentum(1e-2, 0.9), b 64 224^2, 4 warm-up
                  and 24 timed iterations on bench.py's synthetic samples:
                  imgs/s, MFU (3 x 4.089 GFLOPs an image) and the host share
                  of a profiled train_batch; resnet18 one fit step within
                  rel 1e-4 of the CPU's (cuDNN deterministic); (d)
                  vit_b_16 bf16 under amp.decorate(O2), b 8: B1 12, B2/B3
                  12, the loss within rel 1e-2 of the plain route's; (e)
                  GPT-2 small from layers: gpt_params_from_layer -> Gpt ->
                  greedy gpt_generate (B5, B4) against the layer model's
                  full forward (prefill logits rel 1e-4, tokens its argmax),
                  then 3 AdamW steps at b 8 s 1024; (f) nms, roi_align,
                  roi_pool, deform_conv2d and box_coder on the card equal to
                  the CPU's.
  2a''''. unet    BASELINE config 5 (ROADMAP A10e) through the deployment
                  API with no set_device, in bf16 (as bench.py casts) and in
                  fp16 (the Half Predictor's type): `unet_sd_like()` from
                  seed 0, its parameters cast to the type, `jit.save` with
                  a dynamic batch (latents ["batch", 4, 64, 64] in the
                  type, timestep ["batch"] f32) -> `inference.Config` ->
                  `create_predictor` -> `run()` at batch 1, t = 500: the
                  output finite, [1, 4, 64, 64], within rtol 5e-2 atol 1e-1
                  of the eager layer and of the eager layer with the
                  route's predicate false; B1 once an attention block of
                  the model (counted from its modules: 11, level 1's
                  head_dim 32 included) a call from the exported program,
                  nothing else, every B1 call held by `flash_path_check`;
                  the same Predictor at batch 2 within the bar of the eager
                  layer. In bf16 also a program exported with head_dim 32
                  off B1's gate (as before it took it): 6 launches and its
                  latency beside the new one. Then `unet_tiny(
                  base_channels=32, num_heads=1)` in f32 (every attention on
                  B1's gate) saved from the card, through a card and a CPU
                  Predictor on the same files (rel <= 1e-4), and saved from
                  the CPU through a card Predictor (the program moved to the
                  card; rel <= 1e-4). Recorded: latency a call (median of
                  24 after 4 warm-up calls, each copy_from_cpu -> run ->
                  copy_to_cpu, as bench.py times it), the HBM roofline
                  share (bf16 parameter bytes over the latency over the
                  card's memory rate), one profiled call's device-busy
                  share and kernel launches, aten ops a call, export and
                  build times, each dtype; peak memory.
  2a'''''. quant  weight-only int8 through the deployment API (ROADMAP A10f
                  part 1): the layer Llama at Llama-2-7B width (2 layers,
                  seed 0, bf16) behind bench.py's next-token head, `jit.save`
                  with a dynamic batch and sequence, bf16 and
                  quantize="weight_only_int8" -> `create_predictor` -> `run()`
                  at b 2 s 128 (B8's TMA route) and b 8 s 1 (its GEMV): B8
                  15, B1 2 and B9 5 launches a call from the exported
                  program and nothing else, every B8 call within its bar of
                  the plain version run in f32, the logits within 0.05 of
                  max |bf16 Predictor| (the JAX package's weight-only bar);
                  latency a call and tokens/s both ways, the .pdiparams
                  sizes, B8's share of one profiled call's device time read
                  with `paddle_tpu_torch.profiler`. Then the CPU test's tiny
                  quantized Llama saved on the CPU in f32, a card Predictor
                  against a CPU Predictor (rel <= 1e-4; B8's f32 routes), and
                  an int8_ptq Linear at K 4096 saved on the card, its card
                  Predictor equal to a CPU Predictor bit for bit.
      recompute   `LlamaConfig.recompute` (fleet.recompute) on the layer
                  Llama at 7B width (2 layers, b 1 s 2048, f32, TF32 off):
                  the loss equal and each grad leaf within 1e-6 of the run
                  without it; a recomputed step launches B1 4, B2/B3 2, B9 9,
                  B10 5; step ms and peak memory both ways, then the bf16 O2
                  step both ways.
      incubate    12 `incubate.nn.FusedTransformerEncoderLayer`s at BERT-base
                  width, dropout 0, bf16, b 8 s 128, forward and backward:
                  B1-B3 12 launches each, every call held against the plain
                  versions (`flash_path_check`), the loss within 1e-2 of the
                  route's predicate false; the step's ms.
      analysis    the program audits (`paddle_tpu_torch.analysis`) at
                  Llama-2-7B width (2 layers, seed 0): (a) the train step
                  (b1 s2048, bf16 params, f32 master weights, loss_chunk
                  128, no remat) traced with make_fx over fake CUDA tensors
                  and audited clean, with flash_fwd/flash_bwd 2 and
                  rms_norm/rms_norm_bwd 5 nodes; its f32-moment program run
                  on the card from eager train_batch's starting state:
                  B1-B3, B9, B10 at those counts, loss and params within
                  1e-5, no state storage moved; (b) the paged decode step
                  (8 ragged rows to pos 2047, page size 16) over a bf16 and
                  an int8 pool, captured from a PagedEngine and audited,
                  its program bit-equal to eager with B6/B7 2 a step; (c)
                  GPT-2 small from layers, the GptEngine's prefill and
                  decode programs launching B5 and B4 as eager does; (d)
                  `python -m paddle_tpu_torch.analysis`'s toy families on
                  the card (TOY_CARD), clean against their ceilings.
      device      `paddle.device`: F.rms_norm at 7B width (B9, B10) under
                  stream_guard on a side stream gives the default stream's
                  bits, between Event record/synchronize/query; the memory
                  statistics equal torch.cuda's.
      debug       `amp.debugging` on the card: enable_tensor_checker aborts
                  with FloatingPointError naming the op on an injected inf
                  (log, matmul), at FLAGS_check_nan_inf_level 1 only logs;
                  the eager phase's bf16 Llama step with the checker off and
                  on, beside the eager phase's step (the hooks cost a None
                  check an op when off).
  2b. train       `HybridParallelEngine` on the 7B-width training leg of
                  bench.py (4 layers, b4 s2048, 2 micro-batches, no remat,
                  loss_chunk 128, bf16 params, f32 moments): 2 warm-up and 8
                  timed steps, B1-B3 launched L·M = 8 times each a step and
                  B9/B10 (2L+1)·M = 18; then 2 steps under torch.profiler
                  (where the time goes, the norms' share among it).
                  The engine's default training monitor reports every
                  step: its MFU (dispatch time) beside the synchronised
                  MFU, its HBM gauge equal to torch.cuda.max_memory_allocated.
  2c. train-h2048 the same for bench.py's primary leg (h2048, 16 layers, b8
                  s1024, 2 micro-batches).
  2d. ckpt        checkpoints at Llama-2-7B width (2 layers, f32 params and
                  moments, B1-B3, B9, B10; b2 s1024): 5 steps saving every 2
                  (keep 2); a child process killed (PADDLE_CHAOS, os._exit)
                  inside step 4's save leaves committed_steps() == [2];
                  resume=True gives steps 2-4 the uninterrupted losses bit
                  for bit. Snapshot ms, write MB/s and GB on disk printed.
  3. engine       `PagedEngine` at Llama-2-7B width (32 layers, bf16, random
                  weights from a seed) serves 12 requests with a shared system
                  prefix (radix hits, one mid-page COW split), a short suffix
                  (B5 in paged prefill) and two sampled requests; the kernel
                  launch counters must grow. Then a profiled decode window
                  (B9 once a norm: 65 launches a decode step; B6 once a
                  layer, B7 in the int8 one; no more launches a step than
                  before B6/B7 ran over clusters).
  3a. disagg      disaggregated prefill/decode on the 7B model: (a) bf16, the
                  engine phase's 12 requests through `DisaggServer` over
                  `LocalTransport`: each shipped page bit-identical in the
                  decode worker's pool, first tokens equal to the engine
                  phase's, both workers drained; (b) f32, 2 layers at 7B
                  width, greedy, int8 pool and chunked (256): tokens equal
                  to the monolithic `PagedEngine`'s; (c) bench.py's disagg
                  leg at its TPU settings (8 slots, pages of 64, chunks of
                  256; a steady 128-token stream through a 4 x 1536-token
                  burst): the stream's tokens per scheduler step within
                  0.9-1.1 of its base; hand-off MB and latency, decode step
                  ms and the monolithic counterfactual recorded.
  3b. router      one `Router` over the 7B `PagedEngine` (bf16, 2 slots: a
                  batch slot is preempted), GPT-2 small (`GptEngine`) and
                  BERT-base (`BertBackend`) on bench.py's router trace at 16x
                  its prompt lengths: every request finishes, preemptions =
                  resumes >= 1; GPT-2 alone launches B4 and B5 and nothing
                  else; GPT-2 f32 `GptEngine` equal to `gpt_generate`, its
                  bf16 logits against a plain f32 forward (the logits bars);
                  BERT-base bf16 pooled within rel 0.05 of f32; a preempted
                  and resumed f32 request (7B width, 2 layers) equal to its
                  uninterrupted run. Tokens/s, TTFT p50 per model and SLO
                  class and BERT's embed step recorded.
  4. logits       one request's prompt + generated tokens through prefill and
                  `paged_decode_step` against a plain f32 full-sequence forward
                  of the same bf16 weights; then the same with the weights in
                  f32, to a bar that leaves room only for summation order.
      logits-cuts (not run by default; needs engine) the bf16 check
                  recorded, not held, with the decode rows' keys cut over
                  1-4 splits: how far it moves with one kernel's rounding.
  5. generate     `generate` at b=4 (48- and 128-token prompts), the stripe
                  path that runs B4 and B5.
  5a. chunked     chunked prefill against monolithic prefill on the mixed
                  trace at bench.py's TPU settings (a 2 x 1536-token burst in
                  32 short prompts): short-request TTFT, chunk counts.
  5b. spec        speculative decoding at bench.py's settings (h2048, 16
                  layers, a 4-layer draft): f32 output equal to plain greedy,
                  bf16 tokens/s of both; then at Llama-2-7B width with its
                  4-layer draft, the block tables after all-rejected rounds
                  held to a plain engine's.
  6. engine-int8  `quantize_params` of the bf16 model, on the card, serving the
                  same traffic through `PagedEngine(kv_dtype="int8")`: B5, B7
                  and B8 must launch (B8's TMA route > 0 times, its off-gate
                  route 0 times), the prefix-cache counters equal the bf16
                  run's, the pool holds <= 0.51x its bytes. Then a profiled
                  decode window and `generate` over the int8 weights (B4, B8).
  7. logits-int8  as 4 for the int8 weights, against the f32 forward of their
                  dequantized values (q * scale / 127): (a) with the bf16 pool;
                  (b) with the int8 pool, against that forward with the pool's
                  rounding written out independently of the port, in bf16 and
                  (to the f32 bars) in f32.
  8. capacity     the reference's equal-KV-bytes leg (bench.py
                  `_bench_int8_kv_pool`, TPU settings) at 7B width: a 48-page
                  bf16 pool against the int8 pool of the same bytes on one
                  48-request trace; sustained slots must reach >= 1.8x.
  8'. serve-fp16  the bf16 model freed, Llama-2-7B width in fp16 (32 layers,
                  seed 0): the engine traffic through `PagedEngine` over an
                  fp16 pool (B5, B6, B9 in fp16) and its profiled decode
                  window, then over an int8 pool (B7 with an fp16 query);
                  `generate` (B4); `phase_spec`'s 7B leg (B5 through the
                  verify window); one request's fp16 pages handed off
                  through `KVHandoff` bytes, its tokens equal to the
                  monolithic engine's; the paged logits against the f32
                  forward of the same weights (LOGIT_BARS["float16"]) and,
                  over the int8 pool, against that forward over the pool's
                  rounding. Every launch of those kernels in each leg is an
                  fp16 one; tokens/s, decode step ms and busy share logged.
  9. timing       CUDA-event medians of each kernel, its plain version and one
                  PyTorch library call (`timing.METHOD`: the L2 flushed
                  before each call by reading 256 MB, the card held busy
                  while the host enqueues it; B4, B6, B7 and B10 also under
                  all four methods of `timing.METHODS`, and B4's shared
                  body beside its cluster kernel; the card's clocks logged
                  before and after) at the serving shapes
                  (B1-B3, B9, B10:
                  the 7B training leg's micro-batch; B2/B3 also at the h2048
                  leg's, B9/B10 also at the h2048 leg's micro-batch and
                  the decode rows; B4 also at the speculative draft's
                  1029-key stripe; B5 also at the
                  spec-verify window; B6 and B7 also at the engine's decode
                  shape, 8 rows of 257-320 keys; B8's GEMV at the four
                  decode shapes at M 1, 8 and 16; B1 in fp16 and at head_dim
                  32 at config 5's UNet shapes, their own rows; B4-B7, B9
                  and B10 in fp16 at their bf16 rows' shapes, their own
                  rows), beside the bound the card's memory rate or peak
                  sets.

The line before the card line is {"kernels": [...]}; then the card's name and
power limit from nvidia-smi; the last line is the device JSON. Without a CUDA
device, or without the package beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ATTN_SRC = "paddle_tpu_torch/kernels/csrc/attention.cu"
QMM_SRC = "paddle_tpu_torch/kernels/csrc/quantized_matmul.cu"
FLASH_SRC = "paddle_tpu_torch/kernels/csrc/flash_attention.cu"
RMS_SRC = "paddle_tpu_torch/kernels/csrc/rms_norm.cu"
REF = "paddle_tpu/kernels/quantized_matmul.py"
FLASH_REF = "paddle_tpu/kernels/flash_attention.py"
RMS_REF = "paddle_tpu/kernels/rms_norm.py"
KERNELS = {   # launch-count key -> (JSON name, source, the Pallas kernel)
    "flash_fwd": ("B1 flash_fwd", FLASH_SRC, f"{FLASH_REF}:112"),
    "flash_fwd_f16": ("B1 flash_fwd (fp16)", FLASH_SRC, f"{FLASH_REF}:112"),
    "flash_fwd_hd32": ("B1 flash_fwd (head_dim 32)", FLASH_SRC,
                       f"{FLASH_REF}:112"),
    "flash_bwd_dq": ("B2 flash_bwd_dq", FLASH_SRC, f"{FLASH_REF}:215"),
    "flash_bwd_dkv": ("B3 flash_bwd_dkv", FLASH_SRC, f"{FLASH_REF}:260"),
    "decode_attention": ("B4 decode_attention", ATTN_SRC, f"{REF}:253"),
    "decode_attention_f16": ("B4 decode_attention (fp16)", ATTN_SRC,
                             f"{REF}:253"),
    "window_attention": ("B5 window_attention", ATTN_SRC, f"{REF}:363"),
    "window_attention_f16": ("B5 window_attention (fp16)", ATTN_SRC,
                             f"{REF}:363"),
    "paged_decode_attention": ("B6 paged_decode_attention", ATTN_SRC,
                               f"{REF}:529"),
    "paged_decode_attention_f16": ("B6 paged_decode_attention (fp16)",
                                   ATTN_SRC, f"{REF}:529"),
    "paged_decode_attention_int8": ("B7 paged_decode_attention (int8 pool)",
                                    ATTN_SRC, f"{REF}:595"),
    "paged_decode_attention_int8_f16": (
        "B7 paged_decode_attention (int8 pool, fp16 query)", ATTN_SRC,
        f"{REF}:595"),
    "weight_only_matmul": ("B8 weight_only_matmul", QMM_SRC, f"{REF}:101"),
    "weight_only_matmul_prefill": ("B8 weight_only_matmul (prefill M=2048)",
                                   QMM_SRC, f"{REF}:101"),
    "rms_norm_fwd": ("B9 rms_norm_fwd", RMS_SRC, f"{RMS_REF}:34"),
    "rms_norm_fwd_f16": ("B9 rms_norm_fwd (fp16)", RMS_SRC, f"{RMS_REF}:34"),
    "rms_norm_bwd": ("B10 rms_norm_bwd", RMS_SRC, f"{RMS_REF}:42"),
    "rms_norm_bwd_f16": ("B10 rms_norm_bwd (fp16)", RMS_SRC,
                         f"{RMS_REF}:42"),
}
# kernel vs plain version: max |difference| <= TOL * max(1, max |plain|)
# (B1-B3: per vector, `flash_row_ratio`). bf16: two units in the last place at the largest output (2 * 2^-7); the
# attention plain versions round scores, probabilities and (B7) the
# dequantized K/V to bf16 where the kernels keep f32; B8's plain version
# rounds every dequantized weight and its output to bf16 where the kernel
# sums exact codes in f32 and rounds once. They may differ by a rounding or
# two. f32: both compute in f32 and sum in different orders.
TOL = {"bfloat16": 2.0**-6, "float16": 2.0**-6, "float32": 1e-5}
# the dtypes B4-B7 are held in: bf16 and fp16 (the cluster kernels), f32
# (the shared body)
ATTN_DTYPES = ("bfloat16", "float16", "float32")
# launch counters that must read 0 after the main path: B8's wmma tiles
# serve only shapes off the TMA gate, which no main-path shape is
OFF_PATH = ("weight_only_matmul_offgate",)


def log(msg):
    print(msg, flush=True)


def f16_key(key, dtype):
    """`key` of KERNELS, or its fp16 row's (`key_f16`) for an fp16 call."""
    return f"{key}_f16" if str(dtype).endswith("float16") and \
        not str(dtype).endswith("bfloat16") else key


def launch_counts():
    """Every wrapper's launch count, by key of KERNELS."""
    from paddle_tpu_torch.kernels import attention as at
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import quantized_matmul as qm
    from paddle_tpu_torch.kernels import rms_norm as rn

    return {**fa.launches, **at.launches, **qm.launches, **rn.launches}


def variant_counts():
    """B1's launches in fp16 and at head_dim 32 (`flash_fwd_f16`,
    `flash_fwd_hd32`), and B4-B7's, B9's and B10's in fp16 (`*_f16`),
    counted where each kernel launches beside its total; the rows of
    KERNELS under those keys read them."""
    from paddle_tpu_torch.kernels import attention as at
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import rms_norm as rn

    return {**fa.variant_launches, **at.variant_launches,
            **rn.variant_launches}


def all_counts():
    """`launch_counts` and `variant_counts` together."""
    return {**launch_counts(), **variant_counts()}


def reset_launches():
    from paddle_tpu_torch.kernels import attention as at
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import quantized_matmul as qm
    from paddle_tpu_torch.kernels import rms_norm as rn

    at.reset_launches()
    fa.reset_launches()
    qm.reset_launches()
    rn.reset_launches()


def peaks(name):
    """(bytes/s, bf16 flop/s) of the card: the port's one peak table
    (`observability/hardware.py`), which the training monitor reads too."""
    from paddle_tpu_torch.observability import hardware

    rates = hardware.peaks_for(name)
    if rates is None:
        raise RuntimeError(f"no peak rates recorded for {name!r}")
    return rates


# ---------------------------------------------------------------------------
# inputs at the serving shapes
# ---------------------------------------------------------------------------


def paged_case(torch, dev, dtype, b=8, nh=32, nkv=32, hd=128, ps=16, P=128,
               pos=(2047, 1500, 777, 513, 64, 17, 1, 0), seed=0):
    """A pool holding b rows of P pages each under shuffled page ids (page 0
    is the null page), ragged positions."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = 1 + b * P
    shape = (n_pages, nkv, ps, hd)
    pool_k = torch.randn(shape, device=dev, generator=g).to(dtype)
    pool_v = torch.randn(shape, device=dev, generator=g).to(dtype)
    perm = torch.randperm(n_pages - 1, device=dev, generator=g) + 1
    bt = perm.reshape(b, P).to(torch.int32).contiguous()
    q = torch.randn(b, 1, nh, hd, device=dev, generator=g).to(dtype)
    pos_t = torch.tensor(pos[:b], dtype=torch.int32, device=dev)
    return q, pool_k, pool_v, bt, pos_t


def paged_q8_case(torch, dev, dtype, ps=16, nkv=32, P=None, **kw):
    """paged_case's rows over an int8 pool of the same keys (P pages a
    row, 2048 keys by default): codes in [-127, 127], scales in [0.5,
    2.5]; one page of row 1 has scale 0 (a fresh page). Returns q,
    codes_k, codes_v, k_scale, v_scale, bt, pos."""
    q, _, _, bt, pos = paged_case(torch, dev, dtype, ps=ps, nkv=nkv,
                                  P=P or 2048 // ps, **kw)
    g = torch.Generator(device=dev).manual_seed(3)
    n_pages = 1 + bt.numel()
    shape = (n_pages, nkv, ps, q.shape[-1])

    def half():
        codes = torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int8)
        sc = torch.rand(n_pages, nkv, generator=g, device=dev) * 2 + 0.5
        sc[bt[1, 0]] = 0.0
        return codes, sc

    (kq, ks), (vq, vs) = half(), half()
    return q, kq, vq, ks, vs, bt, pos


def matmul_case(torch, dev, dtype, m, k, n, seed=4):
    """x [m, k] ~ N(0, 1) and the int8 codes and scales of a N(0, 0.02)
    weight [k, n], quantized on the card."""
    from paddle_tpu_torch.kernels import quantized_matmul as qm

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w, s = qm.quantize_absmax(torch.randn(k, n, generator=g, device=dev)
                              * 0.02)
    return x, w, s


# B8's shapes on one decode step of Llama-2-7B: (K, N, calls a step)
DECODE_MATMULS = ((4096, 4096, 4 * 32), (4096, 11008, 2 * 32),
                  (11008, 4096, 32), (4096, 32000, 1))


def window_case(torch, dev, dtype, s, b=2, nh=32, nkv=32, hd=128,
                length=2048 + 64, pos=None, seed=1):
    """A scratch stripe like paged prefill's (pages + bucket padding); row 0's
    window overhangs the cache end."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ck = torch.randn(b, nkv, length, hd, device=dev, generator=g).to(dtype)
    cv = torch.randn(b, nkv, length, hd, device=dev, generator=g).to(dtype)
    q = torch.randn(b, s, nh, hd, device=dev, generator=g).to(dtype)
    pos = pos if pos is not None else [length - s // 2, 512][:b]
    return q, ck, cv, torch.tensor(pos, dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from paddle_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    for name in built:
        _build.lib(name)
    srcs = sorted(str(p.relative_to(ROOT)) for p, _ in built.values())
    log(f"[build] {srcs} in {time.perf_counter() - t0:.1f} s (one nvcc a "
        f"source, in parallel)")
    for _, report in built.values():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build] {line.strip()}")
    spill_check(built)
    sass_check(built)


# the tensor-core instruction each redesigned kernel must run, by library:
# {library: {name fragment: SASS opcode}} (HGMMA: wgmma; HMMA: mma.sync).
# decode_mma_kernel's instantiations go by their key source: CacheKeys (B4:
# TMA copies of the contiguous cache), PagedKeys (B6/B7: cp.async copies
# through the block table)
TENSOR_CORE_KERNELS = {
    "quantized_matmul": {"b8_tma_kernel": "HGMMA",
                         "b8_gemv_mma_kernel": "HMMA"},
    "flash_attention": {"flash_fwd_tma_kernel": "HGMMA",
                        "flash_bwd_dq_tma_kernel": "HGMMA",
                        "flash_bwd_dkv_tma_kernel": "HGMMA"},
    "attention": {"window_mma_kernel": "HMMA",
                  "CacheKeys": "HMMA", "PagedKeys": "HMMA"}}
# the kernels whose every instantiation must compile without spills, by
# library
SPILL_FREE = {"flash_attention": ("flash_fwd_tma_kernel",
                                  "flash_fwd_f32_kernel",
                                  "flash_bwd_dq_tma_kernel",
                                  "flash_bwd_dkv_tma_kernel"),
              "attention": ("window_mma_kernel", "decode_mma_kernel"),
              "quantized_matmul": ("b8_gemv_mma_kernel",),
              "rms_norm": ("rms_norm_bwd_kernel",)}


def spill_check(built):
    """Spill bytes of each SPILL_FREE kernel's instantiations, read from
    ptxas' report (-Xptxas=-v) of its library; raises when one spills or
    fewer than two are reported. An empty report (the library was built
    before) is said so and skipped."""
    import re

    for lib, frags in SPILL_FREE.items():
        report = built[lib][1]
        if not report:
            log(f"[build] {lib}: spills not checked: the library was "
                "already built")
            continue
        spills, fn = {}, None
        for line in report.splitlines():
            m = re.search(r"(?:Compiling entry function '|Function "
                          r"properties for )([^' ]+)", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and fn:
                spills[fn] = int(m.group(1)) + int(m.group(2))
        for frag in frags:
            mine = {f: n for f, n in spills.items() if frag in f}
            log(f"[build] {frag}: spill bytes by instantiation "
                f"{sorted(mine.values())}")
            if len(mine) < 2 or any(mine.values()):
                raise AssertionError(f"{frag}: spills or no ptxas report "
                                     f"for its instantiations: {mine}")


def sass_check(built):
    """Tensor-core instructions (TENSOR_CORE_KERNELS) in each redesigned
    kernel's SASS, read with cuobjdump from the libraries just built;
    raises when an instantiation has none. Skipped, and said so, where the
    toolkit has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log("[build] HGMMA/HMMA counts not checked: no cuobjdump")
        return
    for lib, frags in TENSOR_CORE_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(built[lib][0])],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
            elif fn:
                for op in counts[fn]:
                    if f" {op}." in line or f" {op} " in line:
                        counts[fn][op] += 1
        for frag, op in frags.items():
            mine = {f: c[op] for f, c in counts.items() if frag in f}
            log(f"[build] {frag}: {op} instructions by instantiation "
                f"{sorted(mine.values())}")
            if not mine or not all(mine.values()):
                raise AssertionError(f"{frag}: an instantiation without "
                                     f"{op} in its SASS: {mine}")


def phase_parity(torch, dev):
    """Kernel vs plain version; returns {wrapper: max_abs_err of its main
    serving case}."""
    from paddle_tpu_torch.kernels import attention as at
    from paddle_tpu_torch.kernels import quantized_matmul as qm

    main_err = {}

    def check(label, name, fn, plain, args, main=False, rows=False):
        out = fn(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        dname = str(args[0].dtype).replace("torch.", "")
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[dname] * max(1.0, ref.float().abs().max().item())
        extra = ""
        if rows:
            # each output vector against the plain version run in f32 on
            # the same inputs (`row_ratio`), and a second call bit for bit
            ratio = row_ratio(torch, out, plain, args, dname)
            again = torch.equal(fn(*args), out)
            extra = (f", worst row at {ratio:.3f} of its bar, a second call "
                     f"{'bit-identical' if again else 'DIFFERENT'}")
            if not (ratio <= 1.0 and again):
                raise AssertionError(f"{label}: a row disagrees with the "
                                     f"plain version ({ratio}) or the "
                                     f"output is not reproducible")
        log(f"[parity] {label}: max_abs_err {err:.3e} (bar {tol:.3e}){extra}")
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"{label}: kernel disagrees with its plain "
                                 f"version ({err} > {tol})")
        if main:
            main_err[name] = err

    for dname in ATTN_DTYPES:
        dtype = getattr(torch, dname)
        # the cluster kernels (bf16, fp16): the JSON rows (fp16's under the
        # `_f16` keys) and the per-row bar
        main = dtype != torch.float32
        for nkv in (32, 8):
            q, pk, pv, bt, pos = paged_case(torch, dev, dtype, nkv=nkv)
            check(f"B6 {dname} b=8 nh=32 nkv={nkv} ps=16 P=128",
                  f16_key("paged_decode_attention", dtype),
                  at.paged_decode_attention, at.paged_decode_attention_plain,
                  (q, pk, pv, bt, pos), main and nkv == 32, rows=main)
            ck = at.paged_gather(pk, bt)
            cv = at.paged_gather(pv, bt)
            check(f"B4 {dname} b=8 nh=32 nkv={nkv} len=2048",
                  f16_key("decode_attention", dtype),
                  at.decode_attention, at.decode_attention_plain,
                  (q, ck, cv, pos), main and nkv == 32, rows=main)
        for s, nkv in ((16, 32), (64, 32), (16, 8)):
            q, ck, cv, pos = window_case(torch, dev, dtype, s, nkv=nkv)
            check(f"B5 {dname} s={s} nkv={nkv} len={ck.shape[2]} "
                  f"pos={pos.tolist()} (row 0 overhangs)",
                  f16_key("window_attention", dtype),
                  at.window_attention, at.window_attention_plain,
                  (q, ck, cv, pos), main and s == 16 and nkv == 32, rows=True)
        for label, *shape in B5_CASES:
            q, ck, cv, pos = b5_case(torch, dev, dtype, *shape)
            splits = at.window_splits(at._window_last(pos, shape[1],
                                                      shape[5]))
            check(f"B5 {dname} {label}: b={shape[0]} s={shape[1]} "
                  f"nh={shape[2]} nkv={shape[3]} hd={shape[4]} "
                  f"len={shape[5]} pos={shape[6]}, "
                  f"{splits if main else 1} split(s)",
                  "window_attention", at.window_attention,
                  at.window_attention_plain, (q, ck, cv, pos), rows=True)
            del q, ck, cv
    # head_dim 64, the kernels' other instantiation
    for dtype in (torch.bfloat16, torch.float16):
        q, pk, pv, bt, pos = paged_case(torch, dev, dtype, nh=8, nkv=4,
                                        hd=64, P=16,
                                        pos=(255, 100, 3, 0, 9, 77, 31, 16))
        check(f"B6 {str(dtype).replace('torch.', '')} hd=64 nkv=4",
              "paged_decode_attention", at.paged_decode_attention,
              at.paged_decode_attention_plain, (q, pk, pv, bt, pos))

    def q8(q, kq, vq, ks, vs, bt, pos):
        return at.paged_decode_attention(q, kq, vq, bt, pos, k_scale=ks,
                                         v_scale=vs)

    def q8_plain(q, kq, vq, ks, vs, bt, pos):
        return at.paged_decode_attention_plain(q, kq, vq, bt, pos,
                                               k_scale=ks, v_scale=vs)

    for dname in ATTN_DTYPES:
        dtype = getattr(torch, dname)
        main = dtype != torch.float32
        # B7 at the engine's pages (16), the capacity leg's (64), and GQA
        for nkv, ps in ((32, 16), (32, 64), (8, 16)):
            check(f"B7 {dname} b=8 nh=32 nkv={nkv} ps={ps} P={2048 // ps} "
                  f"(a page at scale 0)",
                  f16_key("paged_decode_attention_int8", dtype), q8,
                  q8_plain, paged_q8_case(torch, dev, dtype, ps=ps, nkv=nkv),
                  main and nkv == 32 and ps == 16, rows=main)
        # B6 and B7 at the edges of paged_mma_kernel's design: in bf16 and
        # fp16 each output vector also against the plain version run in
        # f32 and a second call bit-identical; f32 runs the shared body
        for label, *shape in PAGED_CASES:
            b, nh, nkv, hd, ps, P, pos = shape
            splits = at.paged_splits(P, ps) if main else 0
            for quant in (False, True):
                args, kw = paged_cases(torch, dev, dtype, *shape, q8=quant)
                check(f"{'B7' if quant else 'B6'} {dname} {label}: b={b} "
                      f"nh={nh} nkv={nkv} hd={hd} ps={ps} P={P} pos={pos}, "
                      + (f"{splits} split(s)" if main
                         else "the shared body"),
                      "paged_decode_attention" + ("_int8" if quant else ""),
                      lambda *a, kw=kw: at.paged_decode_attention(*a, **kw),
                      lambda *a, kw=kw: at.paged_decode_attention_plain(
                          *a, **kw), args, rows=main)
                del args, kw
        if dtype == torch.float16:
            continue   # B8 takes bf16 or f32 x (ROADMAP §B: B8 in fp16)
        # B8: the decode step's four shapes at M = 8, two prefill M, ragged
        for m, k, n in [(8, k, n) for k, n, _ in DECODE_MATMULS] + [
                (512, 4096, 4096), (2048, 4096, 11008), (13, 1000, 999),
                (77, 1000, 999)]:
            check(f"B8 {dname} M={m} K={k} N={n}", "weight_only_matmul",
                  qm.weight_only_matmul, qm.dequant_matmul_plain,
                  matmul_case(torch, dev, dtype, m, k, n),
                  main and (m, k, n) == (8, 4096, 11008),
                  rows=m <= qm.GEMV_MAX_ROWS)
        # B8's GEMV at its edges: every M of a decode batch with the four
        # decode (K, N), K = 1000 (a K tail) and N = 999 off the vector
        # gate, and a weight 1 byte off 16-byte alignment
        for m in B8_GEMV_M:
            for k, n, w_off in [(k, n, 0) for k, n in B8_PAIRS] + [
                    (1000, 4096, 0), (4096, 999, 0), (4096, 4096, 1)]:
                x, w, sc = matmul_case(torch, dev, dtype, m, k, n)
                if w_off:
                    w = b8_offset_w(torch, w)
                split = (qm.gemv_split(k, n, qm._sms(dev))
                         if dtype == torch.bfloat16 else qm._k_split(
                             k, n, dev))
                check(f"B8 GEMV {dname} M={m} K={k} N={n}"
                      + (", w 1 byte off 16-byte alignment" if w_off else "")
                      + f", (K rows a block, blocks) {split}",
                      "weight_only_matmul", qm.weight_only_matmul,
                      qm.dequant_matmul_plain, (x, w, sc), rows=True)
                del x, w, sc
    phase_b4_parity(torch, dev)
    for dtype in (torch.bfloat16, torch.float16):
        phase_b5_bar_teeth(torch, dev, dtype)
        phase_paged_bar_teeth(torch, dev, dtype)
        phase_b4_bar_teeth(torch, dev, dtype)
    main_err.update(phase_b8_routes(torch, dev, check))
    phase_b8_bar_teeth(torch, dev)
    phase_b8_bar_teeth(torch, dev, shape=(8, 1000, 4096))
    main_err.update(phase_flash_parity(torch, dev))
    main_err.update(phase_flash_fwd_parity(torch, dev))
    for case in (FLASH_CASES[1], FLASH_FWD_CASES[0], FLASH_FWD_CASES[1]):
        phase_flash_bar_teeth(torch, dev, case)
    main_err.update(phase_rms_parity(torch, dev))
    return main_err


# B8's prefill regime at the edges of its tiles (128 rows, 128 or 256
# columns, 64 K a stage): every M with the main path's four (K, N) pairs,
# then a ragged shape on the TMA gate and two off it, each with the route
# it must take
B8_EDGE_M = (17, 100, 129, 512, 1500, 2047)
B8_PAIRS = tuple((k, n) for k, n, _ in DECODE_MATMULS)


# rows of x the GEMV's parity cases take (M <= 16)
B8_GEMV_M = (1, 4, 8, 9, 16)


def row_ratio(torch, out, plain, args, dname):
    """`flash_row_ratio` of a kernel's output against its plain version run
    in f32 on the same inputs (floating inputs upcast). In bf16 the plain
    version rounds its scores (B5, as the reference's XLA oracle does) or
    its dequantized weights (B8) to bf16 where the kernels keep f32, which
    alone moves a vector by up to about the bar; the f32 run is the exact
    function the kernel rounds once."""
    ref = plain(*[a.float() if torch.is_tensor(a) and a.is_floating_point()
                  else a for a in args])
    return flash_row_ratio(torch, out, ref, TOL[dname])


def b8_offset_w(torch, w):
    """w's codes in a view whose data starts 1 byte past a 16-byte
    boundary: contiguous, but no 16-byte load can read it."""
    buf = torch.empty(w.numel() + 16, dtype=w.dtype, device=w.device)
    view = buf[1:1 + w.numel()].view(w.shape)
    view.copy_(w)
    return view


def b8_offset_x(torch, x):
    """x's values in a view whose data starts 2 bytes past a 16-byte
    boundary: contiguous, but no TMA copy can read it."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    view = buf[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def phase_b8_routes(torch, dev, check):
    """B8 bf16 on each route at its edges, within TOL of the plain version,
    each call's route read off the launch counters. Returns the error of
    the prefill row's shape (M=2048, K=4096, N=11008)."""
    from paddle_tpu_torch.kernels import quantized_matmul as qm

    cases = [(m, k, n, "tma") for m in B8_EDGE_M for k, n in B8_PAIRS]
    cases += [(2048, 4096, 11008, "tma"), (333, 1000, 1008, "tma"),
              (300, 1001, 4096, "mma"), (512, 4096, 4096, "mma offset")]
    errs = {}
    for m, k, n, want in cases:
        x, w, s = matmul_case(torch, dev, torch.bfloat16, m, k, n)
        if want == "mma offset":
            x = b8_offset_x(torch, x)
        way = qm.route(m, k, n, x.dtype, x.data_ptr(), w.data_ptr())
        label = (f"B8 bfloat16 M={m} K={k} N={n}, route {way}"
                 + (f", tile {qm.tile(m, n, qm._sms(dev))}"
                    if way == "tma" else "")
                 + (", x 2 bytes off 16-byte alignment"
                    if want == "mma offset" else ""))
        before = dict(qm.launches)
        check(label, "weight_only_matmul", qm.weight_only_matmul,
              qm.dequant_matmul_plain, (x, w, s))
        took = {key: qm.launches[key] - before[key] for key in before}
        expect = {"weight_only_matmul": 1,
                  "weight_only_matmul_prefill": int(want == "tma"),
                  "weight_only_matmul_offgate": int(want != "tma")}
        if way != want.split()[0] or took != expect:
            raise AssertionError(f"{label}: launches {took}, want the "
                                 f"{want} route")
        if (m, k, n) == (2048, 4096, 11008):
            errs["weight_only_matmul_prefill"] = (
                qm.weight_only_matmul(x, w, s).float()
                - qm.dequant_matmul_plain(x, w, s).float()
            ).abs().max().item()
        del x, w, s
    torch.cuda.empty_cache()
    return errs


def planted_b8_faults(torch, qm, x, w, s, k_tile=64, n_tile=128):
    """B8 outputs with a fault planted, built from the plain version:
    [(fault, faulty, right)]. The bar must reject each."""
    right = qm.dequant_matmul_plain(x, w, s)
    w_gap = w.clone()
    w_gap[k_tile:2 * k_tile] = 0
    s_shift = s.clone()
    s_shift[n_tile:2 * n_tile] = s[:n_tile]
    tail = w.shape[0] % 16 or 16
    w_tail = w.clone()
    w_tail[-tail:] = 0
    return [(f"one {k_tile}-row K tile of the weight left out",
             qm.dequant_matmul_plain(x, w_gap, s), right),
            (f"the scales of one {n_tile}-column tile taken from its "
             "neighbour", qm.dequant_matmul_plain(x, w, s_shift), right),
            ("the /127 missing", right * 127.0, right),
            (f"the K tail (the last {tail} rows) left out",
             qm.dequant_matmul_plain(x, w_tail, s), right),
            ("every scale taken from the next channel",
             qm.dequant_matmul_plain(x, w, s.roll(-1)), right)]


def phase_b8_bar_teeth(torch, dev, shape=(2048, 4096, 11008)):
    """B8's bar rejects planted faults, each printed beside its ratio to
    the bar: at the prefill row's shape the whole-tensor bar (TOL * max(1,
    max |plain|)), at a GEMV shape (M <= 16) the per-row bar."""
    from paddle_tpu_torch.kernels import quantized_matmul as qm

    x, w, s = matmul_case(torch, dev, torch.bfloat16, *shape)
    gemv = shape[0] <= qm.GEMV_MAX_ROWS
    for fault, wrong, right in planted_b8_faults(torch, qm, x, w, s):
        if gemv:
            ratio = flash_row_ratio(torch, wrong, right, TOL["bfloat16"])
        else:
            bar = TOL["bfloat16"] * max(1.0,
                                        right.float().abs().max().item())
            ratio = (wrong.float() - right.float()).abs().max().item() / bar
        log(f"[parity] B8 {'per-row ' if gemv else ''}bar, planted fault at "
            f"M={shape[0]} K={shape[1]} N={shape[2]}: {fault} is at "
            f"{ratio:.2f} of the bar")
        if not ratio > 1.0:
            raise AssertionError(f"the B8 bar passes a planted fault: "
                                 f"{fault} at {ratio}")
    del x, w, s
    torch.cuda.empty_cache()


# B5 parity cases at the edges of the bf16 kernel's design: (label, b, s,
# nh, nkv, hd, cache length, pos). Row tiles of 16 (s * g = 2, 5, 16, 17,
# 48, 64 query rows a kv head), both head dims, GQA 8/2 at the spec
# window's s = 5, b = 1 and b = 8, pos 0, a watermark one key past a tile
# (and split) edge, a row whose limit ends before a split begins, and a
# window that overhangs the cache end
B5_CASES = (
    ("s*g=2", 1, 2, 32, 32, 128, 600, [300]),
    ("s*g=5 spec verify b=8 ragged", 8, 5, 32, 32, 128, 1100,
     [1000, 3, 64, 59, 0, 500, 127, 777]),
    ("s*g=20 GQA 8/2 s=5 pos 0", 1, 5, 8, 2, 128, 300, [0]),
    ("s*g=16 paged-prefill suffix", 1, 16, 32, 32, 128, 2064, [512]),
    ("s*g=17 hd64, watermark one key past a split edge", 2, 17, 4, 4, 64,
     400, [112, 112]),
    ("s*g=48, rows whose limit ends before a split begins", 1, 48, 8, 8,
     128, 400, [100]),
    ("s*g=64 hd64, row 0 overhangs the cache end", 2, 64, 32, 32, 64, 700,
     [670, 1]),
    ("GPT-2's prefill bucket: s 64, 12 heads, hd 64", 1, 64, 12, 12, 64,
     1024, [0]),
)


def b5_case(torch, dev, dtype, b, s, nh, nkv, hd, length, pos, seed=7):
    g = torch.Generator(device=dev).manual_seed(seed)
    ck = torch.randn(b, nkv, length, hd, device=dev, generator=g).to(dtype)
    cv = torch.randn(b, nkv, length, hd, device=dev, generator=g).to(dtype)
    q = torch.randn(b, s, nh, hd, device=dev, generator=g).to(dtype)
    return q, ck, cv, torch.tensor(pos, dtype=torch.int32, device=dev)


def window_split_plain(torch, at, q, ck, cv, pos, splits, fault=None):
    """B5 computed the way the bf16 kernel splits it, in f32, with each
    row's keys cut over `splits` splits (`attention.cut_keys`, the kernel's
    cut; the bar's planted faults need the count set by hand), a softmax
    partial (m, l, O) a split, combined with the max rescale. `fault`
    plants one of the faults of `planted_b5_faults`."""
    b, s, nh, hd = q.shape
    nkv, length = ck.shape[1], ck.shape[2]
    g = nh // nkv
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty(b, s, nh, hd, dtype=torch.float32, device=q.device)
    for r in range(b):
        p0 = int(pos[r])
        last = min(p0 + s - 1, length - 1)
        k = ck[r].float().repeat_interleave(g, 0)        # [nh, len, hd]
        v = cv[r].float().repeat_interleave(g, 0)
        qs = q[r].float().transpose(0, 1)                # [nh, s, hd]
        limit = (p0 + torch.arange(s, device=q.device)).clamp(max=last)
        parts = []
        tile0 = last // at.WINDOW_TILE * at.WINDOW_TILE
        for z, keys in enumerate(at.cut_keys(last, splits)):
            if keys is None or (fault == "drop" and z == splits // 2):
                continue
            j = torch.arange(keys[0], keys[1] + 1, device=q.device)
            sc = (qs @ k[:, j].transpose(1, 2)) * scale   # [nh, s, keys]
            live = j[None, :] <= limit[:, None]            # [s, keys]
            if fault == "unmasked tail":
                live = live | ((j >= tile0) & (j <= last))[None, :]
            sc = torch.where(live, sc, at.NEG_INF)
            m = sc.amax(-1, keepdim=True)
            p = torch.where(live, torch.exp(sc - m), 0.0)
            dead = ~live.any(-1)                           # [s]
            if fault == "exp(0)" and dead.any():
                # the split's masked keys each at exp(0) = 1, entering the
                # combine at the row's max
                p = torch.where(dead[None, :, None], 1.0, p)
                m = torch.where(dead[None, :, None], float("inf"), m)
            parts.append((m, p.sum(-1, keepdim=True), p @ v[:, j]))
        ms = torch.stack([m for m, _, _ in parts])
        top = ms.where(ms.isfinite(), -ms).amax(0)        # the real max
        ms = torch.where(ms.isinf(), top, ms)
        w = (torch.ones_like(ms) if fault == "no rescale"
             else torch.exp(ms - top))
        den = sum(wi * li for wi, (_, li, _) in zip(w, parts))
        num = sum(wi * oi for wi, (_, _, oi) in zip(w, parts))
        out[r] = (num / den).transpose(0, 1)
    return out.to(q.dtype)


def planted_b5_faults(torch, at, q, ck, cv, pos, splits):
    """B5 outputs with a fault planted, from the split model of the bf16
    kernel (`window_split_plain`): [(fault, faulty, right)]. The per-row
    bar must reject each."""
    right = at.window_attention_plain(q, ck, cv, pos)
    return [(name, window_split_plain(torch, at, q, ck, cv, pos, splits,
                                      fault), right)
            for name, fault in B5_FAULTS.items()]


B5_FAULTS = {"one key split dropped": "drop",
             "the splits combined without the max rescale": "no rescale",
             "the masked keys of a split wholly past a row's limit counted "
             "as exp(0)": "exp(0)",
             "the last partial tile unmasked": "unmasked tail"}


def phase_b5_bar_teeth(torch, dev, dtype, case=5, splits=3):
    """The per-row B5 bar (bf16's, in bf16 and fp16) rejects planted faults
    at the parity case whose rows end before a split begins (3 splits of
    its 3 tiles), each beside the whole-tensor rule's ratio; the unplanted
    split model passes."""
    from paddle_tpu_torch.kernels import attention as at

    dname = str(dtype).replace("torch.", "")
    label, *shape = B5_CASES[case]
    label = f"{label} ({dname})"
    q, ck, cv, pos = b5_case(torch, dev, dtype, *shape)
    model = window_split_plain(torch, at, q, ck, cv, pos, splits)
    right = at.window_attention_plain(q, ck, cv, pos)
    ok = flash_row_ratio(torch, model, right, TOL[dname])
    log(f"[parity] B5 bar at {label}: the split model without a fault is at "
        f"{ok:.3f} of the bar")
    if not ok <= 1.0:
        raise AssertionError(f"B5's split model fails its bar: {ok}")
    for fault, wrong, right in planted_b5_faults(torch, at, q, ck, cv, pos,
                                                 splits):
        ratio = flash_row_ratio(torch, wrong, right, TOL[dname])
        whole = ((wrong.float() - right.float()).abs().max()
                 / (TOL[dname]
                    * right.float().abs().max().clamp_min(1.0))).item()
        log(f"[parity] B5 bar, planted fault at {label}: {fault} is at "
            f"{ratio:.2f} of the bar (the whole-tensor rule: {whole:.2f})")
        if not ratio > 1.0:
            raise AssertionError(f"the B5 bar passes a planted fault: "
                                 f"{fault} at {ratio}")


# B6/B7 parity cases at the edges of paged_mma_kernel's design: (label, b,
# nh, nkv, hd, ps, P, pos). Pages of 8 to 128 keys (a 64-key tile over 8
# pages, inside one page), g = 1 to 64 query rows a kv head (rows 0-7 of one
# row tile, all 16, 2 and 4 row tiles), both head dims, rows at 0, 1,
# mid-page and the full table, and a pos past the table's end (the row's
# keys clamp there)
PAGED_CASES = (
    ("ps 8, g=4, a row at 0 and one mid-page", 4, 32, 8, 128, 8, 128,
     (1023, 0, 4, 511)),
    ("ps 16, g=1, ragged to the full table", 4, 32, 32, 128, 16, 64,
     (1023, 1, 600, 17)),
    ("ps 64, g=8, hd 64", 4, 64, 8, 64, 64, 16, (1023, 1, 100, 0)),
    ("ps 128, g=1, the full table and a page edge", 3, 32, 32, 128, 128, 8,
     (1023, 127, 64)),
    ("ps 16, g=12 (one row tile, rows 8-15 kept)", 2, 24, 2, 128, 16, 16,
     (255, 3)),
    ("ps 16, g=32 (two row tiles)", 2, 64, 2, 128, 16, 16, (255, 9)),
    ("ps 16, g=64 (four row tiles), hd 64", 2, 64, 1, 64, 16, 8, (127, 37)),
    ("ps 16, a pos past the table's end", 2, 32, 32, 128, 16, 16,
     (300, 5)),
)


def paged_cases(torch, dev, dtype, b, nh, nkv, hd, ps, P, pos, q8):
    """The inputs of a PAGED_CASES row as `paged_decode_attention`'s
    arguments and keywords: a bf16/f32 pool, or (q8) an int8 pool with its
    scales."""
    if not q8:
        return paged_case(torch, dev, dtype, b=b, nh=nh, nkv=nkv, hd=hd,
                          ps=ps, P=P, pos=pos), {}
    q, kq, vq, ks, vs, bt, pos_t = paged_q8_case(
        torch, dev, dtype, ps=ps, nkv=nkv, P=P, b=b, nh=nh, hd=hd, pos=pos)
    return (q, kq, vq, bt, pos_t), {"k_scale": ks, "v_scale": vs}


def paged_split_plain(torch, at, q, pk, pv, bt, pos, splits, k_scale=None,
                      v_scale=None, fault=None):
    """B6/B7 computed the way paged_mma_kernel splits them, in f32: each
    row's keys [0, min(pos, P * ps - 1)] cut over `splits` splits
    (`attention.cut_keys`, the count set by hand) and read page by page
    through the block table; over an int8 pool the scales folded as the
    kernel folds them (each key's score times its page's sk / 127, its p
    times sv / 127, the codes exact); a softmax partial (m, l, O) a split,
    combined with the max rescale. `fault` plants one of PAGED_FAULTS."""
    b, _, nh, hd = q.shape
    nkv, ps = pk.shape[1], pk.shape[2]
    P = bt.shape[1]
    g = nh // nkv
    scale = 1.0 / math.sqrt(hd)
    q8 = k_scale is not None
    out = torch.empty(b, 1, nh, hd, dtype=torch.float32, device=q.device)
    for r in range(b):
        p0 = int(pos[r])
        last = min(p0, P * ps - 1)
        qs = q[r, 0].float()                                 # [nh, hd]
        parts = []
        cut = at.cut_keys(last, splits)
        held = [z for z, keys in enumerate(cut) if keys is not None]
        # "drop": the middle split of those holding the row's keys
        drop = (held[len(held) // 2] if fault == "drop" and len(held) > 1
                else None)
        for z, keys in enumerate(cut):
            if keys is None or z == drop:
                continue
            end = keys[1]
            if fault == "last key" and end == last:
                end = min(last + 1, P * ps - 1)     # one key past the row
            if fault == "tail" and end == last:
                # the row's last tile to its end, within the keys there are
                end = min((last // at.WINDOW_TILE + 1) * at.WINDOW_TILE,
                          P * ps) - 1
            j = torch.arange(keys[0], end + 1, device=q.device)
            page = bt[r].long()[j // ps]
            k = pk[page, :, j % ps].float().repeat_interleave(g, 1)
            v = pv[page, :, j % ps].float().repeat_interleave(g, 1)
            sc = torch.einsum("hd,nhd->hn", qs, k) * scale   # [nh, keys]
            if q8:
                kpage = (bt[r].long()[(j // ps + 1) % P]
                         if fault == "scale page" else page)
                sc = sc * (k_scale[kpage].repeat_interleave(g, 1).t()
                           / 127.0)
            if fault == "tail":
                sc = torch.where(j <= last, sc, -math.inf)
            m = sc.amax(-1, keepdim=True)
            p = torch.exp(sc - m)
            pw = (p * (v_scale[page].repeat_interleave(g, 1).t() / 127.0)
                  if q8 else p)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("hn,nhd->hd", pw, v)))
        ms = torch.stack([m for m, _, _ in parts])           # [S, nh, 1]
        w = torch.exp(ms - ms.amax(0))
        if fault == "weight":
            # the split with the lowest max at weight 1, not e^(m - M)
            w = torch.where(ms == ms.amin(0), 1.0, w)
        den = sum(wi * li for wi, (_, li, _) in zip(w, parts))
        num = sum(wi * oi for wi, (_, _, oi) in zip(w, parts))
        out[r, 0] = num / den
    return out.to(q.dtype)


# planted faults of the split model, for the B6/B7 bar (the scale fault
# over an int8 pool only)
PAGED_FAULTS = {"the middle of a row's key splits dropped": "drop",
                "a split's weight wrong (the lowest max at weight 1)":
                    "weight",
                "the last key of a row off by one (one key past its end)":
                    "last key",
                "a key's scale taken from the next page of the table":
                    "scale page"}


def planted_paged_faults(torch, at, args, kw, splits):
    """B6 (B7 with the scales in `kw`) outputs with a fault planted, from
    `paged_split_plain`: [(fault, faulty, right)]. The per-row bar must
    reject each."""
    right = at.paged_decode_attention_plain(*args, **kw)
    return [(name, paged_split_plain(torch, at, *args, splits, **kw,
                                     fault=fault), right)
            for name, fault in PAGED_FAULTS.items()
            if kw or fault != "scale page"]


def phase_paged_bar_teeth(torch, dev, dtype, case=0, splits=8):
    """The per-row B6/B7 bar (bf16's, in bf16 and fp16) rejects planted
    faults at a ragged case (rows at 0 and mid-page, 8 splits: the short
    rows leave some empty), each beside the whole-tensor rule's ratio; the
    unplanted split model passes against the plain version in f32."""
    from paddle_tpu_torch.kernels import attention as at

    dname = str(dtype).replace("torch.", "")
    label, *shape = PAGED_CASES[case]
    label = f"{label} ({dname})"
    for q8 in (False, True):
        kid = "B7" if q8 else "B6"
        args, kw = paged_cases(torch, dev, dtype, *shape, q8=q8)
        model = paged_split_plain(torch, at, *args, splits, **kw)
        exact = at.paged_decode_attention_plain(
            args[0].float(), *[a.float() if a.is_floating_point() else a
                               for a in args[1:]], **kw)
        ok = flash_row_ratio(torch, model, exact, TOL[dname])
        log(f"[parity] {kid} bar at {label}: the split model without a "
            f"fault is at {ok:.3f} of the bar")
        if not ok <= 1.0:
            raise AssertionError(f"{kid}'s split model fails its bar: {ok}")
        for fault, wrong, right in planted_paged_faults(torch, at, args, kw,
                                                        splits):
            ratio = flash_row_ratio(torch, wrong, right, TOL[dname])
            whole = ((wrong.float() - right.float()).abs().max()
                     / (TOL[dname]
                        * right.float().abs().max().clamp_min(1.0))).item()
            log(f"[parity] {kid} bar, planted fault at {label}: {fault} is "
                f"at {ratio:.2f} of the bar (the whole-tensor rule: "
                f"{whole:.2f})")
            if not ratio > 1.0:
                raise AssertionError(f"the {kid} bar passes a planted fault: "
                                     f"{fault} at {ratio}")


# B4 parity cases at the edges of decode_mma_kernel's TMA source: (label,
# b, nh, nkv, hd, cache length, pos). A cache length off the 64-key tile
# (1029: the speculative draft's stripe, max_len + spec_tokens + 1), g = 1,
# 2, 4, 8 (rows 0-7 of one row tile) and 64 (four row tiles), both head
# dims, rows at 0, mid-tile, a tile edge and len - 1, and a pos past the
# cache's end (the row's keys clamp there). Every case runs again over the
# cache with NaN in the slots past each row's pos: the kernel must give the
# bits it gives over the random values there.
B4_CASES = (
    ("the draft's stripe, len 1029, g=1", 8, 16, 16, 128, 1029,
     (1028, 700, 64, 63, 0, 1, 500, 900)),
    ("g=2, len 1029", 4, 32, 16, 128, 1029, (1028, 0, 511, 1000)),
    ("g=4, hd 64", 4, 32, 8, 64, 1029, (64, 1028, 7, 300)),
    ("g=8, len 130", 4, 64, 8, 128, 130, (129, 63, 0, 70)),
    ("g=64 (four row tiles), hd 64", 2, 64, 1, 64, 200, (199, 31)),
    ("a pos past the cache's end", 2, 32, 32, 128, 300, (5000, 299)),
    ("GPT-2's decode: 12 heads, hd 64, len 1024", 8, 12, 12, 64, 1024,
     (1023, 700, 300, 191, 144, 64, 1, 0)),
)


def b4_case(torch, dev, dtype, b, nh, nkv, hd, length, pos, seed=9):
    """q and a random cache [b, nkv, length, hd] in `dtype`, and the same
    cache with NaN in every slot past each row's pos (the unwritten slots
    of a stripe); returns q, ck, cv, ck_nan, cv_nan, pos."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, nkv, length, hd)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    live = (torch.arange(length, device=dev)[None, :]
            <= pos_t[:, None].long())[:, None, :, None]
    ck = torch.randn(shape, generator=g, device=dev).to(dtype)
    cv = torch.randn(shape, generator=g, device=dev).to(dtype)
    q = torch.randn(b, 1, nh, hd, generator=g, device=dev).to(dtype)
    nan = torch.tensor(float("nan"), device=dev, dtype=dtype)
    return (q, ck, cv, torch.where(live, ck, nan), torch.where(live, cv, nan),
            pos_t)


def phase_b4_parity(torch, dev):
    """B4 at B4_CASES, bf16, fp16 and f32: each output vector within its
    bar of
    the plain version run in f32, the whole tensor within TOL of the plain
    version, a second call bit-identical; over the cache with NaN past pos
    the same bits; one launch a call."""
    from paddle_tpu_torch.kernels import attention as at

    for dname in ATTN_DTYPES:
        dtype = getattr(torch, dname)
        for label, *shape in B4_CASES:
            b, nh, nkv, hd, length, pos = shape
            q, ck, cv, ckn, cvn, pos_t = b4_case(torch, dev, dtype, *shape)
            before = at.launches["decode_attention"]
            out = at.decode_attention(q, ck, cv, pos_t)
            again = at.decode_attention(q, ck, cv, pos_t)
            over_nan = at.decode_attention(q, ckn, cvn, pos_t)
            calls = at.launches["decode_attention"] - before
            ref = at.decode_attention_plain(q, ck, cv, pos_t)
            ref32 = at.decode_attention_plain(q.float(), ck.float(),
                                              cv.float(), pos_t)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[dname] * max(1.0, ref.float().abs().max().item())
            ratio = flash_row_ratio(torch, out, ref32, TOL[dname])
            splits = (at.decode_splits(at._window_last(pos_t, 1, length))
                      if at.paged_route(dtype) == "cluster" else 0)
            same, nan_same = torch.equal(out, again), torch.equal(out,
                                                                  over_nan)
            log(f"[parity] B4 {dname} {label}: b={b} nh={nh} nkv={nkv} "
                f"hd={hd} len={length} pos={pos}, "
                + (f"{splits} split(s)" if splits else "the shared body")
                + f": max_abs_err {err:.3e} (bar {tol:.3e}), worst row at "
                f"{ratio:.3f} of its bar, a second call "
                f"{'bit-identical' if same else 'DIFFERENT'}, over NaN past "
                f"pos {'the same bits' if nan_same else 'DIFFERENT'}, "
                f"{calls} launches for 3 calls")
            if not (math.isfinite(err) and err <= tol and ratio <= 1.0
                    and same and nan_same and calls == 3):
                raise AssertionError(f"B4 {dname} {label}: {err} (bar {tol}),"
                                     f" row ratio {ratio}, launches {calls}")
            del q, ck, cv, ckn, cvn


def b4_shared(torch, q, ck, cv, pos):
    """A call of B4's shared CUDA-core body in bf16 (the kernel the cluster
    kernel replaced there): its C entry point with splits 0, on fresh
    output; for timing beside the cluster kernel."""
    from paddle_tpu_torch.kernels import _build

    lib = _build.lib("attention")
    b, _, nh, hd = q.shape
    nkv, length = ck.shape[1], ck.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.pt_decode_attention(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), pos.data_ptr(),
            out.data_ptr(), b, nh, nkv, length, hd, 1, 1, 0,
            1.0 / math.sqrt(hd), stream)
        if rc != 0:
            raise RuntimeError(f"B4's shared body failed: CUDA error {rc}")
    return call


def decode_split_plain(torch, at, q, ck, cv, pos, splits, fault=None):
    """B4 computed the way decode_mma_kernel splits it, in f32: the cache
    [b, nkv, len, hd] is a pool of b pages of len keys, row r's table [r],
    so `paged_split_plain` walks each row's keys [0, min(pos, len - 1)]
    cut over `splits` splits. `fault` plants one of
    PAGED_FAULTS or "tail": the row's last tile read to its end with the
    keys past the row masked out of the softmax but their V rows left in
    P V (p = 0 times what the cache holds there)."""
    bt = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)[:, None]
    return paged_split_plain(torch, at, q, ck, cv, bt, pos, splits,
                             fault=fault)


def planted_b4_faults(torch, at, q, ck, cv, ckn, cvn, pos, splits):
    """B4 outputs with a fault planted, from `decode_split_plain`: [(fault,
    faulty, right)]; the tail fault over the cache with NaN past pos. The
    per-row bar must reject each."""
    right = at.decode_attention_plain(q, ck, cv, pos)
    out = [(name, decode_split_plain(torch, at, q, ck, cv, pos, splits,
                                     fault), right)
           for name, fault in PAGED_FAULTS.items() if fault != "scale page"]
    out.append(("the V rows past a row's pos left in P V (NaN x 0)",
                decode_split_plain(torch, at, q, ckn, cvn, pos, splits,
                                   "tail"), right))
    return out


def phase_b4_bar_teeth(torch, dev, dtype, case=0, splits=8):
    """The per-row B4 bar (bf16's, in bf16 and fp16) rejects planted faults
    at the draft's stripe (8 splits of the 1029-key rows: the short rows
    leave some empty), each beside the whole-tensor rule's ratio; the
    unplanted split model passes against the plain version in f32, over
    the random cache and over NaN past pos."""
    from paddle_tpu_torch.kernels import attention as at

    dname = str(dtype).replace("torch.", "")
    label, *shape = B4_CASES[case]
    label = f"{label} ({dname})"
    q, ck, cv, ckn, cvn, pos = b4_case(torch, dev, dtype, *shape)
    exact = at.decode_attention_plain(q.float(), ck.float(), cv.float(), pos)
    for cache, (k, v) in (("random values", (ck, cv)), ("NaN", (ckn, cvn))):
        model = decode_split_plain(torch, at, q, k, v, pos, splits)
        ok = flash_row_ratio(torch, model, exact, TOL[dname])
        log(f"[parity] B4 bar at {label}: the split model without a fault, "
            f"{cache} past pos, is at {ok:.3f} of the bar")
        if not ok <= 1.0:
            raise AssertionError(f"B4's split model fails its bar: {ok}")
    for fault, wrong, right in planted_b4_faults(torch, at, q, ck, cv, ckn,
                                                 cvn, pos, splits):
        ratio = flash_row_ratio(torch, wrong, right, TOL[dname])
        log(f"[parity] B4 bar, planted fault at {label}: {fault} is at "
            f"{ratio:.2f} of the bar")
        if ratio <= 1.0:
            raise AssertionError(f"the B4 bar passes a planted fault: "
                                 f"{fault} at {ratio}")


# B9/B10 parity cases: (label, rows, H, dtype); the first is the 7B leg's
# micro-batch (b4 s2048 over 2 micro-batches: 4096 rows), whose errors go
# into the JSON line
RMS_CASES = (("7B micro-batch", 4096, 4096, "bfloat16"),
             ("h2048 micro-batch", 4096, 2048, "bfloat16"),
             ("decode", 8, 4096, "bfloat16"),
             ("ragged rows", 4097, 4096, "bfloat16"),
             ("f32", 4096, 4096, "float32"),
             ("f32 ragged", 1001, 2048, "float32"),
             ("7B micro-batch fp16", 4096, 4096, "float16"),
             ("decode fp16", 8, 4096, "float16"),
             ("ragged rows fp16", 4097, 4096, "float16"))
# B9/B10 against their plain versions, set before the first run on the
# card. y and dx, row by row, within RMS_ROW_TOL of the row's max |plain|:
# bf16 two units in the last place of the row's largest entry (2^-6). y
# rounds twice on both sides, rnd(rnd(x r) w), and an r that differs in its
# last f32 bit (the two sum x^2 in different orders) can move the first
# rounding by a unit, which the multiply by w carries into the second; dx
# rounds once from f32 values that differ by summation order. f32: 1e-5,
# summation order only. r (f32 on both sides) each entry within
# RMS_R_TOL of |plain|: its relative error is half that of the sum of
# squares, ~sqrt(H) f32 roundings (~1e-6 at 4096). dw, summed over the
# rows in f32 in another order and then rounded to w's dtype: max |d| <=
# RMS_DW_TOL of max |plain dw| (bf16: one unit in the last place at the
# largest entry; f32: 1e-5). fp16 is held to bf16's bars (its unit in the
# last place is 8 times smaller).
RMS_ROW_TOL = {"bfloat16": 2.0**-6, "float16": 2.0**-6, "float32": 1e-5}
RMS_R_TOL = 1e-5
RMS_DW_TOL = {"bfloat16": 2.0**-7, "float16": 2.0**-7, "float32": 1e-5}
RMS_EPS = 1e-6


def rms_case(torch, dev, rows, h, dtype, seed=6):
    """x with rows at scales 10^U(-4, 1) (eps matters in the small ones),
    w ~ N(1, 0.5^2), g ~ N(0, 1), in `dtype` on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = 10.0 ** (torch.rand(rows, 1, generator=gen, device=dev) * 5 - 4)
    x = (torch.randn(rows, h, generator=gen, device=dev) * scale).to(dtype)
    w = (torch.randn(h, generator=gen, device=dev) * 0.5 + 1).to(dtype)
    g = torch.randn(rows, h, generator=gen, device=dev).to(dtype)
    return x, w, g


def rms_ratios(torch, got, ref, dname):
    """Each output's worst error over its bar (the kernel passes at <= 1):
    got/ref are {name: tensor} of y, r, dx, dw (any subset)."""
    out = {}
    for name, a in got.items():
        a, b = a.float(), ref[name].float()
        d = (a - b).abs()
        if name in ("y", "dx"):
            bar = RMS_ROW_TOL[dname] * b.abs().amax(-1)
            out[name] = (d.amax(-1) / bar.clamp_min(1e-30)).max().item()
        elif name == "r":
            out[name] = (d / (RMS_R_TOL * b.abs())).max().item()
        else:
            out[name] = (d.max() / (RMS_DW_TOL[dname]
                                    * b.abs().max())).item()
    return out


def rms_dw_split(torch, rn, x, r, g, sms, fault=None):
    """B10's dw the way rms_norm_bwd_kernel sums it, in f32 (before the
    rounding to w's dtype): each row group's rows (`rms_norm.bwd_rows` over
    `bwd_grid`'s blocks and `bwd_plan`'s groups), then the groups of each
    block and the blocks of each cluster in order, then the clusters in
    index order. `fault` plants one of RMS_DW_FAULTS."""
    rows, h = x.shape
    groups = rn.bwd_plan(h, x.element_size())[2]
    blocks, c = rn.bwd_grid(rows, h, x.element_size(), sms)
    terms = g.float() * x.float() * r.float()[:, None]
    part = [terms[a:e].sum(0) for a, e in rn.bwd_rows(rows, blocks, groups)]
    if fault == "group":
        part[0] = torch.zeros_like(part[0])
    per = c * groups                      # row groups a cluster
    clusters = [sum(part[k * per:(k + 1) * per])
                for k in range(blocks // c)]
    if fault == "twice":
        clusters[0] = 2 * clusters[0]
    if fault == "skip":
        clusters[-1] = torch.zeros_like(clusters[-1])
    return sum(clusters)


# planted faults of B10's dw sum (`rms_dw_split`)
RMS_DW_FAULTS = {"one row group's rows left out of dw": "group",
                 "one cluster's dw partial counted twice": "twice",
                 "one cluster's dw partial left out": "skip"}


def planted_rms_faults(torch, rn, x, w, g, sms):
    """B9/B10 outputs with a fault planted, built from the plain versions
    and B10's dw split (`rms_dw_split`): [(fault, {output: faulty},
    {output: right})]. The bars must reject each on at least one
    output."""
    h = x.shape[1]
    y, r = rn.rms_norm_fwd_plain(x, w, RMS_EPS)
    dx, dw = rn.rms_norm_bwd_plain(x, w, r, g)
    x32 = x.float()

    def fwd_with(rr):
        return (x32 * rr[:, None]).to(x.dtype) * w

    y_e, r_e = rn.rms_norm_fwd_plain(x, w, 0.0)
    r_h = torch.rsqrt((x32 * x32).sum(-1) / (h - 1) + RMS_EPS)
    r_o = r.roll(1)
    right = {"y": y, "r": r, "dx": dx, "dw": dw}
    return [("eps dropped", {"y": y_e, "r": r_e}, right),
            ("the mean taken over H - 1", {"y": fwd_with(r_h), "r": r_h},
             right),
            ("r from another row", {"y": fwd_with(r_o), "r": r_o,
                                    "dx": rn.rms_norm_bwd_plain(
                                        x, w, r_o, g)[0]}, right)] + [
        (name, {"dw": rms_dw_split(torch, rn, x, r, g, sms, fault).to(
            w.dtype)}, right) for name, fault in RMS_DW_FAULTS.items()]


def phase_rms_parity(torch, dev):
    """B9 and B10 against their plain versions on the card, each output
    within its bar (`rms_ratios`); then planted faults the bars must
    reject, at the 7B case (bf16 and fp16) and the f32 case. Returns the
    7B case's max |error| by launch key (y for B9, dx and dw for B10), in
    bf16 and under the `_f16` keys in fp16."""
    from paddle_tpu_torch.kernels import quantized_matmul as qm
    from paddle_tpu_torch.kernels import rms_norm as rn

    main_err = {}
    for i, (label, rows, h, dname) in enumerate(RMS_CASES):
        x, w, g = rms_case(torch, dev, rows, h, getattr(torch, dname))
        y, r = rn.rms_norm_fwd(x, w, RMS_EPS)
        ry, rr = rn.rms_norm_fwd_plain(x, w, RMS_EPS)
        # B10 from the plain forward's r, so that it is held to its plain
        # version on the same inputs
        before = rn.launches["rms_norm_bwd"]
        dx, dw = rn.rms_norm_bwd(x, w, rr, g)
        dx2, dw2 = rn.rms_norm_bwd(x, w, rr, g)
        calls = rn.launches["rms_norm_bwd"] - before
        rdx, rdw = rn.rms_norm_bwd_plain(x, w, rr, g)
        torch.cuda.synchronize()
        got = {"y": y, "r": r, "dx": dx, "dw": dw}
        ref = {"y": ry, "r": rr, "dx": rdx, "dw": rdw}
        ratios = rms_ratios(torch, got, ref, dname)
        errs = {k: (got[k].float() - ref[k].float()).abs().max().item()
                for k in got}
        same = torch.equal(dx, dx2) and torch.equal(dw, dw2)
        log(f"[parity] rms_norm {label} [{rows}, {h}] {dname}: " + ", ".join(
            f"{k} max_abs_err {errs[k]:.3e} at {ratios[k]:.3f} of its bar"
            for k in got) + f"; B10 grid (blocks, cluster) "
            f"{rn.bwd_grid(rows, h, x.element_size(), qm._sms(dev))}, "
            f"a second call {'bit-identical' if same else 'DIFFERENT'} (dx, "
            f"dw), {calls} launches for 2 calls")
        if not all(math.isfinite(v) and v <= 1.0 for v in ratios.values()) \
                or not same or calls != 2:
            raise AssertionError(f"rms_norm {label}: a kernel disagrees with "
                                 f"its plain version: {ratios}, or B10 is "
                                 f"not reproducible ({same}) or launched "
                                 f"{calls} times for 2 calls")
        if label in ("7B micro-batch", "7B micro-batch fp16"):
            x_dtype = getattr(torch, dname)
            main_err.update({
                f16_key("rms_norm_fwd", x_dtype): errs["y"],
                f16_key("rms_norm_bwd", x_dtype): max(errs["dx"],
                                                      errs["dw"])})
        if label in ("7B micro-batch", "f32", "7B micro-batch fp16"):
            sms = qm._sms(dev)
            split = rms_dw_split(torch, rn, x, rr, g, sms).to(w.dtype)
            ok = rms_ratios(torch, {"dw": split}, {"dw": rdw}, dname)["dw"]
            log(f"[parity] rms_norm bar at {label}: B10's dw split without a "
                f"fault is at {ok:.3f} of its bar")
            if not ok <= 1.0:
                raise AssertionError(f"B10's dw split fails its bar: {ok}")
            for fault, wrong, right in planted_rms_faults(torch, rn, x, w, g,
                                                          sms):
                bad = rms_ratios(torch, wrong, right, dname)
                log(f"[parity] rms_norm bar, planted fault at {label}: "
                    f"{fault}: " + ", ".join(f"{k} at {v:.2f} of its bar"
                                             for k, v in bad.items()))
                if not max(bad.values()) > 1.0:
                    raise AssertionError(f"the rms_norm bars pass a planted "
                                         f"fault: {fault} at {bad}")
        del x, w, g, y, r, ry, rr, dx, dw, dx2, dw2, rdx, rdw, got, ref
        torch.cuda.empty_cache()
    return main_err


# B1-B3 parity cases: (label, b, sq, sk, h, hk, d, causal, dtype); the first
# is the 7B leg's micro-batch, whose errors go into the JSON line
FLASH_CASES = (
    ("bf16 causal b2 h32 s2048 d128", 2, 2048, 2048, 32, 32, 128, True,
     "bfloat16"),
    ("bf16 causal GQA nh32/nkv8 s1024", 1, 1024, 1024, 32, 8, 128, True,
     "bfloat16"),
    ("bf16 non-causal h16 s1024", 1, 1024, 1024, 16, 16, 128, False,
     "bfloat16"),
    ("bf16 causal cross-length sq384/sk1024", 2, 384, 1024, 8, 8, 128, True,
     "bfloat16"),
    ("bf16 causal ragged s1000 GQA 8/4", 1, 1000, 1000, 8, 4, 128, True,
     "bfloat16"),
    ("bf16 causal sq1000 > sk300 (fully masked rows)", 1, 1000, 300, 8, 8,
     128, True, "bfloat16"),
    ("bf16 causal hd64 ragged s777 GQA 4/2", 2, 777, 777, 4, 2, 64, True,
     "bfloat16"),
    # one row past a 128-row Q tile, one key short of a 128-key tile
    ("bf16 causal sq129/sk127 GQA 4/2 (rows 0-1 see no key)", 2, 129, 127,
     4, 2, 128, True, "bfloat16"),
    ("bf16 non-causal hd64 sq129/sk127", 1, 129, 127, 4, 4, 64, False,
     "bfloat16"),
    # the backward's tile edges: Sq and Sk off the 128- and 64-row tiles, a
    # GQA group of 8, and rows past Sk without the causal mask
    ("bf16 causal sq192/sk320 GQA 8/2", 1, 192, 320, 8, 2, 128, True,
     "bfloat16"),
    ("bf16 causal hd64 sq65/sk129", 1, 65, 129, 4, 4, 64, True, "bfloat16"),
    ("bf16 causal s256 GQA 8/1", 1, 256, 256, 8, 1, 128, True, "bfloat16"),
    ("bf16 non-causal sq300 > sk200 GQA 8/4", 1, 300, 200, 8, 4, 128, False,
     "bfloat16"),
    ("f32 causal s512 d128 GQA 4/2", 1, 512, 512, 4, 2, 128, True,
     "float32"),
    ("f32 non-causal sq300/sk200 d64", 1, 300, 200, 4, 4, 64, False,
     "float32"),
    ("f32 causal sq300 > sk100 d128 (fully masked rows)", 1, 300, 100, 4, 2,
     128, True, "float32"),
)


# B1 alone in fp16 and at head_dim 32 (B2/B3 take neither: no training
# config needs them): the UNet's shapes first (the first fp16 case and the
# first head_dim-32 one give the JSON rows their errors), then causal and
# full, GQA, Sq != Sk, ragged tails and rows that see no key
FLASH_FWD_CASES = (
    ("fp16 non-causal UNet level 2 b1 h8 s256 d64", 1, 256, 256, 8, 8, 64,
     False, "float16"),
    ("bf16 non-causal UNet level 1 b1 h8 s1024 d32", 1, 1024, 1024, 8, 8,
     32, False, "bfloat16"),
    ("fp16 non-causal UNet level 1 b1 h8 s1024 d32", 1, 1024, 1024, 8, 8,
     32, False, "float16"),
    ("f32 non-causal UNet level 1 b1 h8 s1024 d32", 1, 1024, 1024, 8, 8, 32,
     False, "float32"),
    ("fp16 causal b2 h32 s2048 d128", 2, 2048, 2048, 32, 32, 128, True,
     "float16"),
    ("fp16 causal GQA nh32/nkv8 s1024 d128", 1, 1024, 1024, 32, 8, 128,
     True, "float16"),
    ("fp16 causal hd64 ragged s777 GQA 4/2", 2, 777, 777, 4, 2, 64, True,
     "float16"),
    ("fp16 non-causal hd64 sq129/sk127", 1, 129, 127, 4, 4, 64, False,
     "float16"),
    ("fp16 causal sq1000 > sk300 d128 (fully masked rows)", 1, 1000, 300, 8,
     8, 128, True, "float16"),
    ("bf16 causal d32 cross-length sq384/sk1024 GQA 8/2", 2, 384, 1024, 8,
     2, 32, True, "bfloat16"),
    ("fp16 causal d32 ragged s777 GQA 4/2", 2, 777, 777, 4, 2, 32, True,
     "float16"),
    ("bf16 non-causal d32 sq129/sk127", 1, 129, 127, 4, 4, 32, False,
     "bfloat16"),
    ("fp16 causal d32 sq300 > sk100 GQA 4/2 (fully masked rows)", 1, 300,
     100, 4, 2, 32, True, "float16"),
    ("f32 causal d32 sq300/sk200 GQA 4/2", 1, 300, 200, 4, 2, 32, True,
     "float32"),
    ("f32 non-causal d32 sq129 > sk100", 1, 129, 100, 4, 4, 32, False,
     "float32"),
)


def flash_case(torch, dev, b, sq, sk, h, hk, d, dtype, seed=5):
    """q, k, v, do ~ N(0, 1) in `dtype` on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    return rnd(b, sq, h, d), rnd(b, sk, hk, d), rnd(b, sk, hk, d), \
        rnd(b, sq, h, d)


# B1-B3 against their plain versions, vector by vector: out and dq for each
# (query, head), dk and dv for each (key, kv head), each within TOL of that
# vector's largest |plain| entry (2 bf16 units in its last place). One bar
# for the whole tensor would be set by the causal extremes (query 0 sees one
# key, so its out is a row of v) and would pass a kernel that is wrong for
# the queries that average hundreds of keys. No bar is below FLASH_FLOOR *
# the tensor's max |plain| (what summation order alone leaves in f32, so the
# f32 cases keep the whole-tensor rule): a vector whose plain values are ~0
# by cancellation (dq of query 0 under causal attention: its one key gives
# dS = P(dP - delta) = 0) differs by f32 rounding only. lse is f32 on both
# sides: each entry within FLASH_LSE_TOL * max(1, |plain|).
FLASH_FLOOR = 1e-5
FLASH_LSE_TOL = 1e-5


def flash_row_ratio(torch, got, ref, tol):
    """The worst vector's max |got - ref| over its bar, tol * its max |ref|
    (over the last dim) or FLASH_FLOOR * max |ref|, the larger; the kernel
    passes at <= 1. Where the plain version is 0 throughout (no query sees
    a key), the kernel's must be 0."""
    d = (got.float() - ref.float()).abs().amax(-1)
    top = ref.float().abs().amax(-1)
    bar = (tol * top).clamp_min(FLASH_FLOOR * top.max().item())
    return (d / bar.clamp_min(1e-30)).max().item()


def flash_lse_ratio(torch, got, ref):
    bar = FLASH_LSE_TOL * ref.float().abs().clamp_min(1.0)
    return ((got.float() - ref.float()).abs() / bar).max().item()


@contextlib.contextmanager
def plain_route():
    """The attention route's predicate false for the block: the layers take
    their plain attention, never B1-B3."""
    fmod = importlib.import_module(
        "paddle_tpu_torch.nn.functional.flash_attention")
    use = fmod._use_kernel
    fmod._use_kernel = lambda *a, **k: False
    try:
        yield
    finally:
        fmod._use_kernel = use


@contextlib.contextmanager
def on_cpu(paddle):
    """The port's default device the CPU for the block, restored after."""
    from paddle_tpu_torch.framework import device as device_mod

    prev = device_mod._current
    paddle.set_device("cpu")
    try:
        yield
    finally:
        device_mod._current = prev


@contextlib.contextmanager
def flash_calls(every=False):
    """For the block, keeps a copy of the inputs and outputs of B1's first
    call (`flash_fwd`) and of B2 + B3's first (`flash_bwd`), as the main
    path makes them: {"fwd" | "bwd": (args, outputs)}; with `every`, of
    every call: {"fwd" | "bwd": [(args, outputs)]}. The wrappers run as
    they are, launch counts included."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    seen = {"fwd": [], "bwd": []} if every else {}
    wrapped = {"fwd": fa.flash_fwd, "bwd": fa.flash_bwd}

    def keeping(name):
        def call(*args):
            outs = wrapped[name](*args)
            if every or name not in seen:
                kept = tuple(
                    tuple(x.detach().clone() if hasattr(x, "detach") else x
                          for x in xs) for xs in (args, outs))
                if every:
                    seen[name].append(kept)
                else:
                    seen[name] = kept
            return outs
        return call

    fa.flash_fwd, fa.flash_bwd = keeping("fwd"), keeping("bwd")
    try:
        yield seen
    finally:
        fa.flash_fwd, fa.flash_bwd = wrapped["fwd"], wrapped["bwd"]


def flash_f64(torch, fa, q, k, v, causal, scale, o=None, do=None, g_lse=None):
    """B1's out, and given `do` B2 + B3's (dq, dk, dv), in float64 from the
    same inputs; delta = rowsum(dO·O) - g_lse from the `o` B2/B3 were
    given, as theirs is."""
    g = q.shape[2] // k.shape[2]
    B, Sk, Hk, D = k.shape

    def heads(x, rep=1):   # [B, S, h, D] -> [B, h * rep, S, D] in f64
        return x.double().transpose(1, 2).repeat_interleave(rep, dim=1)

    Q, K, V = heads(q), heads(k, g), heads(v, g)
    s = Q @ K.transpose(-1, -2) * scale
    vis = fa._visible(q.shape[1], Sk, causal, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, float("-inf"))
    p = torch.softmax(s, dim=-1)
    if do is None:
        return ((p @ V).transpose(1, 2),)
    dO = heads(do)
    delta = (dO * heads(o)).sum(-1, keepdim=True)
    if g_lse is not None:
        delta = delta - g_lse.double()[..., None]
    ds = p * (dO @ V.transpose(-1, -2) - delta)

    def group(x):   # [B, H, Sk, D] -> [B, Sk, Hk, D]
        return x.reshape(B, Hk, g, Sk, D).sum(dim=2).transpose(1, 2)

    return ((ds @ K * scale).transpose(1, 2),
            group(ds.transpose(-1, -2) @ Q * scale),
            group(p.transpose(-1, -2) @ dO))


def flash_path_check(torch, seen, label, quiet=False):
    """B1's out and lse, and B2 + B3's dq, dk and dv where the path ran
    them, from the calls `flash_calls` kept, against the plain versions on
    those same inputs (`flash_row_ratio` at TOL of the dtype,
    `flash_lse_ratio`). Where the plain version itself is not within that
    bar of the float64 value (`flash_f64`) on these inputs, an output is
    held instead to be no further from the float64 value than twice the
    plain version's distance, by its worst vector and by ||d|| / ||f64||:
    in the deep layers of a post-LN stack at a random init the tokens are
    nearly equal (rank collapse), so dq and dk are small differences of
    near-equal terms and any bf16 order of summation lands several bars
    from any other. Then B1-B3 at that shape on N(0, 1) inputs
    (`flash_case`), whose attention is far from uniform, all at the bars
    alone; there the mean of v over the keys in place of B1's out must fail
    the bar. Returns {name: worst ratio}; raises where one fails."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    args, (out, lse) = seen["fwd"]
    q, k, v, causal, scale = args
    dname = str(q.dtype).split(".")[-1]
    tol = TOL[dname]
    g = q.shape[2] // k.shape[2]

    def mean_v(v, ref):
        m = v.float().mean(1, keepdim=True).repeat_interleave(g, dim=2)
        return m.expand(ref.shape)

    # (name, kernel's, plain's, float64's) on the path's inputs
    ref_out, ref_lse = fa.flash_fwd_plain(*args)
    path = [("out", out, ref_out, flash_f64(torch, fa, *args)[0])]
    if "bwd" in seen:
        bargs, got = seen["bwd"]
        bq, bk, bv, bo, _, bdo, bcausal, bscale, bg = bargs
        path += list(zip(("dq", "dk", "dv"), got, fa.flash_bwd_plain(*bargs),
                         flash_f64(torch, fa, bq, bk, bv, bcausal, bscale,
                                   bo, bdo, bg)))
    r = {"lse": flash_lse_ratio(torch, lse, ref_lse),
         "mean_v_at_path": flash_row_ratio(torch, mean_v(v, ref_out),
                                           ref_out, tol)}
    far, bad = {}, {}
    for name, got, plain, f64 in path:
        r[name] = flash_row_ratio(torch, got, plain, tol)
        if math.isfinite(r[name]) and r[name] <= 1.0:
            continue
        rows = (flash_row_ratio(torch, got, f64, tol),
                flash_row_ratio(torch, plain, f64, tol))
        fro = (_rel(torch, got, f64), _rel(torch, plain, f64))
        far[name] = {"rows kernel/plain to f64": [round(x, 3) for x in rows],
                     "||d||/||f64|| kernel/plain": [f"{x:.3e}" for x in fro]}
        if not (rows[1] > 1.0 and rows[0] <= 2 * rows[1] and
                fro[0] <= 2 * fro[1]):
            bad[name] = far[name]
    if not r["lse"] <= 1.0:
        bad["lse"] = r["lse"]

    def common(k):   # the keys' mean over the sequence over their spread
        spread = k.float() - k.float().mean(1, keepdim=True)
        return round(float((k.float().mean(1).norm(dim=-1) / spread.pow(
            2).sum(-1).mean(1).sqrt()).median()), 3)

    commons = [common(k)] + ([common(seen["bwd"][0][1])] if "bwd" in seen
                             else [])

    b, sq, h, d = q.shape
    rq, rk, rv, rdo = flash_case(torch, q.device, b, sq, k.shape[1], h,
                                 k.shape[2], d, q.dtype)
    o2, l2 = fa.flash_fwd(rq, rk, rv, causal, scale)
    ro, rl = fa.flash_fwd_plain(rq, rk, rv, causal, scale)
    r["out_n01"] = flash_row_ratio(torch, o2, ro, tol)
    r["lse_n01"] = flash_lse_ratio(torch, l2, rl)
    r["mean_v_n01"] = flash_row_ratio(torch, mean_v(rv, ro), ro, tol)
    if "bwd" in seen:
        for name, a, b in zip(
                ("dq_n01", "dk_n01", "dv_n01"),
                fa.flash_bwd(rq, rk, rv, ro, rl, rdo, causal, scale),
                fa.flash_bwd_plain(rq, rk, rv, ro, rl, rdo, causal, scale)):
            r[name] = flash_row_ratio(torch, a, b, tol)
    torch.cuda.synchronize(q.device)
    for name, x in r.items():
        if name.endswith("_n01") and name != "mean_v_n01" and \
                not (math.isfinite(x) and x <= 1.0):
            bad[name] = x
    if not quiet:
        log(f"[configs] {label}: B1{'-B3' if 'bwd' in seen else ''} against "
            f"the plain versions on the inputs the path gave them "
            f"(q {tuple(q.shape)} {dname}, causal {causal}; the keys' mean over "
            f"the sequence over their spread, median over (batch, head), in "
            f"B1's kept call{' and B2/B3' if 'bwd' in seen else ''}'s: "
            f"{commons}) and at that shape on N(0, 1) inputs, worst vector at (fraction of its bar, {tol}) "
            f"{ {n: round(x, 4) for n, x in r.items()} }; over the bar against "
            f"the plain version, each against the float64 value: {far}; the "
            f"mean of v in place of B1's out must fail the bar on the N(0, 1) "
            f"inputs")
    if bad or not r["mean_v_n01"] > 1.0:
        raise AssertionError(f"{label}: B1-B3 against their plain versions "
                             f"{r}; failing {bad}")
    return r


def adam_reach(steps, beta1=0.9, beta2=0.999):
    """How far `steps` Adam updates can move a parameter, in units of lr,
    whatever its gradients: update t is |m_t| / sqrt(v_t) (both bias-
    corrected) <= sqrt(sum_i a_i^2 / b_i) by Cauchy-Schwarz, a_i and b_i
    the weights m_t and v_t give gradient i (3.005 summed over 3 steps)."""
    reach = 0.0
    for t in range(1, steps + 1):
        a = [beta1 ** (t - i) * (1 - beta1) / (1 - beta1 ** t)
             for i in range(1, t + 1)]
        b = [beta2 ** (t - i) * (1 - beta2) / (1 - beta2 ** t)
             for i in range(1, t + 1)]
        reach += math.sqrt(sum(x * x / y for x, y in zip(a, b)))
    return reach


def planted_flash_faults(torch, fa, q, k, v, do, causal, tile=64):
    """B1-B3 outputs with a fault planted, built from the plain versions:
    [(fault, output name, faulty, right)]. The bar must reject each."""
    g = q.shape[2] // k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = fa.flash_fwd_plain(q, k, v, causal)
    dq, dk, _ = fa.flash_bwd_plain(q, k, v, out, lse, do, causal)
    v_tail0 = v.clone()
    v_tail0[:, -tile:] = 0
    faults = [
        ("sm_scale 1% high", "out",
         fa.flash_fwd_plain(q, k, v, causal, scale * 1.01)[0], out),
        ("the last key tile's V read as zeros", "out",
         fa.flash_fwd_plain(q, k, v_tail0, causal)[0], out),
        ("delta left out of dS", "dq",
         fa.flash_bwd_dq_plain(q, k, v, do, lse, torch.zeros_like(lse),
                               causal), dq)]
    if g > 1:
        kr, vr = (t.repeat_interleave(g, dim=2) for t in (k, v))
        faults.append(("dk of one query head a group (no GQA sum)", "dk",
                       fa.flash_bwd_plain(q, kr, vr, out, lse, do,
                                          causal)[1][:, :, ::g], dk))
    return faults


def phase_flash_bar_teeth(torch, dev, case=FLASH_CASES[1]):
    """The B1-B3 bar rejects planted faults at a parity shape (the GQA case
    by default; the parity phase adds an fp16 and a head_dim-32 case), each
    beside the ratio the whole-tensor rule (TOL * max(1, max |plain|)) would
    give it."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    label, b, sq, sk, h, hk, d, causal, dname = case
    q, k, v, do = flash_case(torch, dev, b, sq, sk, h, hk, d,
                             getattr(torch, dname))
    for fault, name, wrong, right in planted_flash_faults(torch, fa, q, k, v,
                                                          do, causal):
        ratio = flash_row_ratio(torch, wrong, right, TOL[dname])
        whole = ((wrong.float() - right.float()).abs().max()
                 / (TOL[dname] * right.float().abs().max().clamp_min(1.0))
                 ).item()
        log(f"[parity] flash bar, planted fault at {label}: {fault} ({name})"
            f" is at {ratio:.2f} of the bar (the whole-tensor rule: "
            f"{whole:.2f})")
        if not ratio > 1.0:
            raise AssertionError(f"the flash bar passes a planted fault: "
                                 f"{fault} at {ratio}")
    torch.cuda.empty_cache()


def phase_flash_parity(torch, dev):
    """B1, and B2 + B3 through `flash_bwd`, against their plain versions on
    the card (`flash_row_ratio`); returns the first case's max |error| by
    launch key."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    main_err = {}
    for i, (label, b, sq, sk, h, hk, d, causal, dname) in enumerate(
            FLASH_CASES):
        dtype = getattr(torch, dname)
        q, k, v, do = flash_case(torch, dev, b, sq, sk, h, hk, d, dtype)
        out, lse = fa.flash_fwd(q, k, v, causal)
        ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
        # the backward from the plain forward's outputs, so that B2/B3 are
        # held to their plain versions on the same inputs
        dq, dk, dv = fa.flash_bwd(q, k, v, ref_out, ref_lse, do, causal)
        rdq, rdk, rdv = fa.flash_bwd_plain(q, k, v, ref_out, ref_lse, do,
                                           causal)
        torch.cuda.synchronize()
        masked = ref_lse <= -1e29
        lse_ok = bool(((lse <= -1e29) == masked).all().item())
        errs = {}
        for name, got, ref in (("out", out, ref_out),
                               ("lse", torch.where(masked, 0.0, lse),
                                torch.where(masked, 0.0, ref_lse)),
                               ("dq", dq, rdq), ("dk", dk, rdk),
                               ("dv", dv, rdv)):
            err = (got.float() - ref.float()).abs().max().item()
            ratio = (flash_lse_ratio(torch, got, ref) if name == "lse"
                     else flash_row_ratio(torch, got, ref, TOL[dname]))
            errs[name] = err
            log(f"[parity] flash {label}: {name} max_abs_err {err:.3e}, "
                f"worst {'entry' if name == 'lse' else 'row'} at "
                f"{ratio:.3f} of its bar")
            if not (math.isfinite(ratio) and ratio <= 1.0):
                raise AssertionError(f"flash {label}: {name} disagrees with "
                                     f"the plain version (worst at {ratio} "
                                     "of its bar)")
        if not lse_ok:
            raise AssertionError(f"flash {label}: the fully masked rows "
                                 "differ")
        if i == 0:
            main_err = {"flash_fwd": errs["out"], "flash_bwd_dq": errs["dq"],
                        "flash_bwd_dkv": max(errs["dk"], errs["dv"])}
        del q, k, v, do, out, lse, ref_out, ref_lse, dq, dk, dv, rdq, rdk, rdv
        torch.cuda.empty_cache()
    return main_err


def phase_flash_fwd_parity(torch, dev):
    """B1 in fp16 and at head_dim 32 (FLASH_FWD_CASES) against its plain
    version on the card, each output vector within its bar
    (`flash_row_ratio`: the bf16 bar for fp16, 1e-5 in f32), lse within
    FLASH_LSE_TOL; a second call bit-identical and one launch a call,
    counted under its variant too. Returns the first fp16 case's and the
    first head_dim-32 case's max |error| under their keys of KERNELS."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    main_err = {}
    for label, b, sq, sk, h, hk, d, causal, dname in FLASH_FWD_CASES:
        dtype = getattr(torch, dname)
        q, k, v, _ = flash_case(torch, dev, b, sq, sk, h, hk, d, dtype)
        before, vbefore = launch_counts(), variant_counts()
        out, lse = fa.flash_fwd(q, k, v, causal)
        out2, lse2 = fa.flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        n = launch_counts()["flash_fwd"] - before["flash_fwd"]
        want_v = {"flash_fwd_f16": 2 * (dname == "float16"),
                  "flash_fwd_hd32": 2 * (d == 32)}
        nv = {key: variant_counts()[key] - vbefore[key] for key in want_v}
        same = bool(torch.equal(out, out2) and torch.equal(lse, lse2))
        ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
        masked = ref_lse <= -1e29
        lse_ok = bool(((lse <= -1e29) == masked).all().item())
        r_out = flash_row_ratio(torch, out, ref_out, TOL[dname])
        r_lse = flash_lse_ratio(torch, torch.where(masked, 0.0, lse),
                                torch.where(masked, 0.0, ref_lse))
        err = (out.float() - ref_out.float()).abs().max().item()
        log(f"[parity] flash B1 {label}: out max_abs_err {err:.3e}, worst "
            f"row at {r_out:.3f} of its bar ({TOL[dname]}), lse worst entry "
            f"at {r_lse:.3f}; second call bit-identical {same}; launches "
            f"{n} for 2 calls, by variant {nv}")
        if not (math.isfinite(r_out) and r_out <= 1.0 and r_lse <= 1.0
                and lse_ok and same and n == 2 and nv == want_v):
            raise AssertionError(
                f"flash B1 {label}: out at {r_out}, lse at {r_lse} of the "
                f"bar, masked rows equal {lse_ok}, repeat equal {same}, "
                f"launches {n} {nv} (want 2, {want_v})")
        for key, hit in (("flash_fwd_f16", dname == "float16"),
                         ("flash_fwd_hd32", d == 32)):
            if hit and key not in main_err:
                main_err[key] = err
        del q, k, v, out, lse, out2, lse2, ref_out, ref_lse
        torch.cuda.empty_cache()
    return main_err


# ---------------------------------------------------------------------------
# training: the engine's step at bench.py's training legs
# ---------------------------------------------------------------------------


# bench.py::_candidate_configs (:150) as `LlamaConfig` keywords, and how
# `_bench` (:95) drives each: (config, batch, seq, micro-batches)
H4096 = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
             num_hidden_layers=4, num_attention_heads=32,
             max_position_embeddings=2048)
H2048 = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
             num_hidden_layers=16, num_attention_heads=16,
             max_position_embeddings=2048)
TRAIN_LEGS = {"train": (H4096, 4, 2048, 2),          # bench.py:186
              "train-h2048": (H2048, 8, 1024, 2)}    # bench.py:169
# train-check bars, f32 weights (set before the first run): both sides
# compute in f32 with TF32 off and differ in the order of their sums (B1-B3
# stream online softmax, the fused CE sums chunk by chunk)
TRAIN_CHECK_BARS = {"loss_rel": 1e-5, "grad_rel": 1e-3}
# its bf16 leg: the same weights rounded to bf16, through B1-B3 and through
# the plain bf16 attention (use_flash=False), each against the f32
# reference. Both legs round the same weights and activations; the kernels
# may not leave the worst grad leaf further from the reference than
# BF16_VS_PLAIN times the plain leg's, and neither leg may pass the bars
# (the loss bar set from a first reading: rel 1.2e-4 through B1-B3, 6.3e-5
# through the plain attention; worst grad leaves 2.4e-2 and 3.2e-2).
TRAIN_CHECK_BF16_BARS = {"loss_rel": 1e-3, "grad_rel": 5e-2}
BF16_VS_PLAIN = 1.5
PEAK_SEEN = []   # device memory peaks read before a phase resets the peak


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{prefix}/{k}")]
    return [(prefix, tree)]


def reference_train_loss(torch, params, ids, labels, args):
    """Mean next-token CE of one sequence (ids, labels [1, T]) in f32,
    sharing no code with the port: norms, RoPE and the SwiGLU written out,
    materialized causal attention (`_attention`), the full [T, vocab]
    logits and an unfused CE, differentiated by plain autograd."""
    import torch.nn.functional as F

    T, hd = ids.shape[1], args.head_dim
    f32, dev = torch.float32, ids.device
    inv = 1.0 / (args.rope_theta ** (torch.arange(0, hd, 2, device=dev,
                                                  dtype=f32) / hd))
    ang = torch.outer(torch.arange(T, device=dev, dtype=f32), inv)
    cos = torch.cat([ang, ang], -1).cos()[:, None]
    sin = torch.cat([ang, ang], -1).sin()[:, None]

    def norm(x, w):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                               + args.rms_eps) * w

    def rope(x):
        x1, x2 = x.chunk(2, dim=-1)
        return x * cos + torch.cat([-x2, x1], dim=-1) * sin

    lay = params["layers"]
    h = params["embedding"][ids[0]]
    for i in range(args.num_layers):
        x = norm(h, lay["ln1"][i])
        q = (x @ lay["wq"][i]).view(T, args.num_heads, hd)
        k = (x @ lay["wk"][i]).view(T, args.num_kv_heads, hd)
        v = (x @ lay["wv"][i]).view(T, args.num_kv_heads, hd)
        h = h + _attention(torch, rope(q), rope(k), v).reshape(T, -1) \
            @ lay["wo"][i]
        x = norm(h, lay["ln2"][i])
        h = h + (F.silu(x @ lay["w_gate"][i]) * (x @ lay["w_up"][i])) \
            @ lay["w_down"][i]
    logits = norm(h, params["final_norm"]) @ params["lm_head"]
    true = logits.gather(-1, labels[0][:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - true).mean()


def _worst_grad(params, ref_params):
    """(leaf path, ||grad - ref grad|| / ||ref grad||) of the worst leaf."""
    worst = ("", 0.0)
    for (path, p), (_, r) in zip(_leaves(params), _leaves(ref_params)):
        rel = ((p.grad.float() - r.grad).norm() / r.grad.norm()).item()
        if not math.isfinite(rel) or rel > worst[1]:
            worst = (path, rel)
    return worst


def _bf16_copy(torch, tree):
    if isinstance(tree, dict):
        return {k: _bf16_copy(torch, v) for k, v in tree.items()}
    return tree.detach().to(torch.bfloat16).requires_grad_(True)


def phase_train_check(torch, dev, seq=1024, loss_chunk=128):
    """The port's loss and grad tree (B1-B3, the fused CE) against
    `reference_train_loss` at Llama-2-7B width, 2 layers: f32 weights (the
    f32 kernels), then the same weights in bf16 through the bf16 kernels
    the training legs run, beside the plain bf16 attention."""
    import numpy as np
    from paddle_tpu_torch.models import LLAMA2_7B, init_params
    from paddle_tpu_torch.models import llama_functional as lf

    args = LLAMA2_7B._replace(num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(args, gen, device=dev, dtype=torch.float32)
    ref_params = {"embedding": params["embedding"].clone(),
                  "layers": {k: v.clone()
                             for k, v in params["layers"].items()},
                  "final_norm": params["final_norm"].clone(),
                  "lm_head": params["lm_head"].clone()}
    for tree in (params, ref_params):
        for _, t in _leaves(tree):
            t.requires_grad_(True)
    rng = np.random.default_rng(0)
    ids, labels = (torch.from_numpy(rng.integers(
        0, args.vocab_size, (1, seq)).astype(np.int64)).to(dev)
        for _ in range(2))
    ref = reference_train_loss(torch, ref_params, ids, labels, args)
    ref.backward()
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    bars = TRAIN_CHECK_BARS
    readings = {}
    for leg, tree, use_flash in (("f32", params, True),
                                 ("bf16", _bf16_copy(torch, ref_params), True),
                                 ("bf16 plain attention",
                                  _bf16_copy(torch, ref_params), False)):
        reset_launches()
        loss = lf.forward_and_loss(tree, ids, labels,
                                   args._replace(use_flash=use_flash),
                                   remat=False, loss_chunk=loss_chunk)
        loss.backward()
        torch.cuda.synchronize(dev)
        launches = {k: launch_counts()[k] for k in flash + NORMS}
        loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
        worst = _worst_grad(tree, ref_params)
        readings[leg] = (loss_rel, worst[1])
        log(f"[train-check] Llama-2-7B width, 2 layers, {leg}, s {seq}, "
            f"loss_chunk {loss_chunk}: loss {loss.item():.6f} vs the f32 "
            f"reference {ref.item():.6f}, rel {loss_rel:.3e}; worst grad "
            f"leaf {worst[0]} ||d||/||ref|| {worst[1]:.3e}; launches "
            f"{launches}")
        want = dict.fromkeys(flash, args.num_layers if use_flash else 0)
        want.update(dict.fromkeys(NORMS, 2 * args.num_layers + 1))
        if not (math.isfinite(loss_rel) and math.isfinite(worst[1])
                and launches == want):
            raise AssertionError(f"train-check {leg}: loss rel {loss_rel}, "
                                 f"grad {worst}, launches {launches}")
        del tree, loss
    f32, bf, plain = (readings[k] for k in ("f32", "bf16",
                                            "bf16 plain attention"))
    bf_bars = TRAIN_CHECK_BF16_BARS
    grad_bar = min(bf_bars["grad_rel"], BF16_VS_PLAIN * plain[1])
    log(f"[train-check] bars: f32 loss rel {bars['loss_rel']}, grad "
        f"{bars['grad_rel']}; bf16 loss rel {bf_bars['loss_rel']}, grad "
        f"{bf_bars['grad_rel']}, and through B1-B3 grad {grad_bar:.3e} "
        f"({BF16_VS_PLAIN}x the plain attention's)")
    if not (f32[0] <= bars["loss_rel"] and f32[1] <= bars["grad_rel"]):
        raise AssertionError(f"train-check f32: {f32} over {bars}")
    if not (max(bf[0], plain[0]) <= bf_bars["loss_rel"]
            and plain[1] <= bf_bars["grad_rel"] and bf[1] <= grad_bar):
        raise AssertionError(f"train-check bf16: B1-B3 {bf}, the plain "
                             f"attention {plain}, bars {bf_bars}, grad "
                             f"{grad_bar}")


# the eager phase: Llama-2-7B width, 2 layers, b 1, s 2048, causal, written
# against the port's eager surface; held to `forward_and_loss` on the same
# weights. f32 bars are train-check's; bf16 holds the loss only.
EAGER_LEG = dict(layers=2, batch=1, seq=2048)
EAGER_BARS = {"loss_rel": 1e-5, "grad_rel": 1e-3}
EAGER_BF16_LOSS_REL = 1e-3


def eager_llama_loss(P, params, ids, labels, args):
    """Mean next-token CE of a Llama over the eager surface of module `P`
    (`paddle_tpu_torch`, or `paddle_tpu` in the CPU tests), written as a
    user of `nn.functional` writes it: embedding by `index_select`,
    `F.rms_norm` (B9, backward B10, on the card), RoPE from `split` /
    `concat` (in f32), causal `F.flash_attention`, SwiGLU with `F.silu`,
    `F.cross_entropy` over f32 logits. `params` is `llama_functional`'s
    tree of P Tensors (layer leaves stacked on L), ids / labels [B, T] int
    Tensors."""
    F = P.nn.functional
    B, T = ids.shape
    nh, nkv, hd = args.num_heads, args.num_kv_heads, args.head_dim
    inv = 1.0 / (args.rope_theta ** (P.arange(0, hd, 2, dtype="float32")
                                     / hd))
    ang = P.unsqueeze(P.arange(T, dtype="float32"), 1) * P.unsqueeze(inv, 0)
    ang = P.reshape(P.concat([ang, ang], axis=-1), [1, T, 1, hd])
    cos, sin = P.cos(ang), P.sin(ang)

    def rope(x):
        xf = P.cast(x, "float32")
        x1, x2 = P.split(xf, 2, axis=-1)
        return P.cast(xf * cos + P.concat([-x2, x1], axis=-1) * sin,
                      x.dtype)

    lay = params["layers"]
    h = P.reshape(P.index_select(params["embedding"], P.reshape(ids, [-1])),
                  [B, T, -1])
    for i in range(args.num_layers):
        x = F.rms_norm(h, lay["ln1"][i], args.rms_eps)
        q = P.reshape(P.matmul(x, lay["wq"][i]), [B, T, nh, hd])
        k = P.reshape(P.matmul(x, lay["wk"][i]), [B, T, nkv, hd])
        v = P.reshape(P.matmul(x, lay["wv"][i]), [B, T, nkv, hd])
        o, _ = F.flash_attention(rope(q), rope(k), v, causal=True)
        h = h + P.matmul(P.reshape(o, [B, T, nh * hd]), lay["wo"][i])
        x = F.rms_norm(h, lay["ln2"][i], args.rms_eps)
        h = h + P.matmul(F.silu(P.matmul(x, lay["w_gate"][i]))
                         * P.matmul(x, lay["w_up"][i]), lay["w_down"][i])
    logits = P.cast(P.matmul(F.rms_norm(h, params["final_norm"],
                                        args.rms_eps), params["lm_head"]),
                    "float32")
    return F.cross_entropy(logits, labels)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _ops_dispatched(torch, fn):
    """(result of fn(), the aten ops it dispatched), counted by a
    TorchDispatchMode (every op torch runs for the call, forward and
    backward, below the Python surface)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, Count.n


def _busy_share(torch, dev, fn, n_steps=2, top=8):
    """(wall ms a step, device-busy ms a step, {group: busy ms a step},
    [(kernel, ms a step, launches a step)] of the `top` kernels by device
    time) of fn() under torch.profiler, or None when the profiler sees no
    device activity. The groups: matrix products (MATMUL_NAMES), B1-B3
    (names holding `flash_`), and the rest (norms, RoPE, casts, SwiGLU, CE, embedding)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if str(e.device_type).endswith("CUDA")
            and e.time_range.end > e.time_range.start]
    if not kern:
        return None
    per_name, groups = {}, {"matmul": 0.0, "B1-B3": 0.0, "rest": 0.0}
    for e in kern:
        us = e.time_range.end - e.time_range.start
        t, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (t + us, n + 1)
        g = ("B1-B3" if "flash_" in e.name else "matmul"
             if any(f in e.name for f in MATMUL_NAMES) else "rest")
        groups[g] += us
    busy = sum(groups.values())
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    return (wall_us / n_steps / 1e3, busy / n_steps / 1e3,
            {g: us / n_steps / 1e3 for g, us in groups.items()},
            [(name, us / n_steps / 1e3, n / n_steps)
             for name, (us, n) in ranked])


def phase_eager(torch, dev, warmup=2, steps=8):
    """The eager surface on the card: a to_tensor with no place lands on
    cuda:0; `eager_llama_loss` at Llama-2-7B width (2 layers, b 1, s 2048)
    against `forward_and_loss(remat=False)` on the same weights, f32 (loss
    and every grad leaf) and bf16 (loss); B1 launched >= L times in the
    forward, B2 and B3 >= L times in the backward, B9 >= 2L + 1 times in
    the forward (`F.rms_norm`) and B10 >= 2L + 1 in the backward, from the
    eager path.
    Then, in bf16, the eager step's ms (2 warm-up, `steps` synchronised),
    its aten ops and device-busy share, beside the functional path's.
    Returns the launch counts of the eager runs."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as device_mod
    from paddle_tpu_torch.models import LLAMA2_7B, init_params
    from paddle_tpu_torch.models import llama_functional as lf

    device_mod._current = None   # the default: no set_device
    placed = paddle.to_tensor([1.0, 2.0]).place
    log(f"[eager] paddle.to_tensor with no place and no set_device lands on "
        f"{placed}")
    if placed != torch.device("cuda", 0):
        raise AssertionError(f"eager: to_tensor landed on {placed}")
    args = LLAMA2_7B._replace(num_layers=EAGER_LEG["layers"])
    B, T = EAGER_LEG["batch"], EAGER_LEG["seq"]
    gen = torch.Generator(device=dev).manual_seed(0)
    base = init_params(args, gen, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(0)
    ids, labels = (torch.from_numpy(rng.integers(
        0, args.vocab_size, (B, T)).astype(np.int64)).to(dev)
        for _ in range(2))
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    norms = ("rms_norm_fwd", "rms_norm_bwd")
    total = {k: 0 for k in launch_counts()}
    readings = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        ref_tree = _tree_map(lambda t: t.detach().to(dtype)
                             .requires_grad_(True), base)
        ref = lf.forward_and_loss(ref_tree, ids, labels, args, remat=False)
        ref.backward()
        tree = _tree_map(lambda t: paddle.Tensor(t.detach().to(dtype),
                                                 stop_gradient=False), base)
        torch.cuda.synchronize(dev)
        reset_launches()
        loss = eager_llama_loss(paddle, tree, paddle.Tensor(ids),
                                paddle.Tensor(labels), args)
        torch.cuda.synchronize(dev)
        fwd = dict(launch_counts())
        loss.backward()
        torch.cuda.synchronize(dev)
        after = launch_counts()
        _add(total, after)
        bwd = {k: after[k] - fwd[k] for k in flash + norms}
        loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
        worst = ("", 0.0)
        for (path, t), (_, r) in zip(_leaves(tree), _leaves(ref_tree)):
            rel = ((t._data.grad.float() - r.grad.float()).norm()
                   / r.grad.float().norm()).item()
            if not math.isfinite(rel) or rel > worst[1]:
                worst = (path, rel)
        readings[dname] = (loss_rel, worst)
        log(f"[eager] Llama-2-7B width, {args.num_layers} layers, b {B} s "
            f"{T}, {dname}: eager loss {loss.item():.6f} vs forward_and_loss "
            f"{ref.item():.6f}, rel {loss_rel:.3e}; worst grad leaf "
            f"{worst[0]} ||d||/||ref|| {worst[1]:.3e}; B1 launches in the "
            f"forward {fwd['flash_fwd']}, B2/B3 in the backward "
            f"{bwd['flash_bwd_dq']}/{bwd['flash_bwd_dkv']}; B9 in the "
            f"forward {fwd['rms_norm_fwd']}, B10 in the backward "
            f"{bwd['rms_norm_bwd']}")
        L = args.num_layers
        if fwd["flash_fwd"] < L or bwd["flash_bwd_dq"] < L or \
                bwd["flash_bwd_dkv"] < L or fwd["flash_bwd_dq"] or \
                fwd["rms_norm_fwd"] < 2 * L + 1 or fwd["rms_norm_bwd"] or \
                bwd["rms_norm_bwd"] < 2 * L + 1:
            raise AssertionError(f"eager {dname}: launches forward {fwd}, "
                                 f"backward {bwd}")
        del ref_tree, ref, loss
        if dtype == torch.float32:
            del tree
    f32_rel, f32_worst = readings["float32"]
    bf_rel, bf_worst = readings["bfloat16"]
    log(f"[eager] bars: f32 loss rel {EAGER_BARS['loss_rel']}, worst grad "
        f"leaf {EAGER_BARS['grad_rel']}; bf16 loss rel "
        f"{EAGER_BF16_LOSS_REL} (its worst leaf {bf_worst[0]} "
        f"{bf_worst[1]:.3e}, recorded)")
    if not (f32_rel <= EAGER_BARS["loss_rel"]
            and f32_worst[1] <= EAGER_BARS["grad_rel"]
            and bf_rel <= EAGER_BF16_LOSS_REL):
        raise AssertionError(f"eager: f32 {readings['float32']}, bf16 "
                             f"{readings['bfloat16']}")

    # speed, bf16: the eager step beside the functional one, same weights
    ref_tree = _tree_map(lambda t: t.detach().requires_grad_(True),
                         _tree_map(lambda p: p._data, tree))
    pids, plabels = paddle.Tensor(ids), paddle.Tensor(labels)

    def eager_step():
        for _, t in _leaves(tree):
            t.clear_grad()
        eager_llama_loss(paddle, tree, pids, plabels, args).backward()

    def functional_step():
        for _, t in _leaves(ref_tree):
            t.grad = None
        lf.forward_and_loss(ref_tree, ids, labels, args,
                            remat=False).backward()

    rows = {}
    for label, step in (("eager", eager_step),
                        ("functional", functional_step)):
        for _ in range(warmup):
            step()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3 / steps
        _, n_ops = _ops_dispatched(torch, step)
        prof = _busy_share(torch, dev, step)
        rows[label] = (ms, n_ops, prof)
        STEP_MS[label] = ms
        busy = ("busy not measured: the profiler saw no device activity"
                if prof is None else
                f"profiled wall {prof[0]:.2f} ms, device busy {prof[1]:.2f} "
                f"ms ({prof[1] / prof[0]:.1%}): " + ", ".join(
                    f"{g} {v:.2f} ms" for g, v in prof[2].items()))
        log(f"[eager] bf16 {label} forward + backward: {ms:.2f} ms a step "
            f"(mean of {steps} synchronised after {warmup} warm-up); "
            f"{n_ops} aten ops dispatched a step; {busy}")
        if prof is not None:
            for name, kms, n in prof[3]:
                log(f"[eager]   {label} kernel {kms:.3f} ms in {n:g} "
                    f"launches a step: {name[:110]}")
    log(f"[eager] eager / functional step time "
        f"{rows['eager'][0] / rows['functional'][0]:.3f}x, aten ops "
        f"{rows['eager'][1]} vs {rows['functional'][1]}")
    device_mod._current = None
    return total


# the layers phase: the training API (ROADMAP A10b) on the card through
# the public surface: BASELINE config 1 (LeNet on the synthetic MNIST
# through `paddle.Model.fit`), the layer-built Llama at 7B width held to
# `forward_and_loss` on `params_from_layer` and trained by AdamW in f32 and
# under amp.decorate (O2, bf16), `nn.MultiHeadAttention` on B1-B3, and AMP
LENET_LEG = dict(batch=64, steps=30, lr=1e-3, workers=2)
LAYERS_LEG = dict(layers=2, batch=1, seq=2048, steps=3, lr=1e-4)
MHA_LEG = dict(width=4096, heads=32, seq=2048)


def _sync_ms(torch, dev, fn):
    """(fn(), its wall ms), synchronised on both sides."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _layers_lenet(torch, dev, paddle, tmp):
    """(a): LeNet `Model.fit` (batch 64, Adam 1e-3, 30 steps, 2 workers
    forked after CUDA is up); the fixed 32-sample loss before and after;
    the workers' batches against num_workers=0's; evaluate; a save/load
    round trip; the train step's ms, samples/s and host share."""
    import numpy as np
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    leg = LENET_LEG
    paddle.seed(0)
    train, test = MNIST(mode="train"), MNIST(mode="test")
    model = paddle.Model(LeNet())
    if {p.place for p in model.parameters()} != {dev}:
        raise AssertionError("layers: LeNet's parameters are not on the card")
    model.prepare(paddle.optimizer.Adam(learning_rate=leg["lr"],
                                        parameters=model.parameters()),
                  nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    x0 = paddle.to_tensor(np.stack([train[i][0] for i in range(32)]))
    y0 = paddle.to_tensor(np.stack([train[i][1] for i in range(32)]))

    def fixed_loss():
        with paddle.no_grad():
            return float(nn.CrossEntropyLoss()(model.network(x0), y0))

    batches = {}
    for w in (0, leg["workers"]):
        loader = paddle.io.DataLoader(train, batch_size=leg["batch"],
                                      num_workers=w)
        batches[w] = [[t.numpy() for t in b] for b in loader]
    same = len(batches[0]) == len(batches[leg["workers"]]) and all(
        np.array_equal(a, b) for ra, rb in zip(batches[0],
                                               batches[leg["workers"]])
        for a, b in zip(ra, rb))
    init = fixed_loss()
    t0 = time.perf_counter()
    model.fit(train, batch_size=leg["batch"], epochs=1,
              num_iters=leg["steps"], num_workers=leg["workers"], verbose=0)
    torch.cuda.synchronize(dev)
    fit_s = time.perf_counter() - t0
    final = fixed_loss()
    mon = model._monitor
    ev = model.evaluate(test, batch_size=leg["batch"], verbose=0)
    path = os.path.join(tmp, "lenet")
    model.save(path)
    other = paddle.Model(LeNet())
    other.prepare(paddle.optimizer.Adam(parameters=other.parameters()),
                  nn.CrossEntropyLoss())
    other.load(path)
    other._optimizer.set_state_dict(paddle.load(path + ".pdopt"))
    round_trip = all(np.array_equal(a, b) for a, b in zip(
        model.predict_batch([x0]), other.predict_batch([x0])))
    log(f"[layers] (a) LeNet Model.fit on the synthetic MNIST: "
        f"{mon.steps} steps of batch {leg['batch']}, Adam "
        f"{leg['lr']}, {leg['workers']} workers forked after CUDA was up, "
        f"in {fit_s:.2f} s; the fixed 32-sample loss {init:.4f} -> "
        f"{final:.4f} (falls: {final < init}; the verify skill's bar < 0.1 "
        f"in 30 steps: {final < 0.1}); last batch loss "
        f"{mon.last.get('loss', float('nan')):.4f}; {leg['workers']} "
        f"workers' batches equal num_workers=0's in order: {same} "
        f"({len(batches[0])} batches); evaluate on {len(test)} test "
        f"samples: loss {ev['loss']:.4f}, acc {float(ev['acc']):.4f}; "
        f"save/load round trip gives equal eval outputs: {round_trip}")
    if not (final < init and same and round_trip and mon.steps ==
            leg["steps"]):
        raise AssertionError(f"layers (a): loss {init} -> {final}, batches "
                             f"equal {same}, round trip {round_trip}")

    # speed: train_batch on device batches held ready (what fit runs a step)
    xs = [paddle.to_tensor(b[0]) for b in batches[0][:12]]
    ys = [paddle.to_tensor(b[1]) for b in batches[0][:12]]
    for i in range(2):
        model.train_batch([xs[i]], [ys[i]])
    _, ms = _sync_ms(torch, dev, lambda: [model.train_batch([xs[i]],
                                                            [ys[i]])
                                          for i in range(2, 12)])
    step_ms = ms / 10
    prof = _busy_share(torch, dev, lambda: model.train_batch(
        [xs[2]], [ys[2]]), n_steps=2)
    host = ("host share not measured: the profiler saw no device activity"
            if prof is None else
            f"profiled wall {prof[0]:.3f} ms a step, device busy "
            f"{prof[1]:.3f} ms: host share {1 - prof[1] / prof[0]:.1%}")
    log(f"[layers] (a) LeNet train step (batch {leg['batch']}, f32, "
        f"forward + backward + Adam + the loss read back): {step_ms:.3f} ms "
        f"(mean of 10 synchronised after 2 warm-up), "
        f"{leg['batch'] / step_ms * 1e3:.0f} samples/s; {host}")


def _layers_llama(torch, dev, paddle):
    """(b): the layer-built Llama at 7B width (2 layers, b 1, s 2048, f32
    from seed 0) against `forward_and_loss` on `params_from_layer`, its
    launches, then AdamW steps in f32 and under amp.decorate (O2, bf16,
    f32 masters). Returns the launch counts of the checked run."""
    import numpy as np
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         params_from_layer)
    from paddle_tpu_torch.models import llama_functional as lf

    leg = LAYERS_LEG
    L, B, T = leg["layers"], leg["batch"], leg["seq"]
    paddle.seed(0)
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=L)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg)
    n_params = sum(p.size for p in model.parameters())
    rng = np.random.default_rng(0)
    ids_np, labels_np = (rng.integers(0, cfg.vocab_size, (B, T)).astype(
        np.int64) for _ in range(2))
    ids, labels = paddle.to_tensor(ids_np), paddle.to_tensor(labels_np)
    tree = _tree_map(lambda t: t.clone().requires_grad_(True),
                     params_from_layer(model))
    args = lf.LlamaArgs.from_config(cfg)
    ref = lf.forward_and_loss(tree, ids._data, labels._data, args,
                              remat=False)
    ref.backward()
    torch.cuda.synchronize(dev)
    reset_launches()
    loss = model(ids, labels=labels)
    torch.cuda.synchronize(dev)
    fwd = dict(launch_counts())
    loss.backward()
    torch.cuda.synchronize(dev)
    after = launch_counts()
    total = dict(after)
    bwd = {k: after[k] - fwd[k] for k in after}
    loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
    core = model.model
    got = {"embedding": core.embed_tokens.weight.grad._data,
           "final_norm": core.norm.weight.grad._data,
           "lm_head": model.lm_head.weight.grad._data,
           "layers": {k: torch.stack([g(l).grad._data for l in core.layers])
                      for k, g in (
                          ("wq", lambda l: l.self_attn.q_proj.weight),
                          ("wk", lambda l: l.self_attn.k_proj.weight),
                          ("wv", lambda l: l.self_attn.v_proj.weight),
                          ("wo", lambda l: l.self_attn.o_proj.weight),
                          ("w_gate", lambda l: l.mlp.gate_proj.weight),
                          ("w_up", lambda l: l.mlp.up_proj.weight),
                          ("w_down", lambda l: l.mlp.down_proj.weight),
                          ("ln1", lambda l: l.input_layernorm.weight),
                          ("ln2", lambda l:
                           l.post_attention_layernorm.weight))}}
    worst = ("", 0.0)
    for (path, g), (_, r) in zip(_leaves(got), _leaves(tree)):
        rel = ((g.float() - r.grad).norm() / r.grad.norm()).item()
        if not math.isfinite(rel) or rel > worst[1]:
            worst = (path, rel)
    want = {"flash_fwd": (L, 0), "flash_bwd_dq": (0, L),
            "flash_bwd_dkv": (0, L), "rms_norm_fwd": (2 * L + 1, 0),
            "rms_norm_bwd": (0, 2 * L + 1)}
    counts = {k: (fwd[k], bwd[k]) for k in want}
    log(f"[layers] (b) LlamaForCausalLM(LlamaConfig.llama2_7b("
        f"num_hidden_layers={L})), {n_params / 1e9:.3f} B parameters from "
        f"seed 0 in {time.perf_counter() - t0:.1f} s, b {B} s {T}, f32: "
        f"loss {loss.item():.6f} vs forward_and_loss on params_from_layer "
        f"{ref.item():.6f}, rel {loss_rel:.3e} (bar "
        f"{EAGER_BARS['loss_rel']}); worst grad leaf {worst[0]} "
        f"||d||/||ref|| {worst[1]:.3e} (bar {EAGER_BARS['grad_rel']}); "
        f"launches (forward, backward) from the nn.Layers {counts}, want "
        f"{want}")
    if loss_rel > EAGER_BARS["loss_rel"] or \
            worst[1] > EAGER_BARS["grad_rel"] or counts != want:
        raise AssertionError(f"layers (b): loss rel {loss_rel}, worst "
                             f"{worst}, launches {counts}")
    del tree, ref, got, loss
    torch.cuda.empty_cache()

    def train(opt, label):
        losses, steps, opt_ms = [], [], []
        for _ in range(leg["steps"]):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            loss = model(ids, labels=labels)
            loss.backward()
            _, oms = _sync_ms(torch, dev, opt.step)
            opt.clear_grad()
            losses.append(loss.item())
            steps.append((time.perf_counter() - t0) * 1e3)
            opt_ms.append(oms)
        falls = all(b < a for a, b in zip(losses, losses[1:]))
        log(f"[layers] (b) {label}: {leg['steps']} AdamW steps (lr "
            f"{leg['lr']}), losses {[round(x, 6) for x in losses]} (falls "
            f"each step: {falls}); step ms (forward + backward + AdamW, "
            f"synchronised) {[round(x, 2) for x in steps]}, of which the "
            f"optimizer {[round(x, 2) for x in opt_ms]} "
            f"({opt_ms[-1] / steps[-1]:.1%} of the last step); peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
        if not falls:
            raise AssertionError(f"layers (b) {label}: losses {losses}")
        return steps[-1], opt_ms[-1]

    torch.cuda.reset_peak_memory_stats(dev)
    opt = paddle.optimizer.AdamW(leg["lr"], parameters=model.parameters())
    f32 = train(opt, "f32, from seed 0")
    del opt, model
    torch.cuda.empty_cache()
    paddle.seed(0)   # the bf16 leg starts from the f32 leg's weights
    model = LlamaForCausalLM(cfg)
    opt = paddle.optimizer.AdamW(leg["lr"], parameters=model.parameters(),
                                 multi_precision=True)
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     dtype="bfloat16", master_weight=True)
    if {p.dtype for p in model.parameters()} != {paddle.bfloat16}:
        raise AssertionError("layers (b): decorate left a non-bf16 weight")
    PEAK_SEEN.append(torch.cuda.max_memory_allocated(dev))
    torch.cuda.reset_peak_memory_stats(dev)
    bf16 = train(opt, "amp.decorate O2 bf16, f32 masters, from seed 0")
    log(f"[layers] (b) the last step: f32 {f32[0]:.2f} ms (AdamW "
        f"{f32[1]:.2f} ms), bf16 {bf16[0]:.2f} ms (AdamW {bf16[1]:.2f} ms), "
        f"beside the eager phase's bf16 forward + backward (PERF.md §5)")
    PEAK_SEEN.append(torch.cuda.max_memory_allocated(dev))
    return total


def _layers_mha(torch, dev, paddle):
    """(c): nn.MultiHeadAttention at width 4096, 32 heads, s 2048, bf16:
    forward and backward launch B1-B3 once each. The attention output (the
    out projection's input) is held, head_dim vector by head_dim vector,
    to B1's bar against B1's plain version (`flash_fwd_plain`) on the q, k
    and v the layer's projections gave it; beside it (recorded) the layer
    run with the route's predicate false, whose plain softmax(QK^T)V
    rounds P to bf16 before P·V."""
    import numpy as np
    from paddle_tpu_torch.kernels import flash_attention as fa

    leg = MHA_LEG
    hd = leg["width"] // leg["heads"]
    paddle.seed(1)
    mha = paddle.nn.MultiHeadAttention(leg["width"], leg["heads"]).to(
        dtype="bfloat16")
    rng = np.random.default_rng(1)
    x = paddle.to_tensor(rng.standard_normal(
        (1, leg["seq"], leg["width"])).astype(np.float32)).astype("bfloat16")
    x.stop_gradient = False
    seen = {}

    def keep(name):
        return lambda layer, ins, out: seen.setdefault(
            name, []).append(out._data.detach().unflatten(-1, (-1, hd)))

    hooks = [getattr(mha, f"{n}_proj").register_forward_post_hook(keep(n))
             for n in "qkv"]
    hooks.append(mha.out_proj.register_forward_pre_hook(
        lambda layer, ins: seen.setdefault("attn", []).append(
            ins[0]._data.detach().unflatten(-1, (-1, hd)))))
    reset_launches()
    out = mha(x)
    torch.cuda.synchronize(dev)
    fwd = dict(launch_counts())
    out.astype("float32").sum().backward()
    torch.cuda.synchronize(dev)
    total = dict(launch_counts())
    try:
        with plain_route(), paddle.no_grad():
            mha(x)
    finally:
        for h in hooks:
            h.remove()
    q, k, v = (seen[n][0] for n in "qkv")
    ref = fa.flash_fwd_plain(q, k, v, False)[0]
    ratio = flash_row_ratio(torch, seen["attn"][0], ref, TOL["bfloat16"])
    route = flash_row_ratio(torch, seen["attn"][0], seen["attn"][1],
                            TOL["bfloat16"])
    plains = flash_row_ratio(torch, seen["attn"][1], ref, TOL["bfloat16"])
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    got = {k: (fwd[k], total[k] - fwd[k]) for k in flash}
    log(f"[layers] (c) nn.MultiHeadAttention({leg['width']}, "
        f"{leg['heads']}) bf16, s {leg['seq']}: launches (forward, "
        f"backward) {got}; the attention output against B1's plain "
        f"version on the layer's q/k/v: worst head_dim vector {ratio:.3f} "
        f"of B1's bar ({TOL['bfloat16']}); against the layer run with the "
        f"route's predicate false {route:.3f} of the bar, that run against "
        f"B1's plain version {plains:.3f} (both recorded)")
    if got != {"flash_fwd": (1, 0), "flash_bwd_dq": (0, 1),
               "flash_bwd_dkv": (0, 1)} or not ratio <= 1.0:
        raise AssertionError(f"layers (c): launches {got}, ratio {ratio}")
    return total


def _layers_amp(torch, dev, paddle):
    """(d): auto_cast makes `paddle.matmul` bf16, keeps `F.softmax` f32
    and hands B1 bf16 from f32 q/k/v; a float16 GradScaler over an fp16
    Linear and `nn.RMSNorm` (B9 and B10 once each, in fp16) skips a step
    with a planted inf and halves its scale. Returns the fp16 step's
    launch counts."""
    import numpy as np

    a = paddle.randn([64, 64])
    q = paddle.randn([1, 256, 4, 128])                   # f32, B1's gate
    reset_launches()
    with paddle.amp.auto_cast():
        mm = paddle.matmul(a, a).dtype
        sm = paddle.nn.functional.softmax(a).dtype
        fl = paddle.nn.functional.flash_attention(q, q, q, causal=True)[0]
    b1 = launch_counts()["flash_fwd"]
    lin = paddle.nn.Linear(64, 64).to(dtype="float16")
    norm = paddle.nn.RMSNorm(64).to(dtype="float16")
    opt = paddle.optimizer.SGD(0.1, parameters=lin.parameters())
    scaler = paddle.amp.GradScaler(init_loss_scaling=1024.0)
    x = paddle.randn([8, 64]).astype("float16")
    reset_launches()
    scaler.scale(norm(lin(x)).astype("float32").mean()).backward()
    counts = all_counts()
    norms = (counts["rms_norm_fwd_f16"], counts["rms_norm_bwd_f16"])
    g = lin.weight.grad.numpy().copy()
    g[0, 0] = np.inf
    lin.weight.grad = paddle.to_tensor(g)
    w0 = lin.weight.numpy().copy()
    scaler.step(opt)
    skipped = np.array_equal(lin.weight.numpy(), w0)
    log(f"[layers] (d) under auto_cast paddle.matmul gives {mm}, F.softmax "
        f"{sm}, F.flash_attention on f32 q/k/v {fl.dtype} with {b1} B1 "
        f"launch; GradScaler(float16, 1024) over an fp16 Linear and "
        f"RMSNorm (B9, B10 in fp16: {norms}) with an inf planted: step "
        f"skipped {skipped}, scale -> {scaler._scale}")
    if mm != paddle.bfloat16 or sm != paddle.float32 or not skipped or \
            fl.dtype != paddle.bfloat16 or b1 != 1 or \
            scaler._scale != 512.0 or norms != (1, 1) or \
            not np.isfinite(norm.weight.grad.numpy()).all():
        raise AssertionError(f"layers (d): {mm}, {sm}, {fl.dtype}, B1 {b1}, "
                             f"skipped {skipped}, scale {scaler._scale}, "
                             f"fp16 B9/B10 {norms}")
    return counts


def phase_layers(torch, dev):
    """The training API on the card (see LENET_LEG, LAYERS_LEG, MHA_LEG):
    (a) LeNet `Model.fit`, (b) the layer-built Llama at 7B width, (c)
    `nn.MultiHeadAttention`, (d) AMP. Returns the launch counts of (b)'s
    checked run, (c)'s and (d)'s fp16 step."""
    import shutil
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as device_mod

    device_mod._current = None   # the default: the card, no set_device
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="layers_")
    try:
        _layers_lenet(torch, dev, paddle, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = _layers_llama(torch, dev, paddle)
    torch.cuda.empty_cache()
    _add(total, _layers_mha(torch, dev, paddle))
    _add(total, _layers_amp(torch, dev, paddle))
    torch.cuda.empty_cache()
    log(f"[layers] the phase took {time.perf_counter() - t0:.1f} s")
    return total


# the dist phase: the process layer of paddle.distributed and the fleet
# entry at world size 1 on NCCL, and the layer Llama of LAYERS_LEG trained
# plain, through paddle.DataParallel and through fleet
DIST_WAYS = ("plain", "DataParallel", "fleet")


def _dist_collectives(torch, dev, dist):
    """Each collective of `communication` on a CUDA tensor at world size 1,
    against its definition there (the input itself, bit for bit). Point to
    point needs a peer: it is held on the CPU only, by the 2-rank gloo
    tests (tests/test_torch_collectives.py)."""
    import paddle_tpu_torch as paddle

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4, 6, device=dev, generator=g)
    held = []

    def same(name, got, want=None):
        got = got._data if hasattr(got, "_data") else got
        want = x if want is None else want
        if got.device != x.device or not torch.equal(got, want):
            raise AssertionError(f"dist: {name} on {got.device} is not its "
                                 "definition at world size 1")
        held.append(name)

    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        t = paddle.to_tensor(x)
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
        same(f"all_reduce({op})", t)
    t = paddle.to_tensor(x)
    task = dist.all_reduce(t, sync_op=False)
    same("all_reduce(sync_op=False).wait()", task.wait())
    out = []
    dist.all_gather(out, paddle.to_tensor(x))
    same("all_gather(list)", out[0])
    same("all_gather(tiled)", dist.all_gather(paddle.to_tensor(x)))
    for form, inp in (("tensor", paddle.to_tensor(x)),
                      ("list", [paddle.to_tensor(x)])):
        t = paddle.to_tensor(torch.zeros_like(x))
        dist.reduce_scatter(t, inp)
        same(f"reduce_scatter({form})", t)
    t = paddle.to_tensor(x)
    dist.broadcast(t, src=0)
    same("broadcast", t)
    t = paddle.to_tensor(torch.zeros_like(x))
    dist.scatter(t, [paddle.to_tensor(x)], src=0)
    same("scatter", t)
    t = paddle.to_tensor(x)
    dist.reduce(t, dst=0)
    same("reduce", t)
    out = []
    dist.alltoall(out, [paddle.to_tensor(x)])
    same("alltoall", out[0])
    t = paddle.to_tensor(torch.zeros_like(x))
    dist.alltoall_single(t, paddle.to_tensor(x))
    same("alltoall_single", t)
    gl = []
    dist.gather(paddle.to_tensor(x), gl, dst=0)
    same("gather", gl[0])
    dist.barrier()
    objs = []
    dist.all_gather_object(objs, {"rank": 0})
    blist = ["a", 1]
    dist.broadcast_object_list(blist, src=0)
    sc = []
    dist.scatter_object_list(sc, [{"to": 0}], src=0)
    if objs != [{"rank": 0}] or blist != ["a", 1] or sc != [{"to": 0}]:
        raise AssertionError(f"dist: object collectives {objs} {blist} {sc}")
    held += ["barrier", "all_gather_object", "broadcast_object_list",
             "scatter_object_list"]
    return held


def _dist_llama(torch, dev, paddle, way, ids, labels):
    """LAYERS_LEG's Llama from seed 0, AdamW, leg["steps"] steps one `way`:
    (losses, [launches a step], [ms a step], final parameters, the
    reducer's figures or None). The model, its optimizer and its reducer
    are freed before it returns."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    leg = LAYERS_LEG
    paddle.seed(0)
    model = LlamaForCausalLM(LlamaConfig.llama2_7b(
        num_hidden_layers=leg["layers"]))
    opt = paddle.optimizer.AdamW(leg["lr"], parameters=model.parameters())
    net = model
    if way == "DataParallel":
        net = paddle.DataParallel(model)
    elif way == "fleet":
        fleet.init(is_collective=True)
        net = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(opt)
        if net is not model:
            raise AssertionError("dist: fleet.distributed_model at one rank "
                                 "must return the model itself")
    losses, counts, ms = [], [], []
    for _ in range(leg["steps"]):
        torch.cuda.synchronize(dev)
        reset_launches()
        t0 = time.perf_counter()
        loss = net(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        counts.append({k: v for k, v in launch_counts().items() if v})
        losses.append(loss.item())
    params = [p._data.detach().clone() for p in model.parameters()]
    figures = None
    if way == "DataParallel":
        r = net._reducer
        figures = {"buckets": len(r.buckets), "params": len(r.params),
                   "all_reduces": r.all_reduces, "reduced": len(r.reduced)}
    del net, model, opt
    return losses, counts, ms, params, figures


def phase_dist(torch, dev):
    """`paddle.distributed` at world size 1 on NCCL (ROADMAP A9a and A9b's
    base): `init_parallel_env()` with no set_device takes the card and
    NCCL; every collective on a CUDA tensor against its definition; then
    the layer Llama of LAYERS_LEG (7B width, 2 layers, b 1 s 2048, f32,
    seed 0, AdamW, 3 steps) (a) plain, (b) through `paddle.DataParallel`,
    (c) through `fleet.init` / `distributed_model` /
    `distributed_optimizer`: (b) and (c) give (a)'s losses and parameters
    bit for bit and its launches a step of B1-B3 and B9/B10, nonzero; (b)'s
    reducer saw every parameter and made its bucket count of all-reduces a
    step. Returns (b)'s launch counts."""
    import numpy as np

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import device as device_mod

    device_mod._current = None   # the default: the card, no set_device
    for k in ("PADDLE_MASTER", "PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID"):
        os.environ.pop(k, None)
    t0 = time.perf_counter()
    env = dist.init_parallel_env()
    backend = dist.get_backend()
    log(f"[dist] init_parallel_env(): backend {backend}, rank {env.rank} "
        f"of {env.world_size}, device {env.device_type}:{env.dev_id}")
    if backend != "NCCL" or env.world_size != 1 or env.device_type != "gpu":
        raise AssertionError(f"dist: init_parallel_env gave {backend}, "
                             f"world {env.world_size}, {env.device_type}")
    held = _dist_collectives(torch, dev, dist)
    log(f"[dist] {len(held)} collectives on cuda:0 equal their definition at "
        f"world size 1, bit for bit: {', '.join(held)}; send/recv, isend/"
        "irecv and batch_isend_irecv need a peer and are held on the CPU "
        "only (2 gloo ranks, tests/test_torch_collectives.py)")

    leg = LAYERS_LEG
    L = leg["layers"]
    want = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "rms_norm_fwd": 2 * L + 1, "rms_norm_bwd": 2 * L + 1}
    from paddle_tpu_torch.models import LlamaConfig

    vocab = LlamaConfig.llama2_7b(num_hidden_layers=L).vocab_size
    rng = np.random.default_rng(0)
    ids, labels = (paddle.to_tensor(rng.integers(
        0, vocab, (leg["batch"], leg["seq"])).astype(np.int64))
        for _ in range(2))
    plain, ms_of, total = None, {}, {k: 0 for k in launch_counts()}
    for way in DIST_WAYS:
        torch.cuda.reset_peak_memory_stats(dev)
        losses, counts, ms, params, red = _dist_llama(
            torch, dev, paddle, way, ids, labels)
        extra = ""
        if red is not None:
            extra = (f"; reducer: {red['buckets']} buckets over "
                     f"{red['params']} parameters, {red['all_reduces']} "
                     f"all-reduces, {red['reduced']} parameters reduced")
        log(f"[dist] ({way}) losses {losses}; step ms (forward + backward + "
            f"AdamW, synchronised) {[round(x, 2) for x in ms]}; launches a "
            f"step {counts[-1]}; peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB{extra}")
        PEAK_SEEN.append(torch.cuda.max_memory_allocated(dev))
        ms_of[way] = ms
        if plain is None:   # (a): the later ways are held to it
            plain = (losses, counts, params)
        else:
            same_params = all(torch.equal(p, q)
                              for p, q in zip(params, plain[2]))
            kernels = [{k: c.get(k, 0) for k in want} for c in counts]
            if losses != plain[0] or not same_params or \
                    counts != plain[1] or any(k != want for k in kernels):
                raise AssertionError(
                    f"dist ({way}): losses {losses} vs {plain[0]}, "
                    f"parameters bit for bit {same_params}, launches "
                    f"{counts} vs {plain[1]} (want {want} a step)")
        if red is not None:
            if red["reduced"] != red["params"] or \
                    red["params"] != len(plain[2]) or \
                    red["all_reduces"] != leg["steps"] * red["buckets"]:
                raise AssertionError(
                    f"dist ({way}): reducer reduced {red['reduced']} of "
                    f"{len(plain[2])} parameters, {red['all_reduces']} "
                    f"all-reduces for {red['buckets']} buckets")
            for c in counts:
                _add(total, c)
        params = None
        torch.cuda.empty_cache()
    log(f"[dist] (DataParallel) and (fleet) equal (plain) bit for bit: "
        f"losses, {len(plain[2])} parameters, launches a step {want}; last "
        f"step ms plain {ms_of['plain'][-1]:.2f}, DataParallel "
        f"{ms_of['DataParallel'][-1]:.2f}, fleet {ms_of['fleet'][-1]:.2f}")
    plain = None
    fleet._reset_for_tests()
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"[dist] the phase took {time.perf_counter() - t0:.1f} s")
    return total


# the configs phase: BASELINE configs 3 and 2 on one card through the
# public API (the `distributed.Engine` over BERT-base, `Model.fit` over
# ResNet-50), B1-B3 from BERT's and ViT-B/16's layers, B4/B5 from GPT-2's
# layer weights through `gpt_params_from_layer`, and vision.ops on the card
CONFIG3_LEG = dict(batch=64, seq=128, warmup=3, steps=16, lr=5e-5,
                   repro_steps=4)            # bench.py:1399 _bench_bert_zero2
FINETUNE_LEG = dict(batch=64, seq=128, warmup=2, steps=8, lr=5e-5)
CONFIG2_LEG = dict(batch=64, size=224, warmup=4, iters=24,
                   lr=1e-2)                  # bench.py:1350 _bench_resnet_fit
VIT_LEG = dict(batch=8, size=224, classes=1000)
GPT_LEG = dict(prompts=(16, 32, 48, 64), new=32, batch=8, seq=1024,
               steps=3, lr=1e-4)
CARD_CPU_RTOL = 1e-4
ROUTE_RTOL = 1e-2
RESNET50_FWD_FLOPS = 4.089e9                 # bench.py: an image at 224^2


def _bert_batch(np, cfg, batch, seq, seed=0):
    """bench.py:1409-1414: random ids, zero token types, MLM labels at 15%
    (the token itself), NSP labels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (batch, seq)).astype("int64")
    tt = np.zeros((batch, seq), "int64")
    mlm = np.where(rng.random((batch, seq)) < 0.15, ids,
                   -100).astype("int64")
    nsp = rng.integers(0, 2, (batch,)).astype("int64")
    return [ids, tt], [mlm, nsp]


def _n_params(model):
    return sum(int(p.size) for p in model.parameters())


def _rel(torch, a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _engine_steps(torch, dev, eng, inputs, labels, warmup, steps):
    """(losses of every step, ms a timed step): `warmup` then `steps`
    synchronised train_batch calls."""
    losses = [float(eng.train_batch(inputs, labels)) for _ in range(warmup)]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    timed = [eng.train_batch(inputs, labels) for _ in range(steps)]
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return losses + [float(l) for l in timed], ms


def _configs_bert(torch, dev, paddle, peak):
    """(a) config 3 in f32 and O1, its reproducibility, eval_batch's B1
    launches and bert_tiny card against CPU; (b) the fine-tune on B1-B3.
    Returns the launch counts of the checked runs."""
    import numpy as np
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.models import (BertPretrainingLoss, bert_base,
                                         bert_tiny)
    from paddle_tpu_torch.models.weights import layer_from_numpy

    leg = CONFIG3_LEG
    B, S = leg["batch"], leg["seq"]
    total = {k: 0 for k in launch_counts()}

    def engine(model, **kw):
        opt = paddle.optimizer.AdamW(leg["lr"],
                                     parameters=model.parameters())
        return Engine(model, loss=BertPretrainingLoss(), optimizer=opt,
                      dp=1, sharding_stage=2, **kw)

    paddle.seed(0)
    model = bert_base()
    n = _n_params(model)
    inputs, labels = _bert_batch(np, model.bert.config, B, S)
    rec = {}
    for amp in (None, "O1"):
        eng = engine(model, amp_level=amp)
        losses, ms = _engine_steps(torch, dev, eng, inputs, labels,
                                   leg["warmup"], leg["steps"])
        tps = B * S / ms * 1e3
        rec[amp or "f32"] = (losses, ms, tps, 6 * n * tps / peak)
        timed = losses[leg["warmup"]:]
        if not all(math.isfinite(x) for x in losses) or \
                not timed[-1] < timed[0]:
            raise AssertionError(f"configs (a) {amp}: losses {losses}")
        prof = _busy_share(torch, dev, lambda: eng.train_batch(inputs,
                                                               labels))
        log(f"[configs] (a) config 3 {amp or 'f32'}, a profiled step: " + (
            "the profiler saw no device activity" if prof is None else
            f"wall {prof[0]:.2f} ms, device busy {prof[1]:.2f} ms (host "
            f"share {1 - prof[1] / prof[0]:.1%}); busy by group "
            f"{ {g: round(v, 2) for g, v in prof[2].items()} }; top kernels "
            f"(ms, launches a step) "
            f"{[(n[:48], round(t, 2), c) for n, t, c in prof[3]]}"))
        if amp is None:
            # two runs from seed 0 (dropout from the engine's generator),
            # deterministic kernels: equal losses
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                rep = [[float(e.train_batch(inputs, labels))
                        for _ in range(leg["repro_steps"])]
                       for e in (engine(model), engine(model))]
            finally:
                torch.use_deterministic_algorithms(False)
            if rep[0] != rep[1]:
                raise AssertionError(f"configs (a): seed 0 twice gives "
                                     f"{rep}")
            reset_launches()
            with flash_calls() as seen:
                ev = float(eng.eval_batch(inputs, labels))
            torch.cuda.synchronize(dev)
            ev_launch = dict(launch_counts())
            _add(total, ev_launch)
            flash_path_check(torch, seen, "(a) eval_batch, config 3 f32")
            seen = None
            want = model.bert.config.num_hidden_layers
            if ev_launch["flash_fwd"] != want or \
                    ev_launch["flash_bwd_dq"] or ev_launch["flash_bwd_dkv"]:
                raise AssertionError(f"configs (a): eval_batch launches "
                                     f"{ev_launch}, want B1 {want}")
        eng = None
    for k, (losses, ms, tps, mfu) in rec.items():
        log(f"[configs] (a) config 3: bert_base() ({n / 1e6:.1f} M "
            f"parameters, dropout 0.1) through Engine(dp=1, "
            f"sharding_stage=2), AdamW {leg['lr']}, b {B} s {S}, {k}"
            f"{' (TF32 off)' if k == 'f32' else ' (bf16 autocast)'}: "
            f"losses {[round(x, 4) for x in losses]} (finite, the timed "
            f"ones fall); step {ms:.2f} ms (mean of {leg['steps']} after "
            f"{leg['warmup']} warm-up), {tps:.0f} tokens/s, MFU {mfu:.4f} "
            f"(6 N tokens/s over the bf16 peak)")
    log(f"[configs] (a) two Engines from seed 0, deterministic kernels: "
        f"{leg['repro_steps']} equal losses {[round(x, 6) for x in rep[0]]};"
        f" eval_batch {ev:.4f} launched {ev_launch}")

    # bert_tiny, card against CPU: 3 steps in f32, losses and parameters
    paddle.seed(0)
    tiny = bert_tiny()
    state = {k: v.numpy() for k, v in tiny.state_dict().items()}
    steps = 3
    with on_cpu(paddle):
        cpu_model = layer_from_numpy(bert_tiny(), state)
        cpu_eng = engine(cpu_model)
        tin, tlab = _bert_batch(np, tiny.bert.config, 8, 64, seed=1)
        cpu_losses = [float(cpu_eng.train_batch(tin, tlab))
                      for _ in range(steps)]
        cpu_eng.sync_to_model()
    card_eng = engine(tiny)
    card_losses = [float(card_eng.train_batch(tin, tlab))
                   for _ in range(steps)]
    card_eng.sync_to_model()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                      cpu_losses))
    pairs = list(zip(tiny.named_parameters(), cpu_model.named_parameters()))
    finite = all(math.isfinite(x) for x in card_losses + cpu_losses) and \
        all(bool(torch.isfinite(p._data).all() and
                 torch.isfinite(q._data).all()) for (_, p), (_, q) in pairs)
    worst = max((_rel(torch, p._data, q._data), k) for (k, p), (_, q) in
                pairs if not k.endswith("k_proj.bias"))
    # a key bias has a zero true gradient (the softmax ignores a constant
    # added to a row's logits), so each side carries its own rounding noise,
    # which AdamW scales to up to lr a step: it is held on each side within
    # what the steps can move it (adam_reach, plus the decoupled decay)
    opt = card_eng.optimizer
    reach = adam_reach(steps, opt._beta1, opt._beta2)
    moved, bias_bar = 0.0, 0.0
    for (k, p), (_, q) in pairs:
        if k.endswith("k_proj.bias"):
            p0 = torch.as_tensor(state[k]).double()
            top = float(p0.abs().max()) + reach * leg["lr"]
            bias_bar = leg["lr"] * (reach + steps * (opt._wd or 0.0) * top) \
                * (1 + CARD_CPU_RTOL)
            moved = max(moved, *(float((x.detach().double().cpu() - p0).abs()
                                       .max()) for x in (p._data, q._data)))
    log(f"[configs] (a) bert_tiny through the Engine, {steps} f32 steps on "
        f"the card against the CPU: losses "
        f"{[round(x, 6) for x in card_losses]} vs "
        f"{[round(x, 6) for x in cpu_losses]}, worst rel {loss_rel:.2e};"
        f" worst parameter after sync_to_model {worst[1]} ||d||/||cpu|| "
        f"{worst[0]:.2e} (bar {CARD_CPU_RTOL}); losses and parameters "
        f"finite {finite}; the key biases moved at most {moved:.3e} from "
        f"their start on either side (bar {bias_bar:.3e}, AdamW's reach)")
    if not finite or not loss_rel <= CARD_CPU_RTOL or \
            not worst[0] <= CARD_CPU_RTOL or not moved <= bias_bar:
        raise AssertionError(f"configs (a) card vs CPU: finite {finite}, "
                             f"{loss_rel}, {worst}, {moved}")
    model = eng = card_eng = None
    torch.cuda.empty_cache()
    _add(total, _configs_finetune(torch, dev, paddle, peak))
    return total


def _configs_finetune(torch, dev, paddle, peak):
    """(b) bert_base(hidden_dropout_prob=0.0), no mask, Engine under O2:
    B1 L launches a forward, B2/B3 L a backward; the first step's loss
    against the same step with the route's predicate false."""
    import numpy as np
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.models import BertPretrainingLoss, bert_base

    leg = FINETUNE_LEG
    B, S = leg["batch"], leg["seq"]
    paddle.seed(0)
    model = bert_base(hidden_dropout_prob=0.0)
    L = model.bert.config.num_hidden_layers
    n = _n_params(model)
    inputs, labels = _bert_batch(np, model.bert.config, B, S, seed=2)

    def engine():
        opt = paddle.optimizer.AdamW(leg["lr"],
                                     parameters=model.parameters())
        return Engine(model, loss=BertPretrainingLoss(), optimizer=opt,
                      dp=1, amp_level="O2")

    eng = engine()
    reset_launches()
    with flash_calls() as seen:
        first = float(eng.train_batch(inputs, labels))
    torch.cuda.synchronize(dev)
    step = dict(launch_counts())
    flash_path_check(torch, seen, "(b) the fine-tune's first step, O2")
    seen = None
    with plain_route():
        plain = float(engine().train_batch(inputs, labels))
    want = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    got = {k: step[k] for k in want}
    rel = abs(first - plain) / abs(plain)
    losses, ms = _engine_steps(torch, dev, eng, inputs, labels,
                               leg["warmup"], leg["steps"])
    tps = B * S / ms * 1e3
    log(f"[configs] (b) bert_base(hidden_dropout_prob=0.0) fine-tune, no "
        f"mask, Engine(amp_level='O2'), b {B} s {S}: a step launched "
        f"{got} (want {want}); the first step's loss {first:.6f} vs "
        f"{plain:.6f} with the route's predicate false, rel {rel:.2e} (bar "
        f"{ROUTE_RTOL}); step {ms:.2f} ms (mean of {leg['steps']} after "
        f"{leg['warmup'] + 1} warm-up), {tps:.0f} tokens/s, MFU "
        f"{6 * n * tps / peak:.4f}; losses "
        f"{[round(x, 4) for x in [first] + losses]}")
    if got != want or not rel <= ROUTE_RTOL or \
            not all(math.isfinite(x) for x in [first, plain] + losses):
        raise AssertionError(f"configs (b): launches {got}, rel {rel}, "
                             f"losses {losses}")
    return step


def _configs_resnet(torch, dev, paddle, peak):
    """(c) config 2: ResNet-50 `Model.fit` at b 64, 224^2 on bench.py's
    synthetic samples (imgs/s, MFU, the host share of a profiled step),
    then resnet18 one fit step, card against CPU."""
    import numpy as np
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.io import Dataset
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.models.weights import layer_from_numpy
    from paddle_tpu_torch.vision.models import resnet18, resnet50

    leg = CONFIG2_LEG
    batch, size = leg["batch"], leg["size"]
    paddle.seed(0)
    rng = np.random.default_rng(0)

    class SynthImageNet(Dataset):
        def __len__(self):
            return batch * (leg["iters"] + leg["warmup"] + 1)

        def __getitem__(self, idx):
            img = rng.standard_normal((3, size, size)).astype("float32")
            return img, np.asarray([idx % 1000], "int64")

    def prepared(net):
        model = paddle.Model(net)
        model.prepare(paddle.optimizer.Momentum(
            learning_rate=leg["lr"], momentum=0.9,
            parameters=model.parameters()), nn.CrossEntropyLoss(),
            Accuracy())
        return model

    model = prepared(resnet50(num_classes=1000))
    ds = SynthImageNet()
    model.fit(ds, epochs=1, batch_size=batch, verbose=0,
              num_iters=leg["warmup"])
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    model.fit(ds, epochs=1, batch_size=batch, verbose=0,
              num_iters=leg["iters"])
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    ips = batch * leg["iters"] / dt
    last = model._monitor.last.get("loss", float("nan"))
    x = paddle.to_tensor(np.random.default_rng(1).standard_normal(
        (batch, 3, size, size)).astype("float32"))
    y = paddle.to_tensor((np.arange(batch) % 1000).astype("int64")[:, None])
    model.train_batch([x], [y])
    _, step_ms = _sync_ms(torch, dev, lambda: model.train_batch([x], [y]))
    prof = _busy_share(torch, dev, lambda: model.train_batch([x], [y]),
                       n_steps=2)
    host = ("host share not measured: the profiler saw no device activity"
            if prof is None else
            f"profiled wall {prof[0]:.2f} ms a step, device busy "
            f"{prof[1]:.2f} ms: host share {1 - prof[1] / prof[0]:.1%}")
    mfu = ips * 3 * RESNET50_FWD_FLOPS * (size / 224.0) ** 2 / peak
    log(f"[configs] (c) config 2: Model(resnet50(num_classes=1000)).fit, "
        f"Momentum({leg['lr']}, 0.9), CrossEntropyLoss, Accuracy, b {batch}"
        f" {size}^2, f32 (TF32 off), bench.py's synthetic samples drawn in "
        f"__getitem__: {leg['iters']} iterations after {leg['warmup']} in "
        f"{dt:.2f} s, {ips:.1f} imgs/s, MFU {mfu:.4f} (3 x 4.089 GFLOPs an "
        f"image over the bf16 peak); last loss {last:.4f}; a train_batch "
        f"on device batches {step_ms:.2f} ms; {host}")
    if not math.isfinite(last):
        raise AssertionError(f"configs (c): loss {last}")
    model = x = None
    torch.cuda.empty_cache()

    # resnet18, one fit step, card against CPU (cuDNN deterministic)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        paddle.seed(0)
        net = resnet18(num_classes=10)
        state = {k: v.numpy() for k, v in net.state_dict().items()}
        data = np.random.default_rng(3).standard_normal(
            (2, 3, 64, 64)).astype("float32")
        small = paddle.io.TensorDataset([data, np.array([[1], [7]],
                                                        "int64")])
        with on_cpu(paddle):
            cpu_net = layer_from_numpy(resnet18(num_classes=10), state)
            cpu_model = prepared(cpu_net)
            cpu_model.fit(small, epochs=1, batch_size=2, verbose=0)
            cpu_loss = cpu_model._monitor.last["loss"]
        card_model = prepared(net)
        card_model.fit(small, epochs=1, batch_size=2, verbose=0)
        card_loss = card_model._monitor.last["loss"]
    finally:
        torch.backends.cudnn.deterministic = det
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    pairs = list(zip(net.named_parameters(), cpu_net.named_parameters()))
    finite = math.isfinite(card_loss) and math.isfinite(cpu_loss) and \
        all(bool(torch.isfinite(p._data).all() and
                 torch.isfinite(q._data).all()) for (_, p), (_, q) in pairs)
    worst = max((_rel(torch, p._data, q._data), k) for (k, p), (_, q) in
                pairs)
    log(f"[configs] (c) resnet18(num_classes=10), one fit step at b 2 64^2 "
        f"in f32, card against CPU: loss {card_loss:.6f} vs "
        f"{cpu_loss:.6f}, rel {loss_rel:.2e}; worst parameter {worst[1]} "
        f"||d||/||cpu|| {worst[0]:.2e} (bar {CARD_CPU_RTOL}); loss and "
        f"parameters finite {finite}")
    if not finite or not loss_rel <= CARD_CPU_RTOL or \
            not worst[0] <= CARD_CPU_RTOL:
        raise AssertionError(f"configs (c) card vs CPU: {loss_rel}, {worst}")


def _configs_vit(torch, dev, paddle):
    """(d) ViT-B/16 bf16 under amp.decorate(O2): B1 12 launches a forward,
    B2/B3 12 a backward, the loss against the plain route's."""
    import numpy as np
    from paddle_tpu_torch.vision.models import vit_b_16

    leg = VIT_LEG
    paddle.seed(0)
    model = paddle.amp.decorate(vit_b_16(num_classes=leg["classes"]),
                                level="O2", dtype="bfloat16")
    depth = len(model.blocks)
    rng = np.random.default_rng(4)
    x = paddle.to_tensor(rng.standard_normal(
        (leg["batch"], 3, leg["size"], leg["size"])).astype(
            "float32")).astype("bfloat16")
    y = paddle.to_tensor(rng.integers(0, leg["classes"],
                                      (leg["batch"],)).astype("int64"))
    ce = paddle.nn.CrossEntropyLoss()

    def step():
        loss = ce(model(x).astype("float32"), y)
        loss.backward()
        model.clear_gradients()
        return float(loss)

    reset_launches()
    with flash_calls() as seen:
        loss = ce(model(x).astype("float32"), y)
        torch.cuda.synchronize(dev)
        fwd = dict(launch_counts())
        loss.backward()
    model.clear_gradients()
    torch.cuda.synchronize(dev)
    total = dict(launch_counts())
    flash_path_check(torch, seen, "(d) ViT-B/16 forward + backward, O2")
    seen = None
    with plain_route(), paddle.no_grad():
        plain = float(ce(model(x).astype("float32"), y))
    rel = abs(float(loss) - plain) / abs(plain)
    step()
    _, ms = _sync_ms(torch, dev, lambda: [step() for _ in range(3)])
    got = {"flash_fwd": (fwd["flash_fwd"], total["flash_fwd"] -
                         fwd["flash_fwd"]),
           "flash_bwd_dq": (fwd["flash_bwd_dq"], total["flash_bwd_dq"] -
                            fwd["flash_bwd_dq"]),
           "flash_bwd_dkv": (fwd["flash_bwd_dkv"], total["flash_bwd_dkv"] -
                             fwd["flash_bwd_dkv"])}
    want = {"flash_fwd": (depth, 0), "flash_bwd_dq": (0, depth),
            "flash_bwd_dkv": (0, depth)}
    log(f"[configs] (d) vit_b_16(num_classes={leg['classes']}) under "
        f"amp.decorate(O2, bf16), b {leg['batch']} {leg['size']}^2 (197 "
        f"tokens, head_dim 64): launches (forward, backward) {got} (want "
        f"{want}); loss {float(loss):.6f} vs {plain:.6f} with the route's "
        f"predicate false, rel {rel:.2e} (bar {ROUTE_RTOL}); forward + "
        f"backward {ms / 3:.2f} ms (mean of 3)")
    if got != want or not rel <= ROUTE_RTOL or not math.isfinite(ms):
        raise AssertionError(f"configs (d): launches {got}, rel {rel}")
    return total


def _configs_gpt(torch, dev, paddle):
    """(e) GPT-2 small from seed 0, f32, eval(): gpt_params_from_layer ->
    Gpt -> greedy gpt_generate (B5 prefill windows, B4 decode) against the
    layer model's full forward; then AdamW steps of the layer model."""
    import numpy as np
    from paddle_tpu_torch.models import (Gpt, GPTConfig, GPTForCausalLM,
                                         GPTGenArgs, gpt_generate,
                                         gpt_params_from_layer)
    from paddle_tpu_torch.models import gpt as gpt_mod

    leg = GPT_LEG
    paddle.seed(0)
    cfg = GPTConfig()
    layer = GPTForCausalLM(cfg)
    layer.eval()
    gen = Gpt(GPTGenArgs.from_config(cfg), gpt_params_from_layer(layer))
    rng = np.random.default_rng(5)
    reset_launches()
    prefills, flips, t_gen = [], [], 0.0
    for s in leg["prompts"]:
        prompt = rng.integers(0, cfg.vocab_size, (1, s)).astype(np.int32)
        ids = torch.as_tensor(prompt, device=dev)
        ck, cv = gpt_mod.gpt_cache(gen, 1, s)
        pre = gpt_mod._gpt_forward_cached(gen, ids, ck, cv, 0)[0]
        with paddle.no_grad():
            full = layer(paddle.to_tensor(prompt.astype(np.int64)))
        prefills.append(_rel(torch, pre[0], full._data[0, -1]))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = gpt_generate(gen, prompt, max_new_tokens=leg["new"])
        torch.cuda.synchronize(dev)
        t_gen += time.perf_counter() - t0
        seq = out.cpu().numpy()
        with paddle.no_grad():
            logits = layer(paddle.to_tensor(seq[:, :-1].astype(
                np.int64)))._data[0, s - 1:].float()
        top2 = logits.topk(2, dim=-1)
        want = top2.indices[:, 0].cpu().numpy()
        for i, (g, w) in enumerate(zip(seq[0, s:], want)):
            if g != w:
                gap = float(top2.values[i, 0] - top2.values[i, 1])
                flips.append((s, i, int(g), int(w), gap))
    counts = dict(launch_counts())
    worst_prefill = max(prefills)
    log(f"[configs] (e) GPTForCausalLM(GPTConfig()) (GPT-2 small, "
        f"{_n_params(layer) / 1e6:.1f} M parameters) from seed 0, f32, "
        f"eval(): gpt_params_from_layer -> Gpt -> greedy gpt_generate, "
        f"prompts {list(leg['prompts'])}, {leg['new']} new tokens: the "
        f"prefill's last-position logits against the layer model's full "
        f"forward, worst ||d||/||ref|| {worst_prefill:.2e} (bar "
        f"{CARD_CPU_RTOL}); tokens off the full forward's argmax {flips} "
        f"((prompt, step, token, argmax, its top-2 gap)); launches "
        f"B5 {counts['window_attention']}, B4 {counts['decode_attention']}; "
        f"generate {t_gen * 1e3 / len(leg['prompts']):.1f} ms a prompt "
        f"(mean)")
    if not all(x <= CARD_CPU_RTOL for x in prefills) or \
            not counts["window_attention"] or \
            not counts["decode_attention"] or \
            not all(f[4] <= 1e-3 for f in flips):
        raise AssertionError(f"configs (e): prefill {worst_prefill}, "
                             f"launches {counts}, flips {flips}")
    gen = None

    layer.train()
    opt = paddle.optimizer.AdamW(leg["lr"], parameters=layer.parameters())
    ids = paddle.to_tensor(rng.integers(0, cfg.vocab_size, (
        leg["batch"], leg["seq"])).astype(np.int64))
    losses, ms = [], []
    for _ in range(leg["steps"]):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss = layer(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[configs] (e) {leg['steps']} AdamW steps ({leg['lr']}) of the "
        f"layer model on GPTPretrainingLoss, b {leg['batch']} s "
        f"{leg['seq']}, f32, dropout 0.1, plain masked attention: losses "
        f"{[round(x, 4) for x in losses]}, step ms "
        f"{[round(x, 1) for x in ms]}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"configs (e): losses {losses}")
    return counts


def _configs_vision_ops(torch, dev, paddle):
    """(f) nms, roi_align, roi_pool, deform_conv2d and box_coder on the
    card against the same calls on the CPU."""
    import numpy as np
    from paddle_tpu_torch.vision import ops

    rng = np.random.default_rng(6)
    scores = rng.random(64).astype("float32")
    xy = rng.uniform(0, 40, (64, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 24, (64, 2))],
                           1).astype("float32")
    feat = rng.standard_normal((2, 8, 32, 32)).astype("float32")
    num = np.array([24, 40], "int32")
    weight = rng.standard_normal((6, 4, 3, 3)).astype("float32")
    offset = rng.standard_normal((2, 18, 16, 16)).astype("float32")
    xin = rng.standard_normal((2, 8, 16, 16)).astype("float32")
    var = rng.uniform(0.1, 0.3, (64, 4)).astype("float32")
    calls = {
        "nms": lambda P: ops.nms(P(boxes), 0.4, scores=P(scores)),
        "roi_align": lambda P: ops.roi_align(P(feat), P(boxes), P(num), 4,
                                             spatial_scale=0.5),
        "roi_pool": lambda P: ops.roi_pool(P(feat), P(boxes), P(num), 4,
                                           spatial_scale=0.5),
        "deform_conv2d": lambda P: ops.deform_conv2d(
            P(xin), P(offset), P(weight), padding=1, groups=2),
        "box_coder": lambda P: ops.box_coder(P(boxes), P(var), P(boxes[:8])),
    }
    worst = {}
    for name, call in calls.items():
        card = call(lambda a: paddle.to_tensor(a))
        cpu = call(lambda a: paddle.to_tensor(a, place="cpu"))
        if card.place != dev or cpu.place.type != "cpu":
            raise AssertionError(f"configs (f) {name}: places {card.place}, "
                                 f"{cpu.place}")
        g, w = card.numpy(), cpu.numpy()
        if name == "nms":
            ok = np.array_equal(g, w)
            worst[name] = f"{len(g)} kept, equal {ok}"
        else:
            err = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
            ok = g.shape == w.shape and err <= 1e-5
            worst[name] = f"{err:.1e}"
        if not ok:
            raise AssertionError(f"configs (f) {name}: {worst[name]}")
    log(f"[configs] (f) vision.ops on the card against the CPU (indices "
        f"exactly, floats max|d|/max|cpu| <= 1e-5): {worst}")


def phase_configs(torch, dev, name):
    """BASELINE configs 3 and 2 on one card and the kernel paths of the
    A10c/A10d layers (CONFIG3_LEG, FINETUNE_LEG, CONFIG2_LEG, VIT_LEG,
    GPT_LEG): (a) config 3, (b) the fine-tune on B1-B3, (c) config 2, (d)
    ViT-B/16, (e) GPT-2 small from layers, (f) vision.ops. Returns the
    launch counts of the checked runs."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as device_mod

    device_mod._current = None   # the default: the card, no set_device
    peak = peaks(name)[1]
    t0 = time.perf_counter()
    total = _configs_bert(torch, dev, paddle, peak)
    torch.cuda.empty_cache()
    _configs_resnet(torch, dev, paddle, peak)
    torch.cuda.empty_cache()
    _add(total, _configs_vit(torch, dev, paddle))
    torch.cuda.empty_cache()
    _add(total, _configs_gpt(torch, dev, paddle))
    torch.cuda.empty_cache()
    _configs_vision_ops(torch, dev, paddle)
    log(f"[configs] the phase took {time.perf_counter() - t0:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    PEAK_SEEN.append(torch.cuda.max_memory_allocated(dev))
    return total


# BASELINE config 5: the UNet through jit.save and the Predictor
UNET_LEG = dict(batch=1, size=64, t=500.0, warmup=4, iters=24)
UNET_TINY_LEG = dict(batch=2, size=32)
UNET_BAR = dict(rtol=5e-2, atol=1e-1)   # tests/test_subsystems.py:340-344
# the deployment dtypes config 5 is served in: bf16 (bench.py's cast) and
# fp16 (the JAX Predictor's Half, paddle_tpu/inference/__init__.py:455)
UNET_DTYPES = ("bfloat16", "float16")


def _bar_ratio(torch, got, ref, rtol, atol):
    """max |got - ref| / (atol + rtol |ref|): <= 1 is within the bar."""
    got, ref = got.detach().float(), ref.detach().float()
    return float(((got - ref).abs() / (atol + rtol * ref.abs())).max())


def _unet_tiny_card_cpu(torch, dev, paddle, infer, InputSpec, tmp):
    """unet_tiny on B1's gate (base 32, one head: head_dim 64) in f32,
    saved from the card: a card Predictor and a CPU Predictor on the same
    files; saved from the CPU: a card Predictor. Returns the card
    Predictor's B1 launches a call."""
    import numpy as np
    from paddle_tpu_torch.models import unet_tiny

    leg = UNET_TINY_LEG
    spec = [InputSpec(["batch", 4, leg["size"], leg["size"]], "float32",
                      "latents"), InputSpec(["batch"], "float32", "timestep")]
    paddle.seed(0)
    model = unet_tiny(base_channels=32, num_heads=1)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    card_prefix = os.path.join(tmp, "tiny_card")
    paddle.jit.save(model, card_prefix, input_spec=spec)
    with on_cpu(paddle):
        cpu_model = unet_tiny(base_channels=32, num_heads=1)
        cpu_model.set_state_dict(state)
        cpu_prefix = os.path.join(tmp, "tiny_cpu")
        paddle.jit.save(cpu_model, cpu_prefix, input_spec=spec)
    rng = np.random.default_rng(1)
    feeds = [rng.standard_normal((leg["batch"], 4, leg["size"],
                                  leg["size"])).astype("float32"),
             np.asarray([10.0, 500.0], "float32")]

    def serve(prefix, card):
        cfg = infer.Config(prefix)
        if not card:
            cfg.disable_gpu()
        pred = infer.create_predictor(cfg)
        reset_launches()
        out = pred.run(feeds)[0]
        torch.cuda.synchronize(dev)
        return out, dict(launch_counts())

    card, n_card = serve(card_prefix, True)
    cpu, n_cpu = serve(card_prefix, False)
    moved, n_moved = serve(cpu_prefix, True)
    rel_cpu, rel_moved = _rel(torch, card, cpu), _rel(torch, moved, card)
    log(f"[unet] unet_tiny(base_channels=32, num_heads=1) f32, b "
        f"{leg['batch']} {leg['size']}^2: saved from the card, card "
        f"Predictor ({card.device}) against CPU Predictor ({cpu.device}) rel "
        f"{rel_cpu:.3e}; saved from the CPU, card Predictor ({moved.device}) "
        f"against the card-saved one rel {rel_moved:.3e} (bar "
        f"{CARD_CPU_RTOL}); B1 launches a call: card {n_card['flash_fwd']}, "
        f"moved {n_moved['flash_fwd']}, CPU {n_cpu['flash_fwd']}")
    others = {k: v for n in (n_card, n_moved) for k, v in n.items()
              if k != "flash_fwd" and v}
    if not (rel_cpu <= CARD_CPU_RTOL and rel_moved <= CARD_CPU_RTOL) or \
            card.device.type != "cuda" or moved.device.type != "cuda" or \
            cpu.device.type != "cpu" or n_card["flash_fwd"] == 0 or \
            n_moved["flash_fwd"] != n_card["flash_fwd"] or \
            any(n_cpu.values()) or others:
        raise AssertionError(f"unet_tiny card/CPU: rel {rel_cpu}, "
                             f"{rel_moved}; launches {n_card}, {n_moved}, "
                             f"{n_cpu}")
    return n_card["flash_fwd"]


@contextlib.contextmanager
def b1_without_head_dim(d):
    """B1's gate closed to head_dim `d` for the block (the gate before this
    slice took head_dim 32): a program exported inside takes the plain
    attention there."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    supports = fa.supports
    fa.supports = lambda q, k, v=None: q.shape[-1] != d and supports(q, k, v)
    try:
        yield
    finally:
        fa.supports = supports


def _unet_attention_blocks(model):
    """{head_dim: blocks} of the model's attention blocks, read from its
    modules: B1 launches once a block a call."""
    from paddle_tpu_torch.models.unet import AttentionBlock

    blocks = {}
    for m in model.sublayers():
        if isinstance(m, AttentionBlock):
            hd = m.channels // m.num_heads
            blocks[hd] = blocks.get(hd, 0) + 1
    return blocks


def _unet_model(torch, paddle, dname):
    """`unet_sd_like()` from seed 0, its parameters in `dname` (the deploy
    precision, as bench.py casts), in eval()."""
    from paddle_tpu_torch.models import unet_sd_like

    paddle.seed(0)
    model = unet_sd_like()
    for p in model.parameters():
        p._data = p._data.to(getattr(torch, dname))
    model.eval()
    return model


def _unet_predictor(paddle, infer, InputSpec, model, dname, size, prefix):
    """jit.save with a dynamic batch -> create_predictor; (Predictor,
    export s, build s, {suffix: MiB})."""
    t0 = time.perf_counter()
    paddle.jit.save(model, prefix, input_spec=[
        InputSpec(["batch", 4, size, size], dname, "latents"),
        InputSpec(["batch"], "float32", "timestep")])
    t_export = time.perf_counter() - t0
    mb = {x: os.path.getsize(prefix + x) / 2**20
          for x in (".pdmodel", ".pdiparams")}
    t0 = time.perf_counter()
    pred = infer.create_predictor(infer.Config(prefix))
    return pred, t_export, time.perf_counter() - t0, mb


def _unet_call(pred, lat, ts):
    """bench.py's timed unit: copy_from_cpu -> run -> copy_to_cpu."""
    h_lat = pred.get_input_handle("latents")
    h_ts = pred.get_input_handle("timestep")
    out_name = pred.get_output_names()[0]

    def call():
        h_lat.copy_from_cpu(lat)
        h_ts.copy_from_cpu(ts)
        pred.run()
        return pred.get_output_handle(out_name).copy_to_cpu()

    return call


def _unet_interleaved(calls, leg):
    """{label: (median ms, min, max)} of each call over leg["iters"]
    rounds after leg["warmup"] calls each, the calls taken in turns (round
    r starts at call r mod n), so that the host's drift lands on all of
    them alike."""
    for call in calls.values():
        for _ in range(leg["warmup"]):
            call()
    keys = list(calls)
    times = {k: [] for k in keys}
    for r in range(leg["iters"]):
        for k in keys[r % len(keys):] + keys[:r % len(keys)]:
            t0 = time.perf_counter()
            calls[k]()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: (statistics.median(v), min(v), max(v))
            for k, v in times.items()}


def _busy_line(prof):
    if not prof:
        return "the profiler saw no device activity"
    return (f"wall {prof[0]:.3f} ms, device busy {prof[1]:.3f} ms "
            f"({prof[1] / prof[0]:.1%}; by group "
            f"{ {g: round(ms, 3) for g, ms in prof[2].items()} }), "
            f"{sum(n for _, _, n in prof[3]):.0f} kernels launched, the "
            f"top 3 by time "
            f"{[(k[:48], round(ms, 3), n) for k, ms, n in prof[3][:3]]}")


def _unet_checked_call(torch, dev, paddle, pred, model, lat, ts, dname,
                       bar):
    """One Predictor call with every B1 call kept: the launch counts (with
    B1's fp16 and head_dim-32 ones), each kept B1 call through
    `flash_path_check`, the output against the eager layer and the eager
    layer under plain_route(). Returns (out, counts, worst path ratios,
    r_eager, r_plain, shapes of the B1 calls)."""
    reset_launches()
    with flash_calls(every=True) as seen:
        out = pred.run([lat, ts])[0]
        torch.cuda.synchronize(dev)
    counts = all_counts()
    worst = {}
    for i, call in enumerate(seen["fwd"]):
        r = flash_path_check(torch, {"fwd": call},
                             f"unet {dname}: B1 call {i}", quiet=True)
        for name, x in r.items():
            if name != "mean_v_n01" and not name.startswith("mean_v"):
                worst[name] = max(worst.get(name, 0.0), x)
    shapes = [tuple(c[0][0].shape) for c in seen["fwd"]]
    seen = None
    with paddle.no_grad():
        x = paddle.to_tensor(lat).astype(dname)
        t = paddle.to_tensor(ts)
        ref = model(x, t)._data
        with plain_route():
            plain = model(x, t)._data
    return (out, counts, worst, _bar_ratio(torch, out, ref, **bar),
            _bar_ratio(torch, out, plain, **bar), shapes)


def phase_unet(torch, dev, name):
    """BASELINE config 5 through `jit.save` -> `inference.Config` ->
    `create_predictor` -> `run()` in bf16 and in fp16 (UNET_LEG,
    UNET_DTYPES), and unet_tiny card against CPU (UNET_TINY_LEG). Returns
    the launch counts of the checked config-5 calls, both dtypes."""
    import tempfile

    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference as infer
    from paddle_tpu_torch.framework import device as device_mod
    from paddle_tpu_torch.hapi.model import InputSpec

    device_mod._current = None   # the default: the card, no set_device
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    leg, bar = UNET_LEG, UNET_BAR
    size = leg["size"]
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((leg["batch"], 4, size, size)).astype("float32")
    ts = np.full((leg["batch"],), leg["t"], "float32")
    lat2 = rng.standard_normal((2, 4, size, size)).astype("float32")
    ts2 = np.asarray([10.0, leg["t"]], "float32")
    total, calls, keep, bad = None, {}, [], []
    before_label = "bfloat16, level 1 off B1"
    with tempfile.TemporaryDirectory() as tmp:
        for dname in UNET_DTYPES:
            model = _unet_model(torch, paddle, dname)
            blocks = _unet_attention_blocks(model)
            want_b1 = sum(blocks.values())
            n_params = _n_params(model)
            param_bytes = sum(p._data.numel() * p._data.element_size()
                              for p in model.parameters())
            feed = lat.astype("float16") if dname == "float16" else lat
            pred, t_export, t_build, mb = _unet_predictor(
                paddle, infer, InputSpec, model, dname, size,
                os.path.join(tmp, f"unet_{dname}"))
            out, counts, worst, r_eager, r_plain, shapes = \
                _unet_checked_call(torch, dev, paddle, pred, model, feed, ts,
                                   dname, bar)
            finite = bool(torch.isfinite(out.float()).all())
            # one Predictor, another batch, no re-export
            reset_launches()
            out2 = pred.run([lat2, ts2])[0]
            torch.cuda.synchronize(dev)
            b2_launches = launch_counts()["flash_fwd"]
            with paddle.no_grad():
                ref2 = model(paddle.to_tensor(lat2).astype(dname),
                             paddle.to_tensor(ts2))._data
            r_b2 = _bar_ratio(torch, out2, ref2, **bar)
            _, n_ops = _ops_dispatched(torch, pred.run)
            torch.cuda.synchronize(dev)
            want = {k: 0 for k in counts}
            want["flash_fwd"] = want_b1
            want["flash_fwd_hd32"] = blocks.get(32, 0)
            want["flash_fwd_f16"] = want_b1 if dname == "float16" else 0
            log(f"[unet] config 5 in {dname}: unet_sd_like() "
                f"({n_params / 1e6:.3f} M parameters, "
                f"{param_bytes / 2**20:.1f} MiB) from seed 0, attention "
                f"blocks by head_dim {blocks}; jit.save with a dynamic "
                f"batch in {t_export:.2f} s (.pdmodel "
                f"{mb['.pdmodel']:.2f} MiB, .pdiparams "
                f"{mb['.pdiparams']:.1f} MiB), Predictor built in "
                f"{t_build:.2f} s on {pred.device}; {n_ops} aten ops "
                f"dispatched a run()")
            log(f"[unet] {dname} b {leg['batch']} {size}^2 t {leg['t']}: "
                f"output {list(out.shape)} {out.dtype}, finite {finite}; "
                f"within (rtol {bar['rtol']}, atol {bar['atol']}) as a "
                f"fraction of the bar: of the eager layer {r_eager:.4f}, of "
                f"the eager layer with the route's predicate false "
                f"{r_plain:.4f}; launches a call "
                f"{ {k: v for k, v in counts.items() if v} } (want "
                f"{ {k: v for k, v in want.items() if v} } and nothing "
                f"else), B1's q shapes {sorted(set(shapes))}; every B1 "
                f"call against the plain versions, worst vector at "
                f"(fraction of its bar) "
                f"{ {n: round(x, 4) for n, x in worst.items()} }; batch "
                f"2 from the same Predictor: {list(out2.shape)}, "
                f"{r_b2:.4f} of the bar against the eager layer, B1 "
                f"{b2_launches} launches")
            if not (finite and list(out.shape) == [leg["batch"], 4, size,
                                                    size]
                    and out.dtype == getattr(torch, dname)
                    and r_eager <= 1.0 and r_plain <= 1.0 and r_b2 <= 1.0
                    and list(out2.shape) == [2, 4, size, size]
                    and counts == want and b2_launches == want_b1
                    and blocks.get(32, 0) > 0 and len(shapes) == want_b1):
                bad.append(f"{dname}: finite {finite}, shape "
                           f"{list(out.shape)} {out.dtype}, bars eager "
                           f"{r_eager} plain {r_plain} batch-2 {r_b2}, "
                           f"launches {counts} (want {want}), batch-2 B1 "
                           f"{b2_launches}, blocks {blocks}")
            total = counts if total is None else {
                k: total[k] + v for k, v in counts.items()}
            calls[dname] = _unet_call(pred, feed, ts)
            keep.append((pred, param_bytes))
            if dname == "bfloat16":
                # the same call with level 1 off B1's gate, as before this
                # slice: a program exported with head_dim 32 closed
                with b1_without_head_dim(32):
                    before, *_ = _unet_predictor(
                        paddle, infer, InputSpec, model, dname, size,
                        os.path.join(tmp, "unet_before"))
                reset_launches()
                before.run([lat, ts])
                torch.cuda.synchronize(dev)
                n_before = launch_counts()["flash_fwd"]
                log(f"[unet] bf16 with level 1 (head_dim 32) off B1's gate "
                    f"as before this slice: B1 {n_before} launches a call "
                    f"(want {want_b1 - blocks.get(32, 0)})")
                if n_before != want_b1 - blocks.get(32, 0):
                    bad.append(f"level 1 off the gate: B1 {n_before}")
                calls[before_label] = _unet_call(before, lat, ts)
                keep.append((before, param_bytes))
            model = out = out2 = None
            torch.cuda.empty_cache()
        # the three calls in turns, then one profiled call each
        lat_ms = _unet_interleaved(calls, leg)
        bw = peaks(name)[0]
        for label, call in calls.items():
            ms, lo, hi = lat_ms[label]
            prof = _busy_share(torch, dev, call, n_steps=1, top=None)
            log(f"[unet] {label} latency a call (copy_from_cpu -> run -> "
                f"copy_to_cpu), median of {leg['iters']} after "
                f"{leg['warmup']} warm-up, the {len(calls)} calls in turns: "
                f"{ms:.3f} ms (min {lo:.3f}, max {hi:.3f}); HBM roofline "
                f"share {keep[0][1] / (ms / 1e3) / bw:.4%} "
                f"({keep[0][1] / 1e6:.1f} MB of parameters over the latency "
                f"over {bw / 1e12:.2f} TB/s); one profiled call: "
                f"{_busy_line(prof)}")
        calls = keep = None
        n_tiny = _unet_tiny_card_cpu(torch, dev, paddle, infer, InputSpec,
                                     tmp)
    log(f"[unet] fp16 over bf16 latency "
        f"{lat_ms['float16'][0] / lat_ms['bfloat16'][0]:.3f}x; bf16 with "
        f"level 1 on B1 over level 1 off it "
        f"{lat_ms['bfloat16'][0] / lat_ms[before_label][0]:.3f}x; unet_tiny "
        f"B1 {n_tiny} launches a call; phase "
        f"{time.perf_counter() - t_phase:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    PEAK_SEEN.append(torch.cuda.max_memory_allocated(dev))
    if bad:
        raise AssertionError(f"unet: {bad}")
    return total


# the quant phase: weight-only int8 from `jit.save` to the Predictor
# (ROADMAP A10f part 1). The layer Llama at Llama-2-7B width (2 layers, seed
# 0, bf16) behind bench.py's next-token head, saved with a dynamic batch and
# sequence, served at bench.py's `_bench_int8` shape (b 2 s 128: 256 rows,
# B8's TMA route) and at decode rows (b 8 s 1: B8's GEMV)
QUANT_LEG = dict(layers=2, shapes=((2, 128), (8, 1)), warmup=3, iters=16)
# a call: B8 for 7 Linears a layer and lm_head, B1 one a layer, B9 two a
# layer and the final norm
QUANT_A_CALL = {"weight_only_matmul": 15, "flash_fwd": 2, "rms_norm_fwd": 5}
WEIGHT_ONLY_BAR = 0.05   # tests/test_subsystems.py:630
# the CPU test's tiny quantized Llama (tests/test_torch_quantization.py),
# saved on the CPU in f32 and served on the card: B8's f32 routes (the SIMT
# tiles at 32 rows, the GEMV at 3) and B1 at head_dim 64
QUANT_TINY = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=1,
                  intermediate_size=176)
QUANT_TINY_SHAPES = ((2, 16), (3, 1))
# one int8_ptq Linear at K 4096: torch._int_mm at 32 rows, the f64 product
# of the codes at 8 (fewer rows than _int_mm takes)
PTQ_LEG = dict(k=4096, n=4096, rows=(32, 8), calib=4, calib_rows=8)


def _next_token(paddle, cfg):
    """bench.py's `_NextToken` (:285) over the port's layer Llama: the last
    position's logits."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    class NextToken(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lm = LlamaForCausalLM(cfg)

        def forward(self, ids):
            return self.lm(ids)[:, -1, :]

    return NextToken()


@contextlib.contextmanager
def b8_calls():
    """For the block, keeps every call of B8's wrapper as the path makes it:
    [(x, codes, scale, out)], x and out copied (the codes and scales are the
    caller's own). The wrapper runs as it is, launch counts included."""
    from paddle_tpu_torch.kernels import quantized_matmul as qm

    seen, wrapped = [], qm.weight_only_matmul

    def keeping(x, w_q, scale, out_dtype=None):
        out = wrapped(x, w_q, scale, out_dtype)
        seen.append((x.detach().clone(), w_q, scale, out.detach().clone()))
        return out

    qm.weight_only_matmul = keeping
    try:
        yield seen
    finally:
        qm.weight_only_matmul = wrapped


def _serve_ms(torch, pred, feed, warmup, iters):
    """(median, min, max) ms of bench.py's timed call: copy_from_cpu ->
    run -> copy_to_cpu."""
    h = pred.get_input_handle(pred.get_input_names()[0])
    out = pred.get_output_handle(pred.get_output_names()[0])

    def call():
        h.copy_from_cpu(feed)
        pred.run()
        return out.copy_to_cpu()

    for _ in range(warmup):
        call()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), max(times)


# throwaway kernels that open the profiled window `_b8_share` reads, and
# the sessions it opens before it gives up on one that loses them all (a
# session late in the run has lost every one of the 64)
PROFILE_PAD_KERNELS = 64
PROFILE_SESSIONS = 3


def _b8_share(torch, dev, pred, feed, tmp):
    """(B8's device ms, the call's device ms, B8's launches, the host ms of
    B8's operator nodes) of one profiled Predictor call, read with
    `paddle_tpu_torch.profiler` (the host ms from the torch.profiler trace
    it wrote), or None when the profiler saw no device activity. After the
    configs and unet phases a torch.profiler session can lose its first
    device records (the call's first B8 launches among them), so
    PROFILE_PAD_KERNELS `torch.cuda._sleep` kernels go first and their
    time is left out; a session whose trace holds none of them lost more
    than the pad, and the call is profiled again, PROFILE_SESSIONS times
    at most. The trace must hold every B8 launch the counters saw in the
    call, or this raises."""
    import glob

    from paddle_tpu_torch import profiler as pprof
    from paddle_tpu_torch.kernels import quantized_matmul as qm

    for session in range(1, PROFILE_SESSIONS + 1):
        p = pprof.Profiler(log_dir=tmp)
        p.start()
        for _ in range(PROFILE_PAD_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize(dev)
        before = qm.launches["weight_only_matmul"]
        pred.run([feed])
        torch.cuda.synchronize(dev)
        counted = qm.launches["weight_only_matmul"] - before
        p.stop()
        if not p.device_total:
            return None
        pad = [d for k, v in p.device_events.items() if "spin_kernel" in k
               for d in v]
        if pad:
            break
        lost = [d for k, v in p.device_events.items() if "b8_" in k
                for d in v]
        log(f"[quant] profiled session {session} of {PROFILE_SESSIONS} "
            f"lost more than its {PROFILE_PAD_KERNELS} throwaway kernels "
            f"(no spin_kernel in its trace; B8 {len(lost)} of the {counted} "
            f"launches counted, {sum(lost) * 1e3:.3f} ms of its "
            f"{p.device_total * 1e3:.3f} device ms); the call is profiled "
            "again")
        for f in glob.glob(os.path.join(tmp, "*.pt.trace.json")):
            os.remove(f)
    else:
        raise AssertionError(f"quant: no throwaway spin_kernel in the "
                             f"trace of {PROFILE_SESSIONS} sessions")
    pad = sum(pad)
    b8 = [d for k, v in p.device_events.items() if "b8_" in k for d in v]
    if len(b8) != counted:
        raise AssertionError(f"quant: the profiled call's trace holds "
                             f"{len(b8)} B8 kernels, the counters saw "
                             f"{counted} launches")
    with open(glob.glob(os.path.join(tmp, "*.pt.trace.json"))[0]) as f:
        events = json.load(f)["traceEvents"]
    host = sum(e.get("dur", 0.0) for e in events if e.get("ph") == "X" and
               e.get("name") == "paddle_tpu_torch::weight_only_matmul") / 1e3
    return sum(b8) * 1e3, (p.device_total - pad) * 1e3, len(b8), host


def _quant_tiny_card_cpu(torch, dev, paddle, infer, InputSpec, tmp):
    """The CPU test's tiny Llama, weight-only int8, saved on the CPU in f32:
    a card Predictor and a CPU Predictor on the same files (rel <=
    CARD_CPU_RTOL), B8 15, B1 2 and B9 5 launches a call on the card (every
    kernel is an operator of the program, routed at call time), none on the
    CPU."""
    import numpy as np
    from paddle_tpu_torch.models import LlamaConfig

    with on_cpu(paddle):
        paddle.seed(0)
        cfg = LlamaConfig.tiny(**QUANT_TINY)
        prefix = os.path.join(tmp, "tiny_cpu")
        paddle.jit.save(_next_token(paddle, cfg), prefix, input_spec=[
            InputSpec([None, None], "int64", "ids")],
            quantize="weight_only_int8")
    card = infer.create_predictor(infer.Config(prefix))
    cpu_cfg = infer.Config(prefix)
    cpu_cfg.disable_gpu()
    cpu = infer.create_predictor(cpu_cfg)
    rng = np.random.default_rng(1)
    want = QUANT_A_CALL
    bad, rels = {}, {}
    for shape in QUANT_TINY_SHAPES:
        ids = rng.integers(0, cfg.vocab_size, shape).astype(np.int64)
        reset_launches()
        got = card.run([ids])[0]
        torch.cuda.synchronize(dev)
        n_card = {k: v for k, v in launch_counts().items() if v}
        reset_launches()
        ref = cpu.run([ids])[0]
        n_cpu = {k: v for k, v in launch_counts().items() if v}
        rels[shape] = _rel(torch, got, ref)
        if not (rels[shape] <= CARD_CPU_RTOL and n_card == want and
                not n_cpu and got.device.type == "cuda" and
                ref.device.type == "cpu"):
            bad[shape] = (rels[shape], n_card, n_cpu)
    log(f"[quant] the tiny Llama {QUANT_TINY} weight-only int8 saved on the "
        f"CPU in f32, a card Predictor against a CPU Predictor on the same "
        f"files: rel { {f'{b}x{s}': f'{r:.3e}' for (b, s), r in rels.items()} } "
        f"(bar {CARD_CPU_RTOL}); launches a card call {want} at each shape "
        f"(B8's f32 SIMT tiles at 32 rows, its f32 GEMV at 3)")
    if bad:
        raise AssertionError(f"quant tiny card/CPU: {bad}")


def _quant_ptq(torch, dev, paddle, infer, InputSpec, tmp):
    """One int8_ptq Linear at K 4096 saved on the card: its card Predictor
    equal to a CPU Predictor on the same files, bit for bit, at 32 rows
    (torch._int_mm) and 8 (the f64 product of the codes), and the int32
    products of the same codes equal on both devices."""
    import numpy as np
    from paddle_tpu_torch.quantization import ptq_int8

    leg = PTQ_LEG
    k, n = leg["k"], leg["n"]
    paddle.seed(0)
    lin = paddle.nn.Linear(k, n)
    rng = np.random.default_rng(2)
    calib = [rng.normal(size=(leg["calib_rows"], k)).astype("float32")
             for _ in range(leg["calib"])]
    prefix = os.path.join(tmp, "ptq")
    paddle.jit.save(lin, prefix, input_spec=[
        InputSpec([None, k], "float32", "x")], quantize="int8_ptq",
        calib_reader=calib)
    card = infer.create_predictor(infer.Config(prefix))
    cpu_cfg = infer.Config(prefix)
    cpu_cfg.disable_gpu()
    cpu = infer.create_predictor(cpu_cfg)
    equal, acc_equal = {}, {}
    for rows in leg["rows"]:
        x = rng.normal(size=(rows, k)).astype("float32")
        a = card.run([x])[0]
        b = cpu.run([x])[0]
        equal[rows] = bool(torch.equal(a.cpu(), b)) and a.device.type == "cuda"
        xq = torch.from_numpy(rng.integers(-127, 128, (rows, k)).astype(
            np.int8))
        wq = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
        acc_equal[rows] = bool(torch.equal(
            ptq_int8._int8_matmul(xq.to(dev), wq.to(dev)).cpu(),
            ptq_int8._int8_matmul(xq, wq)))
    log(f"[quant] int8_ptq Linear({k}, {n}) saved on the card: card "
        f"Predictor == CPU Predictor bit for bit at rows {equal}; the int32 "
        f"products of random codes, card == CPU: {acc_equal}")
    if not (all(equal.values()) and all(acc_equal.values())):
        raise AssertionError(f"quant ptq: outputs {equal}, products "
                             f"{acc_equal}")


def phase_quant(torch, dev, name):
    """Weight-only int8 through `jit.save(quantize="weight_only_int8")` ->
    `inference.Config` -> `create_predictor` -> `run()` at Llama-2-7B width
    (QUANT_LEG), every B8 call held against its plain version, the logits
    against the bf16 Predictor's; then the tiny Llama card against CPU and
    a K-4096 int8_ptq Linear. Returns the launch counts of the checked
    calls."""
    import tempfile

    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference as infer
    from paddle_tpu_torch.framework import device as device_mod
    from paddle_tpu_torch.hapi.model import InputSpec
    from paddle_tpu_torch.kernels import quantized_matmul as qm
    from paddle_tpu_torch.models import LlamaConfig

    device_mod._current = None   # the default: the card, no set_device
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    leg = QUANT_LEG
    paddle.seed(0)
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=leg["layers"])
    model = _next_token(paddle, cfg)
    model.to(dtype="bfloat16")
    model.eval()
    n_params = _n_params(model)
    spec = [InputSpec([None, None], "int64", "ids")]
    rng = np.random.default_rng(0)
    total = {k: 0 for k in launch_counts()}
    rows, bad = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        prefixes, t_save, mb = {}, {}, {}
        for mode, quant in (("bf16", None), ("int8", "weight_only_int8")):
            prefixes[mode] = os.path.join(tmp, mode)
            t0 = time.perf_counter()
            paddle.jit.save(model, prefixes[mode], input_spec=spec,
                            quantize=quant)
            t_save[mode] = time.perf_counter() - t0
            mb[mode] = os.path.getsize(prefixes[mode] + ".pdiparams") / 1e6
        preds = {m: infer.create_predictor(infer.Config(p))
                 for m, p in prefixes.items()}
        for b, s in leg["shapes"]:
            ids = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int64)
            reset_launches()
            with b8_calls() as seen:
                out = preds["int8"].run([ids])[0]
                torch.cuda.synchronize(dev)
            counts = dict(launch_counts())
            _add(total, counts)
            ratios = [row_ratio(torch, o, qm.dequant_matmul_plain,
                                (x, w, sc), "bfloat16")
                      for x, w, sc, o in seen]
            ms_ = sorted({x.numel() // x.shape[-1] for x, *_ in seen})
            seen = None
            ref = preds["bf16"].run([ids])[0]
            torch.cuda.synchronize(dev)
            err = float((out.float() - ref.float()).abs().max()
                        / ref.float().abs().max())
            finite = bool(torch.isfinite(out.float()).all())
            ms = {m: _serve_ms(torch, p, ids, leg["warmup"], leg["iters"])
                  for m, p in preds.items()}
            share = {m: _b8_share(torch, dev, p, ids,
                                  os.path.join(tmp, f"prof_{m}_{b}x{s}"))
                     for m, p in preds.items()}
            tma = b * s > qm.GEMV_MAX_ROWS
            want = dict(QUANT_A_CALL)
            if tma:
                want["weight_only_matmul_prefill"] = 15
            got = {k: v for k, v in counts.items() if v}
            rows[(b, s)] = (got, ratios, ms_, err, finite, ms, share)
            if not (got == want and len(ratios) == 15 and
                    max(ratios) <= 1.0 and err <= WEIGHT_ONLY_BAR and
                    finite and list(out.shape) == [b, cfg.vocab_size]):
                bad[(b, s)] = (got, want, max(ratios, default=None), err,
                               finite, list(out.shape))
        preds = None
        torch.cuda.synchronize(dev)
        log(f"[quant] LlamaForCausalLM(LlamaConfig.llama2_7b(num_hidden_"
            f"layers={leg['layers']})) behind bench.py's next-token head, "
            f"{n_params / 1e9:.3f} B parameters from seed 0, bf16; jit.save "
            f"with a dynamic batch and sequence: bf16 {t_save['bf16']:.1f} s "
            f"(.pdiparams {mb['bf16']:.1f} MB), weight_only_int8 "
            f"{t_save['int8']:.1f} s (.pdiparams {mb['int8']:.1f} MB, "
            f"{mb['int8'] / mb['bf16']:.3f}x)")
        for (b, s), (got, ratios, ms_, err, finite, ms, share) in rows.items():
            i8, bf = ms["int8"], ms["bf16"]
            i8p, bfp = share["int8"], share["bf16"]
            busy = ("the profiler saw no device activity" if not (i8p and bfp)
                    else f"B8 {i8p[0]:.3f} ms of {i8p[1]:.3f} ms of device "
                    f"time ({i8p[0] / i8p[1]:.1%}) in {i8p[2]} launches, its "
                    f"operator nodes {i8p[3]:.3f} ms of host time; the bf16 "
                    f"call's device time {bfp[1]:.3f} ms")
            log(f"[quant] b {b} s {s} (B8 at M {ms_}): launches a call {got} "
                f"(want {QUANT_A_CALL}, B8's TMA route "
                f"{'15' if b * s > qm.GEMV_MAX_ROWS else '0'}); every B8 "
                f"call within its bar of the plain version in f32, worst "
                f"vector at {max(ratios):.4f} of {TOL['bfloat16']} "
                f"({len(ratios)} calls); logits finite {finite}, max |int8 "
                f"- bf16 Predictor| / max |bf16| {err:.4f} (bar "
                f"{WEIGHT_ONLY_BAR})")
            log(f"[quant] b {b} s {s} latency a call (copy_from_cpu -> run "
                f"-> copy_to_cpu, median of {leg['iters']} after "
                f"{leg['warmup']} warm-up): int8 {i8[0]:.3f} ms (min "
                f"{i8[1]:.3f}, max {i8[2]:.3f}), bf16 {bf[0]:.3f} ms (min "
                f"{bf[1]:.3f}, max {bf[2]:.3f}); tokens/s (batch x seq / "
                f"time) int8 {b * s / i8[0] * 1e3:.1f}, bf16 "
                f"{b * s / bf[0] * 1e3:.1f} ({bf[0] / i8[0]:.3f}x); one "
                f"profiled call each (paddle_tpu_torch.profiler): {busy}")
        if bad:
            raise AssertionError(f"quant: {bad}")
        model = None
        torch.cuda.empty_cache()
        _quant_tiny_card_cpu(torch, dev, paddle, infer, InputSpec, tmp)
        _quant_ptq(torch, dev, paddle, infer, InputSpec, tmp)
    device_mod._current = None
    log(f"[quant] phase {time.perf_counter() - t_phase:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    PEAK_SEEN.append(torch.cuda.max_memory_allocated(dev))
    return total


# the recompute phase: `LlamaConfig.recompute` (fleet.recompute) on the
# layer Llama at Llama-2-7B width in f32 (TF32 off) against the same model
# without it; then the bf16 O2 step both ways
RECOMPUTE_LEG = dict(layers=2, batch=1, seq=2048, lr=1e-4)
RECOMPUTE_GRAD_REL = 1e-6
# a step with recompute: B1 and B9 run again in each layer's replay
RECOMPUTE_A_STEP = {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                    "rms_norm_fwd": 9, "rms_norm_bwd": 5}


def phase_recompute(torch, dev):
    """The layer Llama (RECOMPUTE_LEG, seed 0, f32) with and without
    `recompute`: equal losses, each gradient leaf within RECOMPUTE_GRAD_REL
    (||d|| / ||ref||), RECOMPUTE_A_STEP launches a recomputed step; step ms
    and peak memory above the resting weights both ways, then in bf16 under
    amp.decorate O2. Returns the launch counts of the recomputed step."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as device_mod
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    device_mod._current = None
    t_phase = time.perf_counter()
    leg = RECOMPUTE_LEG
    paddle.seed(0)
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=leg["layers"])
    model = LlamaForCausalLM(cfg)
    rng = np.random.default_rng(0)
    ids, labels = (paddle.to_tensor(rng.integers(
        0, cfg.vocab_size, (leg["batch"], leg["seq"])).astype(np.int64))
        for _ in range(2))

    def step(recompute, opt=None):
        cfg.recompute = recompute
        model.clear_gradients()
        torch.cuda.synchronize(dev)
        rest = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        loss = model(ids, labels=labels)
        held = (torch.cuda.memory_allocated(dev) - rest) / 2**30
        loss.backward()
        if opt is not None:
            opt.step()
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated(dev) - rest) / 2**30
        return loss.item(), dict(launch_counts()), ms, peak, held

    f32, ref = {}, None
    for rc in (False, True):   # the second of two steps is read
        step(rc)
        f32[rc] = step(rc)
        if not rc:
            ref = {k: p.grad._data.clone()
                   for k, p in model.named_parameters()}
    worst = ("", 0.0)
    for k, p in model.named_parameters():
        rel = ((p.grad._data - ref[k]).norm() / ref[k].norm()).item()
        if not math.isfinite(rel) or rel >= worst[1]:
            worst = (k, rel)
    ref = None
    got = {k: v for k, v in f32[True][1].items() if v}
    loss_eq = f32[True][0] == f32[False][0]
    log(f"[recompute] LlamaForCausalLM(llama2_7b(num_hidden_layers="
        f"{leg['layers']})) f32 (TF32 off), b {leg['batch']} s {leg['seq']}: "
        f"loss with recompute {f32[True][0]:.9f}, without "
        f"{f32[False][0]:.9f} (equal: {loss_eq}); worst grad leaf "
        f"{worst[0]} ||d||/||ref|| {worst[1]:.3e} (bar {RECOMPUTE_GRAD_REL}; "
        f"0 expected: the kernels are deterministic); launches a recomputed "
        f"step {got} (want {RECOMPUTE_A_STEP}); without recompute "
        f"{ {k: v for k, v in f32[False][1].items() if v} }")
    def ratio(a, b):
        return f"{a / b:.3f}x" if b else "not measured"

    grad_gib = _n_params(model) * 4 / 2**30

    log(f"[recompute] f32 forward + backward, second of two steps, "
        f"without recompute: {f32[False][2]:.2f} ms, activations held after "
        f"the forward {f32[False][4]:.3f} GiB, peak {f32[False][3]:.3f} GiB "
        f"above the resting weights (the f32 gradients' {grad_gib:.3f} GiB "
        f"among it); "
        f"with: {f32[True][2]:.2f} ms ({ratio(f32[True][2], f32[False][2])}), "
        f"held {f32[True][4]:.3f} GiB ({ratio(f32[True][4], f32[False][4])}), "
        f"peak {f32[True][3]:.3f} GiB ({ratio(f32[True][3], f32[False][3])})")
    if not (loss_eq and worst[1] <= RECOMPUTE_GRAD_REL and
            got == RECOMPUTE_A_STEP):
        raise AssertionError(f"recompute: loss {f32[True][0]} vs "
                             f"{f32[False][0]}, worst {worst}, launches "
                             f"{got}")
    total = f32[True][1]
    opt = paddle.optimizer.AdamW(leg["lr"], parameters=model.parameters(),
                                 multi_precision=True)
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     dtype="bfloat16", master_weight=True)
    bf16 = {}
    for rc in (False, True):
        step(rc, opt)
        loss, _, ms, peak, held = step(rc, opt)
        bf16[rc] = (loss, ms, peak, held)
    log(f"[recompute] bf16 under amp.decorate O2 (f32 masters), forward + "
        f"backward + AdamW, second of two steps, without recompute: "
        f"{bf16[False][1]:.2f} ms, held after the forward "
        f"{bf16[False][3]:.3f} GiB, peak {bf16[False][2]:.3f} GiB above the "
        f"resting state; with: {bf16[True][1]:.2f} ms "
        f"({ratio(bf16[True][1], bf16[False][1])}), held "
        f"{bf16[True][3]:.3f} GiB ({ratio(bf16[True][3], bf16[False][3])}), "
        f"peak {bf16[True][2]:.3f} GiB ({ratio(bf16[True][2], bf16[False][2])}"
        f"); the losses of AdamW steps 2 and 4 {bf16[False][0]:.6f}, "
        f"{bf16[True][0]:.6f}; phase {time.perf_counter() - t_phase:.1f} s")
    if not all(math.isfinite(v[0]) for v in bf16.values()):
        raise AssertionError(f"recompute bf16: losses {bf16}")
    cfg.recompute = False
    PEAK_SEEN.append(torch.cuda.max_memory_allocated(dev))
    return total


# the incubate phase: 12 FusedTransformerEncoderLayers at BERT-base width
# (incubate.nn), dropout 0, bf16, forward and backward
INCUBATE_LEG = dict(layers=12, width=768, heads=12, ffn=3072, batch=8,
                    seq=128, warmup=2, steps=8)


def phase_incubate(torch, dev):
    """INCUBATE_LEG through `incubate.nn.FusedTransformerEncoderLayer`: B1
    12 launches forward, B2/B3 12 backward, every call held against its
    plain version (`flash_path_check`), the loss within ROUTE_RTOL of the
    route's predicate false; the step's ms. Returns the launch counts."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as device_mod
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer

    device_mod._current = None
    t_phase = time.perf_counter()
    leg = INCUBATE_LEG
    paddle.seed(0)
    stack = paddle.nn.LayerList([
        FusedTransformerEncoderLayer(leg["width"], leg["heads"], leg["ffn"],
                                     dropout_rate=0.0)
        for _ in range(leg["layers"])])
    stack.to(dtype="bfloat16")
    x = paddle.to_tensor(np.random.default_rng(0).normal(
        size=(leg["batch"], leg["seq"], leg["width"])).astype(
        "float32")).astype("bfloat16")
    x.stop_gradient = False

    def loss_of():
        h = x
        for layer in stack:
            h = layer(h)
        return (h.astype("float32") ** 2).mean()

    reset_launches()
    with flash_calls(every=True) as seen:
        loss = loss_of()
        torch.cuda.synchronize(dev)
        fwd = dict(launch_counts())
        loss.backward()
        torch.cuda.synchronize(dev)
    after = dict(launch_counts())
    L = leg["layers"]
    counts = {"flash_fwd": (fwd["flash_fwd"], after["flash_fwd"] -
                            fwd["flash_fwd"]),
              "flash_bwd_dq": (fwd["flash_bwd_dq"], after["flash_bwd_dq"]),
              "flash_bwd_dkv": (fwd["flash_bwd_dkv"],
                                after["flash_bwd_dkv"])}
    want = {"flash_fwd": (L, 0), "flash_bwd_dq": (0, L),
            "flash_bwd_dkv": (0, L)}
    others = {k: v for k, v in after.items() if v and k not in want}
    worst = {}
    for i, (f, bw) in enumerate(zip(seen["fwd"], seen["bwd"])):
        r = flash_path_check(torch, {"fwd": f, "bwd": bw},
                             f"incubate: encoder layer {i}'s B1 call, "
                             f"B2/B3 call {i} of the backward", quiet=True)
        for k, v in r.items():
            worst[k] = max(worst.get(k, 0.0), v)
    n_checked = (len(seen["fwd"]), len(seen["bwd"]))
    seen = None
    with plain_route():
        plain_loss = loss_of().item()
    rel = abs(loss.item() - plain_loss) / abs(plain_loss)
    finite = math.isfinite(loss.item())

    def step():
        x.clear_grad()
        stack.clear_gradients()
        loss_of().backward()

    for _ in range(leg["warmup"]):
        step()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(leg["steps"]):
        step()
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / leg["steps"]
    log(f"[incubate] {L} FusedTransformerEncoderLayer({leg['width']}, "
        f"{leg['heads']}, {leg['ffn']}, dropout_rate=0.0), bf16, b "
        f"{leg['batch']} s {leg['seq']}: launches (forward, backward) "
        f"{counts} (want {want}; others {others}); {n_checked[0]} B1 and "
        f"{n_checked[1]} B2/B3 calls each held against the plain versions, "
        f"worst over the calls {({k: round(v, 4) for k, v in worst.items()})}; "
        f"loss {loss.item():.6f} finite {finite}, the route's predicate false "
        f"{plain_loss:.6f} (rel {rel:.3e}, bar {ROUTE_RTOL}); forward + "
        f"backward {ms:.2f} ms a step (mean of {leg['steps']} after "
        f"{leg['warmup']} warm-up); phase {time.perf_counter() - t_phase:.1f} s")
    if not (counts == want and not others and finite and rel <= ROUTE_RTOL
            and n_checked == (L, L)):
        raise AssertionError(f"incubate: launches {counts} {others}, loss "
                             f"{loss.item()} vs {plain_loss}, checked "
                             f"{n_checked}")
    return after


# the debug phase: the nan/inf checker of amp.debugging on the card, and
# the eager Llama step with the waist's hooks off beside the eager phase's
DEBUG_STEPS = dict(warmup=2, steps=8)
STEP_MS = {}   # the eager phase's bf16 eager step, for the debug phase


# the jit phase: the layer Llama at Llama-2-7B width, 2 layers, seed 0,
# through to_static, SOT and a static Program (jit, jit.sot, static)
JIT_LEG = dict(layers=2, batch=1, seq=2048, warmup=2, steps=8, calls=3,
               lr=1e-4)
JIT_BARS = {"bf16": 2e-2, "f32": 1e-5, "loss_rel": 1e-5, "grad_rel": 1e-5,
            "param_rel": 1e-5}
# launches a to_static call (B1, B9), and a SOT or static training step
JIT_A_CALL = {"flash_fwd": 2, "rms_norm_fwd": 5}
JIT_A_STEP = {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
              "rms_norm_fwd": 5, "rms_norm_bwd": 5}


def _launched():
    return {k: v for k, v in launch_counts().items() if v}


def _median_ms(torch, dev, fn, warmup, steps):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(steps):
        times.append(_sync_ms(torch, dev, fn)[1])
    return sorted(times)[len(times) // 2]


def _profiled(torch, dev, fn):
    """(device ms, kernel launches) of one fn() under torch.profiler, or
    (None, None) when it sees no device activity. The window opens with
    PROFILE_PAD_KERNELS throwaway kernels, left out (`_b8_share`: late in
    the run a session can lose its first device records)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize(dev)
        fn()
        torch.cuda.synchronize(dev)
    kern = [e for e in prof.events() if str(e.device_type).endswith("CUDA")
            and e.time_range.end > e.time_range.start
            and "spin_kernel" not in e.name]
    if not kern:
        return None, None
    return (sum(e.time_range.end - e.time_range.start for e in kern) / 1e3,
            len(kern))


def _jit_model(paddle, cfg):
    """The leg's model, seed 0: every call gives the same weights."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    paddle.seed(0)
    return LlamaForCausalLM(cfg)


def _jit_to_static(torch, dev, paddle, cfg, ids, dtype, total):
    """(a) one leg of `to_static` in eval mode: the compiled call's logits
    against the eager layer's (||d|| / ||eager||), JIT_A_CALL launches a
    call, the operators in the graph, no fallback; the compile seconds, the
    ms a call compiled and eager, one profiled call."""
    model = _jit_model(paddle, cfg)
    if dtype == "bfloat16":
        model = paddle.amp.decorate(model, level="O2", dtype="bfloat16")
    model.eval()
    base = paddle.jit.fallback_count()
    sf = paddle.jit.to_static(model)
    with paddle.no_grad():
        ref = model(ids)._data
    reset_launches()
    out, first_ms = _sync_ms(torch, dev, lambda: sf(ids))
    (prog,) = sf.programs()
    reset_launches()
    out = sf(ids)
    torch.cuda.synchronize(dev)
    got = _launched()
    _add(total, got)
    rel = _rel(torch, out._data.float(), ref.float())
    targets = prog.graph_targets()
    nodes = {op: targets.count(f"paddle_tpu_torch.{op}.default")
             for op in ("flash_fwd", "rms_norm")}
    leg = JIT_LEG
    ms = _median_ms(torch, dev, lambda: sf(ids), leg["warmup"], leg["steps"])
    with paddle.no_grad():
        eager_ms = _median_ms(torch, dev, lambda: model(ids), leg["warmup"],
                              leg["steps"])
    dev_ms, n_kern = _profiled(torch, dev, lambda: sf(ids))
    bar = JIT_BARS["bf16" if dtype == "bfloat16" else "f32"]
    log(f"[jit] (a) to_static {dtype}, eval, b {leg['batch']} s "
        f"{leg['seq']}: logits ||d||/||eager|| {rel:.3e} (bar {bar}); "
        f"launches a call {got} (want {JIT_A_CALL}); graph nodes {nodes}; "
        f"fallbacks {paddle.jit.fallback_count() - base}; trace "
        f"{prog.trace_seconds:.1f} s, first call (inductor compile "
        f"included) {first_ms / 1e3:.1f} s; a call compiled {ms:.3f} ms, "
        f"eager {eager_ms:.3f} ms (median of {leg['steps']} after "
        f"{leg['warmup']}); one profiled call: device "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'}, "
        f"{n_kern} kernels")
    if not (rel <= bar and got == JIT_A_CALL and nodes == {
            "flash_fwd": 2, "rms_norm": 5}
            and paddle.jit.fallback_count() == base and out.stop_gradient):
        raise AssertionError(f"jit to_static {dtype}: rel {rel}, launches "
                             f"{got}, nodes {nodes}")
    return first_ms / 1e3


def _grads(model):
    return {k: p.grad._data.clone() for k, p in model.named_parameters()}


def _jit_sot(torch, dev, paddle, cfg, batches, total):
    """(b) SOT training: `to_static(model, full_graph=False)` in train mode
    (dropout 0), loss and backward for each batch against the eager layer
    on the same ids; 1 capture, 2 hits, 0 eager calls; JIT_A_STEP launches
    a replayed step."""
    model = _jit_model(paddle, cfg)
    model.train()
    sot = paddle.jit.to_static(model, full_graph=False)
    worst, loss_worst, per_step, secs = ("", 0.0), 0.0, [], []
    for i, (ids, labels) in enumerate(batches):
        model.clear_gradients()
        reset_launches()
        t0 = time.perf_counter()
        loss = sot(ids, labels=labels)
        loss.backward()
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
        per_step.append(_launched())
        got = _grads(model)
        lval = loss.item()
        model.clear_gradients()
        ref = model(ids, labels=labels)
        ref.backward()
        loss_worst = max(loss_worst, abs(lval - ref.item()) / abs(ref.item()))
        for k, p in model.named_parameters():
            r = _rel(torch, got[k], p.grad._data)
            if not math.isfinite(r) or r >= worst[1]:
                worst = (k, r)
        got = None
    for counts in per_step[1:]:
        _add(total, counts)
    rep = sot.report()
    log(f"[jit] (b) SOT f32 (TF32 off), train, dropout 0, "
        f"{len(batches)} calls on different ids: captures "
        f"{rep['captures']}, hits {rep['hits']}, eager calls "
        f"{rep['eager_calls']}; worst loss rel {loss_worst:.3e} (bar "
        f"{JIT_BARS['loss_rel']}); worst grad leaf {worst[0]} ||d||/||ref|| "
        f"{worst[1]:.3e} (bar {JIT_BARS['grad_rel']}); launches a replayed "
        f"step {per_step[1:]} (want {JIT_A_STEP}); seconds a call "
        f"(capture, replays; the first replay compiles) "
        f"{[round(s, 2) for s in secs]}")
    if not ((rep["captures"], rep["hits"], rep["eager_calls"]) == (1, 2, 0)
            and loss_worst <= JIT_BARS["loss_rel"]
            and worst[1] <= JIT_BARS["grad_rel"]
            and all(c == JIT_A_STEP for c in per_step[1:])):
        raise AssertionError(f"jit SOT: {rep}, loss {loss_worst}, worst "
                             f"{worst}, launches {per_step}")
    return secs[1]


def _jit_static(torch, dev, paddle, cfg, batches, total):
    """(c) a static Program: `static.data` ids and labels, the loss of
    `model(ids, labels=labels)`, AdamW over a StepDecay minimized,
    len(batches) Executor runs with the scheduler stepped between them,
    against as many eager AdamW steps of an equal copy: each loss, and
    every parameter after the last; JIT_A_STEP launches a run."""
    import numpy as np

    leg = JIT_LEG
    model, twin = _jit_model(paddle, cfg), _jit_model(paddle, cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    sched = paddle.optimizer.lr.StepDecay(learning_rate=leg["lr"],
                                          step_size=1, gamma=0.5)
    paddle.enable_static()
    try:
        with paddle.static.program_guard(paddle.static.Program(),
                                         paddle.static.Program()):
            ids = paddle.static.data("ids", [leg["batch"], leg["seq"]],
                                     "int64")
            labels = paddle.static.data("labels",
                                        [leg["batch"], leg["seq"]], "int64")
            loss = model(ids, labels=labels)
            paddle.optimizer.AdamW(learning_rate=sched).minimize(loss)
            exe = paddle.static.Executor()
            losses, per_run, secs, lrs = [], [], [], []
            for a, b in batches:
                reset_launches()
                lrs.append(sched.get_lr())
                t0 = time.perf_counter()
                (lv,) = exe.run(feed={"ids": a.numpy(), "labels": b.numpy()},
                                fetch_list=[loss])
                torch.cuda.synchronize(dev)
                secs.append(time.perf_counter() - t0)
                per_run.append(_launched())
                losses.append(float(np.asarray(lv)))
                sched.step()
    finally:
        paddle.disable_static()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    for counts in per_run:
        _add(total, counts)
    sched2 = paddle.optimizer.lr.StepDecay(learning_rate=leg["lr"],
                                           step_size=1, gamma=0.5)
    opt = paddle.optimizer.AdamW(learning_rate=sched2,
                                 parameters=twin.parameters())
    ref = []
    for a, b in batches:
        lv = twin(a, labels=b)
        lv.backward()
        opt.step()
        opt.clear_grad()
        sched2.step()
        ref.append(lv.item())
    loss_worst = max(abs(g - r) / abs(r) for g, r in zip(losses, ref))
    worst = ("", 0.0)
    sd2 = twin.state_dict()
    for k, p in model.state_dict().items():
        r = _rel(torch, p._data, sd2[k]._data)
        if not math.isfinite(r) or r >= worst[1]:
            worst = (k, r)
    log(f"[jit] (c) static Program f32 (TF32 off), AdamW over StepDecay "
        f"(lr per run {lrs}), {len(batches)} Executor runs: losses "
        f"{[round(v, 6) for v in losses]}, eager {[round(v, 6) for v in ref]}"
        f" (worst rel {loss_worst:.3e}, bar {JIT_BARS['loss_rel']}); worst "
        f"parameter after the last step {worst[0]} ||d||/||ref|| "
        f"{worst[1]:.3e} (bar {JIT_BARS['param_rel']}); launches a run "
        f"{per_run} (want {JIT_A_STEP}); seconds a run (the first traces "
        f"and compiles) {[round(s, 2) for s in secs]}; peak "
        f"{peak:.1f} GiB (the twin's weights, gradients and moments among "
        f"it)")
    if not (loss_worst <= JIT_BARS["loss_rel"]
            and worst[1] <= JIT_BARS["param_rel"]
            and all(c == JIT_A_STEP for c in per_run)):
        raise AssertionError(f"jit static: losses {losses} vs {ref}, worst "
                             f"{worst}, launches {per_run}")
    PEAK_SEEN.append(torch.cuda.max_memory_allocated(dev))
    return secs[0]


def _jit_dy2static(torch, dev, paddle):
    """(d) a function with a tensor-dependent if and while, converted and
    compiled on CUDA tensors: torch.cond and while_loop in its graph, the
    result equal to its eager run."""
    import numpy as np

    def f(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = x - 1.0
        n = paddle.zeros([1])
        while y.abs().sum() < 1000.0:
            y = y * 2.0
            n = n + 1.0
        return y, n

    sf = paddle.jit.to_static(f)
    rng = np.random.default_rng(0)
    outs = []
    for sign in (1.0, -1.0):
        x = paddle.to_tensor((sign * np.abs(rng.normal(size=(64,))))
                             .astype(np.float32))
        got, ref = sf(x), f(x)
        outs.append((float((got[0] - ref[0]).abs().max()),
                     float((got[1] - ref[1]).abs().max())))
    targets = {t for p in sf.programs() for t in p.graph_targets()}
    hops = sorted(t for t in targets if t.startswith("higher_order."))
    log(f"[jit] (d) dy2static on {dev}: max |compiled - eager| {outs}; "
        f"control flow in the graph {hops}; fallbacks "
        f"{paddle.jit.fallback_report()}")
    if not (all(a == 0.0 and b == 0.0 for a, b in outs)
            and {"higher_order.cond", "higher_order.while_loop"} <=
            set(hops) and sf.programs()[0].device_type == "cuda"):
        raise AssertionError(f"jit dy2static: {outs}, {hops}")


def phase_jit(torch, dev):
    """`jit.to_static`, SOT and a static Program on the layer Llama at
    Llama-2-7B width (JIT_LEG, seed 0): (a) to_static in bf16 (amp.decorate
    O2) and in f32 against the eager layer, (b) SOT training, (c) a static
    Program training with AdamW, (d) dy2static's torch.cond and while_loop
    compiled. Returns the launch counts of the checked calls."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as device_mod
    from paddle_tpu_torch.models import LlamaConfig

    device_mod._current = None
    t_phase = time.perf_counter()
    leg = JIT_LEG
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=leg["layers"])
    rng = np.random.default_rng(0)

    def draw():
        return paddle.to_tensor(rng.integers(
            0, cfg.vocab_size, (leg["batch"], leg["seq"])).astype(np.int64))

    total = {k: 0 for k in launch_counts()}
    compile_s = {}
    ids = draw()
    compile_s["to_static f32"] = _jit_to_static(torch, dev, paddle, cfg, ids,
                                                "float32", total)
    torch.cuda.empty_cache()
    compile_s["to_static bf16"] = _jit_to_static(torch, dev, paddle, cfg,
                                                 ids, "bfloat16", total)
    torch.cuda.empty_cache()
    batches = [(draw(), draw()) for _ in range(leg["calls"])]
    compile_s["sot"] = _jit_sot(torch, dev, paddle, cfg, batches, total)
    torch.cuda.empty_cache()
    compile_s["static"] = _jit_static(torch, dev, paddle, cfg, batches,
                                      total)
    torch.cuda.empty_cache()
    _jit_dy2static(torch, dev, paddle)
    log(f"[jit] seconds of the first compiled call of each leg (trace and "
        f"inductor compile included): "
        f"{ {k: round(v, 1) for k, v in compile_s.items()} }; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return total


ANALYSIS_LEG = dict(layers=2, batch=1, seq=2048, loss_chunk=128,
                    rows=8, page_size=16, max_len=2048,
                    prompts=(2047, 1790, 1500, 1100, 777, 400, 129, 17),
                    gpt_prompts=(16, 37, 64), gpt_new=8)
ANALYSIS_BARS = {"loss_rel": 1e-5, "param_rel": 1e-5}   # JIT_BARS
# the audited 7B-width train step's kernel nodes, and the launches one
# run of its program makes (2 layers: B1-B3 a layer, B9/B10 a norm)
ANALYSIS_A_NODES = {"paddle_tpu_torch.flash_fwd.default": 2,
                    "paddle_tpu_torch.flash_bwd.default": 2,
                    "paddle_tpu_torch.rms_norm.default": 5,
                    "paddle_tpu_torch.rms_norm_bwd.default": 5}
ANALYSIS_A_STEP = {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                   "rms_norm_fwd": 5, "rms_norm_bwd": 5}


def _tree_clone(torch, tree):
    import torch.utils._pytree as pytree

    return pytree.tree_map(
        lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t,
        tree)


def _storages(torch, tree):
    import torch.utils._pytree as pytree

    return [t.untyped_storage().data_ptr() for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _audit_line(label, prog, violations, card, extra=""):
    from paddle_tpu_torch.analysis import base

    kernels = {k.split(".")[1]: v for k, v in prog.node_counts().items()
               if k.startswith("paddle_tpu_torch.")}
    log(f"[analysis] {label}: {base.format_violations(violations)}; "
        f"kernel nodes {kernels}{extra} ({card})")
    if violations:
        raise AssertionError(f"analysis {label}: {violations}")
    return kernels


def _analysis_train(torch, dev, card, total):
    """(a) the train step at 7B width: audited in bf16 moments, then the
    f32-moment program run on the card beside eager `train_batch`."""
    import numpy as np
    from paddle_tpu_torch.analysis import buffer_audit, presets, programs
    from paddle_tpu_torch.distributed.hybrid_engine import \
        HybridParallelEngine
    from paddle_tpu_torch.models import LLAMA2_7B

    leg = ANALYSIS_LEG
    args = LLAMA2_7B._replace(num_layers=leg["layers"])
    rng = np.random.default_rng(0)
    ids = rng.integers(0, args.vocab_size, (leg["batch"], leg["seq"]))
    labels = rng.integers(0, args.vocab_size, (leg["batch"], leg["seq"]))

    def engine(moments):
        return HybridParallelEngine(
            args, dtype=torch.bfloat16, remat=False,
            loss_chunk=leg["loss_chunk"], moments=moments,
            master_weights=True, device=dev)

    eng = engine("bf16")
    params, opt = eng.init_state(0)
    ids_t, labels_t = eng.shard_batch(ids, labels)
    t0 = time.perf_counter()
    prog = programs.train_step_trace(eng, params, opt, ids_t, labels_t,
                                     name="train_step_7b")
    trace_s = time.perf_counter() - t0
    bsv = prog.meta["forbidden_shape"]
    nodes = _audit_line(
        f"(a) train step, 7B width {leg['layers']} layers b{leg['batch']} "
        f"s{leg['seq']}, bf16 params, bf16 moments, f32 master weights, "
        f"loss_chunk {leg['loss_chunk']}, traced on {dev} in "
        f"{trace_s:.1f} s ({len(prog.graph_module.graph.nodes)} nodes; "
        f"{bsv} absent)", prog, presets.audit_train(prog), card)
    want = {k.split(".")[1]: v for k, v in ANALYSIS_A_NODES.items()}
    if {k: nodes.get(k, 0) for k in want} != want:
        raise AssertionError(f"analysis (a) kernel nodes {nodes} != {want}")
    for row in buffer_audit.top_intermediates(prog, k=5):
        log(f"[analysis]   top intermediate {row['shape']} {row['dtype']} "
            f"{row['nbytes'] / 2**20:.1f} MB @ {row['provenance']}")
    prog = params = opt = eng = None
    torch.cuda.empty_cache()

    eng = engine("f32")
    params, opt = eng.init_state(0)
    params2, opt2 = _tree_clone(torch, params), _tree_clone(torch, opt)
    prog = programs.train_step_trace(eng, params2, opt2, ids_t, labels_t,
                                     name="train_step_7b_f32")
    if presets.audit_train(prog):
        raise AssertionError(f"analysis (a) f32: {presets.audit_train(prog)}")
    reset_launches()
    loss_e, eager_ms = _sync_ms(
        torch, dev, lambda: eng.train_batch(params, opt, ids, labels)[0])
    eager_launch = _launched()
    state2 = {k: v for k, v in opt2.items() if k != "step"}
    before = _storages(torch, (params2, state2))
    reset_launches()
    loss_g, prog_ms = _sync_ms(
        torch, dev, lambda: prog.run(params2, state2, ids_t, labels_t))
    launched = _launched()
    _add(total, launch_counts())
    moved = before != _storages(torch, (params2, state2))
    loss_rel = abs(float(loss_g) - float(loss_e)) / abs(float(loss_e))
    worst = max(((k, _rel(torch, a, b)) for (k, a), (_, b) in zip(
        _leaves(params2), _leaves(params))), key=lambda kv: kv[1])
    log(f"[analysis] (a) the f32-moment program run on the card from eager "
        f"train_batch's starting state: loss {float(loss_g):.6f} vs eager "
        f"{float(loss_e):.6f} (rel {loss_rel:.2e}, bar "
        f"{ANALYSIS_BARS['loss_rel']}); worst param {worst[0]} "
        f"||d||/||ref|| {worst[1]:.2e} (bar {ANALYSIS_BARS['param_rel']}); "
        f"launches {launched} (eager {eager_launch}); state storages moved: "
        f"{moved}; step ms program {prog_ms:.1f} vs eager {eager_ms:.1f} "
        f"(first calls) ({card})")
    if launched != ANALYSIS_A_STEP or moved or \
            not loss_rel <= ANALYSIS_BARS["loss_rel"] or \
            not worst[1] <= ANALYSIS_BARS["param_rel"]:
        raise AssertionError(f"analysis (a) run: launches {launched}, "
                             f"moved {moved}, loss {loss_rel}, {worst}")
    times = {"program": [], "eager": []}
    for _ in range(3):
        times["eager"].append(_sync_ms(torch, dev, lambda: eng.train_batch(
            params, opt, ids, labels))[1])
        times["program"].append(_sync_ms(torch, dev, lambda: prog.run(
            params2, state2, ids_t, labels_t))[1])
    med = {k: sorted(v)[1] for k, v in times.items()}
    log(f"[analysis] (a) step ms, median of 3 after the first: program "
        f"{med['program']:.1f}, eager {med['eager']:.1f} ({card})")
    return trace_s


def _decode_requests(np, vocab, prompts, seed):
    from paddle_tpu_torch.serving import Request

    rng = np.random.default_rng(seed)
    return [Request(rng.integers(1, vocab, n).astype(np.int32),
                    max_new_tokens=2) for n in prompts]


def _analysis_paged(torch, dev, card, model, kv_dtype, total):
    """(b) the paged decode step over a bf16 or an int8 pool at 7B width,
    8 ragged rows to pos 2047: captured from a PagedEngine, audited, then
    its program run beside the eager step on the same inputs."""
    import numpy as np
    from paddle_tpu_torch.analysis import presets, programs
    from paddle_tpu_torch.models import generation as gen
    from paddle_tpu_torch.serving import PagedEngine

    leg = ANALYSIS_LEG
    label = "int8 pool" if kv_dtype else "bf16 pool"
    key = ("paged_decode_attention_int8" if kv_dtype
           else "paged_decode_attention")
    op = "paged_decode_attention_q8" if kv_dtype else "paged_decode_attention"
    eng = PagedEngine(model, max_slots=leg["rows"], max_len=leg["max_len"],
                      page_size=leg["page_size"], kv_dtype=kv_dtype,
                      device=dev)
    rec = programs._Recorder(gen._paged_forward_decode)
    with programs.patched(gen, "_paged_forward_decode", rec):
        eng.serve(_decode_requests(np, model.args.vocab_size, leg["prompts"],
                                   1))
    t0 = time.perf_counter()
    prog = rec.trace(f"paged_decode_7b{'_int8' if kv_dtype else ''}",
                     donated=(2, 3))
    trace_s = time.perf_counter() - t0
    pos = rec.args[5]
    nodes = _audit_line(
        f"(b) paged decode, {label}, b {leg['rows']} rows at pos "
        f"{pos.tolist()}, page size {leg['page_size']}, traced in "
        f"{trace_s:.1f} s", prog, presets.audit_program(prog), card)
    if nodes.get(op) != model.args.num_layers:
        raise AssertionError(f"analysis (b) {label}: nodes {nodes}")
    a_args = _tree_clone(torch, rec.args[1:])
    b_args = _tree_clone(torch, rec.args[1:])
    reset_launches()
    logits_e, pk_e, pv_e = gen._paged_forward_decode(model, *a_args,
                                                     **rec.kwargs)
    torch.cuda.synchronize(dev)
    eager = launch_counts()[key]
    before = _storages(torch, b_args[1:3])
    reset_launches()
    logits_g, pk_g, pv_g = prog.run(model, *b_args, **rec.kwargs)
    torch.cuda.synchronize(dev)
    launched = _launched()
    _add(total, launch_counts())
    moved = before != _storages(torch, b_args[1:3])
    import torch.utils._pytree as pytree

    same = [torch.equal(a, b) for a, b in zip(
        pytree.tree_leaves((logits_e, pk_e, pv_e)),
        pytree.tree_leaves((logits_g, pk_g, pv_g)))]
    diff = (logits_g.float() - logits_e.float()).abs().max().item()
    log(f"[analysis] (b) {label}: the program on the card vs eager "
        f"_paged_forward_decode on the same inputs: logits and pools equal "
        f"bit for bit {all(same)} (max |d| logits {diff:.3e}); launches "
        f"{launched} (eager {key} {eager}); pool storages moved: {moved} "
        f"({card})")
    if not all(same) or launched.get(key) != model.args.num_layers or \
            eager != model.args.num_layers or moved:
        raise AssertionError(f"analysis (b) {label}: equal {same}, max |d| "
                             f"{diff}, launches {launched}, eager {eager}, "
                             f"moved {moved}")
    return trace_s


def _analysis_gpt(torch, dev, card, total):
    """(c) GPT-2 small from layers, as `_configs_gpt` builds it: the
    GptEngine's prefill and decode programs captured, audited, and run
    beside eager: B5 and B4 at eager's counts, logits equal."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.analysis import presets, programs
    from paddle_tpu_torch.framework import device as device_mod
    from paddle_tpu_torch.models import (Gpt, GPTConfig, GPTForCausalLM,
                                         GPTGenArgs, gpt_params_from_layer)
    from paddle_tpu_torch.models import gpt as gpt_m
    from paddle_tpu_torch.serving.router import GptEngine

    leg = ANALYSIS_LEG
    device_mod._current = None
    paddle.seed(0)
    cfg = GPTConfig()
    layer = GPTForCausalLM(cfg)
    layer.eval()
    model = Gpt(GPTGenArgs.from_config(cfg), gpt_params_from_layer(layer))
    layer = None
    eng = GptEngine(model, max_slots=4, max_len=256, min_bucket=16,
                    device=dev)
    recs = {}
    for name, method in (("gpt_prefill", "_prefill_device"),
                         ("gpt_decode", "_decode_device")):
        recs[name] = programs._Recorder(gpt_m._gpt_forward_cached)
        setattr(eng, method, programs._within(
            getattr(eng, method), gpt_m, "_gpt_forward_cached", recs[name]))
    eng.serve(_decode_requests(np, cfg.vocab_size, leg["gpt_prompts"], 2))
    for name, key, in (("gpt_prefill", "window_attention"),
                       ("gpt_decode", "decode_attention")):
        rec = recs[name]
        prog = rec.trace(name + "_small", donated=(2, 3))
        nodes = _audit_line(f"(c) GPT-2 small {name}", prog,
                            presets.audit_program(prog), card)
        a_args = _tree_clone(torch, rec.args[1:])
        b_args = _tree_clone(torch, rec.args[1:])
        reset_launches()
        logits_e = gpt_m._gpt_forward_cached(model, *a_args,
                                             **rec.kwargs)[0]
        torch.cuda.synchronize(dev)
        eager = _launched()
        reset_launches()
        logits_g = prog.run(model, *b_args, **rec.kwargs)[0]
        torch.cuda.synchronize(dev)
        launched = _launched()
        _add(total, launch_counts())
        diff = (logits_g - logits_e).abs().max().item()
        log(f"[analysis] (c) {name}: program launches {launched}, eager "
            f"{eager}; logits equal {torch.equal(logits_g, logits_e)} "
            f"(max |d| {diff:.3e}) ({card})")
        if launched != eager or not launched.get(key) or \
                nodes.get(key) != launched[key] or \
                not torch.equal(logits_g, logits_e):
            raise AssertionError(f"analysis (c) {name}: {launched} vs "
                                 f"{eager}, nodes {nodes}, max |d| {diff}")


def _analysis_toy(torch, dev, card, total):
    """(d) `python -m paddle_tpu_torch.analysis --report`'s audit on the
    card: every family at TOY_CARD, held to BYTE_CEILINGS_CARD; returns
    its seconds."""
    from paddle_tpu_torch.analysis import __main__ as cli
    from paddle_tpu_torch.analysis import base, presets

    reset_launches()
    t0 = time.perf_counter()
    violations = presets.run_cpu_audits(device=dev)
    seconds = time.perf_counter() - t0
    _add(total, launch_counts())
    log(f"[analysis] (d) the toy families on the card (TOY_CARD, "
        f"{', '.join(presets.FAMILIES)}) in {seconds:.1f} s: "
        f"{base.format_violations(violations)} ({card}); each program's "
        "largest intermediate:")
    cli.report(dev)
    if violations:
        raise AssertionError(f"analysis (d): {violations}")
    return seconds


def phase_analysis(torch, dev, card):
    """The program audits at Llama-2-7B width (ANALYSIS_LEG, seed 0): (a)
    the train step traced with make_fx over fake CUDA tensors and audited
    (no (b, s, vocab) buffer, the bf16 policy with the port's allowlist,
    no host sync, state written in place, no collective; B1-B3/B9/B10
    nodes), its f32-moment program run on the card beside eager
    train_batch (the same launches, loss and params within 1e-5); (b) the
    paged decode step over a bf16 and an int8 pool, audited, its program
    bit-equal to eager with B6/B7 2 a step; (c) GPT-2 small's GptEngine
    programs launching B4/B5 as eager; (d) every toy family audited on the
    card against its ceilings. Returns the launch counts of the programs'
    runs and of the toy engines' requests."""
    from paddle_tpu_torch.models import LLAMA2_7B, Llama, init_params

    t_phase = time.perf_counter()
    total = {k: 0 for k in launch_counts()}
    trace_s = {"train": _analysis_train(torch, dev, card, total)}
    torch.cuda.empty_cache()
    args = LLAMA2_7B._replace(num_layers=ANALYSIS_LEG["layers"])
    gen_ = torch.Generator(device=dev).manual_seed(0)
    model = Llama(args, init_params(args, gen_, device=dev,
                                    dtype=torch.bfloat16))
    for kv in (None, "int8"):
        trace_s[f"decode {kv or 'bf16'}"] = _analysis_paged(
            torch, dev, card, model, kv, total)
        torch.cuda.empty_cache()
    model = None
    _analysis_gpt(torch, dev, card, total)
    torch.cuda.empty_cache()
    trace_s["toy"] = _analysis_toy(torch, dev, card, total)
    rounded = {k: round(v, 1) for k, v in trace_s.items()}
    log(f"[analysis] trace seconds {rounded}; phase "
        f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return total


def phase_device(torch, dev, card):
    """`paddle.device` on the card: F.rms_norm at 7B width (B9 forward,
    B10 backward) under `stream_guard` on a side stream gives the default
    stream's bits, bracketed by an Event's record/synchronize/query; the
    memory statistics equal torch.cuda's."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as device_mod
    from paddle_tpu_torch.kernels import rms_norm as rn

    device_mod._current = None
    F = paddle.nn.functional
    x, w, g = rms_case(torch, dev, 2048, 4096, torch.bfloat16)

    def norm():
        xt = paddle.Tensor(x.clone(), stop_gradient=False)
        wt = paddle.Tensor(w.clone(), stop_gradient=False)
        y = F.rms_norm(xt, wt, RMS_EPS)
        y.backward(paddle.Tensor(g))
        return y._data, xt.grad._data, wt.grad._data

    reset_launches()
    ref = norm()
    torch.cuda.synchronize(dev)
    side = paddle.device.Stream()
    start, end = paddle.device.Event(), paddle.device.Event()
    default = paddle.device.current_stream()
    side.wait_stream(default)
    with paddle.device.stream_guard(side):
        on_side = paddle.device.current_stream() == side
        start.record()
        got = norm()
        end.record()
    end.synchronize()
    done = end.query() and start.query()
    default.wait_stream(side)
    paddle.device.synchronize()
    launched = dict(rn.launches)
    same = [torch.equal(a, b) for a, b in zip(got, ref)]
    stats = {k: (getattr(paddle.device, k)(), getattr(torch.cuda, k)(dev))
             for k in ("memory_allocated", "max_memory_allocated",
                       "memory_reserved")}
    cuda_stats = (paddle.device.cuda.max_memory_allocated(),
                  torch.cuda.max_memory_allocated(dev))
    log(f"[device] F.rms_norm [2048, 4096] bf16 forward and backward under "
        f"stream_guard(side stream): current stream switched {on_side}, "
        f"back {paddle.device.current_stream() == default}; y, dx, dw equal "
        f"the default stream's bits {same}; Event record/synchronize/query "
        f"{done}; launches {launched} (2 of each); memory statistics "
        f"(paddle.device, torch.cuda) {stats}, cuda.max_memory_allocated "
        f"{cuda_stats} ({card})")
    if not (on_side and all(same) and done and
            paddle.device.current_stream() == default and
            launched == {"rms_norm_fwd": 2, "rms_norm_bwd": 2} and
            all(a == b for a, b in stats.values()) and
            cuda_stats[0] == cuda_stats[1]):
        raise AssertionError(f"device phase: {on_side} {same} {done} "
                             f"{launched} {stats} {cuda_stats}")
    return {k: v for k, v in launch_counts().items()}


def phase_debug(torch, dev):
    """`enable_tensor_checker` aborts with FloatingPointError naming the op
    on an injected inf (log, and a matmul over a tensor holding inf), at
    level 1 only logs; the hooks are None when off. Then the eager Llama
    step of the eager phase (EAGER_LEG, bf16) with the checker off and on,
    beside the eager phase's step."""
    import io

    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.amp import debugging
    from paddle_tpu_torch.core import tensor as core_tensor
    from paddle_tpu_torch.framework import device as device_mod
    from paddle_tpu_torch.models import LLAMA2_7B, init_params

    device_mod._current = None
    t_phase = time.perf_counter()
    x = paddle.to_tensor(np.array([1.0, 0.0, -1.0], "float32"))
    a = paddle.ones([64, 64])
    a._data[3, 5] = float("inf")
    caught = {}
    debugging.enable_tensor_checker()
    try:
        for op, fn in (("log", lambda: paddle.log(x)),
                       ("matmul", lambda: paddle.matmul(a, a))):
            try:
                fn()
                caught[op] = None
            except FloatingPointError as e:
                caught[op] = str(e)
        paddle.set_flags({"FLAGS_check_nan_inf_level": 1})
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            logged = paddle.log(x)
        logged = logged.place
    finally:
        paddle.set_flags({"FLAGS_check_nan_inf_level": 0})
        debugging.disable_tensor_checker()
    off = core_tensor._sanitizer is None and core_tensor._op_tracer is None
    log(f"[debug] enable_tensor_checker on {x.place}: {caught}; at "
        f"FLAGS_check_nan_inf_level 1 the log op ran on {logged} and "
        f"printed {buf.getvalue().strip()!r}; hooks None when off: {off}")
    if not (caught["log"] and "op 'log'" in caught["log"] and
            caught["matmul"] and "op 'matmul'" in caught["matmul"] and
            "op 'log'" in buf.getvalue() and off and x.place == dev):
        raise AssertionError(f"debug: checker {caught}, logged "
                             f"{buf.getvalue()!r}, hooks off {off}")

    args = LLAMA2_7B._replace(num_layers=EAGER_LEG["layers"])
    B, T = EAGER_LEG["batch"], EAGER_LEG["seq"]
    gen = torch.Generator(device=dev).manual_seed(0)
    base = init_params(args, gen, device=dev, dtype=torch.bfloat16)
    tree = _tree_map(lambda t: paddle.Tensor(t, stop_gradient=False), base)
    rng = np.random.default_rng(0)
    ids, labels = (paddle.Tensor(torch.from_numpy(rng.integers(
        0, args.vocab_size, (B, T)).astype(np.int64)).to(dev))
        for _ in range(2))

    def eager_step():
        for _, t in _leaves(tree):
            t.clear_grad()
        eager_llama_loss(paddle, tree, ids, labels, args).backward()

    def timed():
        for _ in range(DEBUG_STEPS["warmup"]):
            eager_step()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(DEBUG_STEPS["steps"]):
            eager_step()
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3 / DEBUG_STEPS["steps"]

    ms_off = timed()
    with contextlib.redirect_stdout(io.StringIO()), \
            debugging.collect_operator_stats():
        eager_step()
        n_outputs = sum(c for c, _, _ in debugging._op_stats.values())
    debugging.enable_tensor_checker()
    try:
        ms_on = timed()
    finally:
        debugging.disable_tensor_checker()
    eager_ms = STEP_MS.get("eager")
    log(f"[debug] the eager phase's bf16 Llama step (7B width, "
        f"{args.num_layers} layers, b {B} s {T}), mean of "
        f"{DEBUG_STEPS['steps']} after {DEBUG_STEPS['warmup']} warm-up: "
        f"checker off {ms_off:.2f} ms, on {ms_on:.2f} ms "
        f"({ms_on / ms_off:.3f}x: one host read for each of {n_outputs} op "
        f"outputs a step); the eager phase's step in this run "
        + (f"{eager_ms:.2f} ms (off / eager {ms_off / eager_ms:.3f}x)"
           if eager_ms else "not measured (eager phase not run)")
        + f"; phase {time.perf_counter() - t_phase:.1f} s")


# the functional phase: the op table's cases of the modules ported with
# A10a part 2 and nn.functional on the card against the port's own CPU
# results (the card test's bars, TF32 off for the whole run); F.rms_norm on
# B9/B10 at the 7B micro-batch's norm shape and off the gate; save/load of
# a 7B-width bf16 tree; the native core
FUNCTIONAL_MODULES = ("extras", "legacy_ps", "fft", "functional.activation",
                      "functional.common", "functional.norm",
                      "functional.loss", "functional.conv",
                      "functional.pooling", "functional.extra_fns",
                      "functional.flash_attention")
CARD_RTOL, CARD_ATOL = 1e-4, 1e-5
FUNCTIONAL_RMS = (2048, 4096)
STORE_MASTER = """
import sys
sys.path.insert(0, {root!r})
from paddle_tpu_torch.core import native
store = native.TCPStore("127.0.0.1", {port}, is_master=True, world_size=2)
store.set("from_master", b"card")
store.add("counter", 5)
store.wait("from_client", timeout=60.0)
store.set("echo", store.get("from_client") + b" echoed")
store.wait("done", timeout=60.0)
"""


def _functional_cases(torch, paddle, T):
    """Every case of FUNCTIONAL_MODULES (random ones aside) on cuda:0
    against the port on the CPU, forward and gradient."""
    import numpy as np

    cases = [c for c in T.cases(*FUNCTIONAL_MODULES) if c.check != "random"]
    bad = []
    for c in cases:
        paddle.set_device("cpu")
        ref, ref_grads = T.run(paddle, c)
        paddle.set_device("gpu")
        try:
            got, got_grads = T.run(paddle, c)
            T.compare(c, ref, got, rtol=CARD_RTOL, atol=CARD_ATOL)
            for i, r, g in zip(c.grad, ref_grads or (), got_grads or ()):
                assert (r is None) == (g is None), (c.id, i)
                if r is not None:
                    np.testing.assert_allclose(
                        g, r, rtol=CARD_RTOL, atol=CARD_ATOL,
                        err_msg=f"{c.id} grad of input {i}")
        except Exception as e:   # collected, then raised together below
            bad.append(f"{c.id}: {type(e).__name__}: {str(e)[:300]}")
    return len(cases), bad


def _functional_rms(torch, dev, paddle, rn):
    """F.rms_norm forward and backward on the card at FUNCTIONAL_RMS in
    bf16 and f32: B9 and B10 once each, within the rms_parity bars of the
    plain versions; off the gate (H 4100, mixed dtypes, weight=None) no
    launch. Returns the worst ratio to the bars."""
    F = paddle.nn.functional
    rows, h = FUNCTIONAL_RMS
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        x, w, g = rms_case(torch, dev, rows, h, dtype)
        xt = paddle.Tensor(x.clone(), stop_gradient=False)
        wt = paddle.Tensor(w.clone(), stop_gradient=False)
        reset_launches()
        y = F.rms_norm(xt, wt, RMS_EPS)
        torch.cuda.synchronize(dev)
        fwd = dict(rn.launches)
        y.backward(paddle.Tensor(g))
        torch.cuda.synchronize(dev)
        after = dict(rn.launches)
        y_ref, r_ref = rn.rms_norm_fwd_plain(x, w, RMS_EPS)
        dx_ref, dw_ref = rn.rms_norm_bwd_plain(x, w, r_ref, g)
        ratios = rms_ratios(torch, {"y": y._data, "dx": xt.grad._data,
                                    "dw": wt.grad._data},
                            {"y": y_ref, "dx": dx_ref, "dw": dw_ref}, dname)
        log(f"[functional] F.rms_norm [{rows}, {h}] {dname}: launches "
            f"forward {fwd}, after backward {after}; error / "
            "bar " + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()))
        if fwd != {"rms_norm_fwd": 1, "rms_norm_bwd": 0} or \
                after != {"rms_norm_fwd": 1, "rms_norm_bwd": 1} or \
                max(ratios.values()) > 1.0:
            raise AssertionError(f"functional rms_norm {dname}: {fwd}, "
                                 f"{after}, {ratios}")
        worst = max(worst, max(ratios.values()))
    gen = torch.Generator(device=dev).manual_seed(3)
    odd = torch.randn(rows, 4100, device=dev, generator=gen)
    xb = torch.randn(rows, h, device=dev, generator=gen)
    reset_launches()
    for a, b in ((odd, torch.ones(4100, device=dev)),
                 (xb.bfloat16(), torch.ones(h, device=dev)), (xb, None)):
        at = paddle.Tensor(a, stop_gradient=False)
        bt = None if b is None else paddle.Tensor(b, stop_gradient=False)
        F.rms_norm(at, bt).astype("float32").sum().backward()
    torch.cuda.synchronize(dev)
    log(f"[functional] F.rms_norm off the gate (H 4100; bf16 x with f32 w; "
        f"weight=None): launches {dict(rn.launches)}")
    if any(rn.launches.values()):
        raise AssertionError(f"off-gate rms_norm launched: {rn.launches}")
    return worst


def _functional_io(torch, dev, paddle):
    """paddle.save / paddle.load of the Llama-2-7B-width, 2-layer bf16
    parameter tree from the card: the same bits back, on cuda:0 with no
    place given (`dev`, the run's cuda:0). Returns (GB, save MB/s, load
    MB/s)."""
    import shutil
    import tempfile

    from paddle_tpu_torch.framework import device as device_mod
    from paddle_tpu_torch.models import LLAMA2_7B, init_params

    gen = torch.Generator(device=dev).manual_seed(0)
    tree = _tree_map(paddle.Tensor, init_params(
        LLAMA2_7B._replace(num_layers=2), gen, device=dev,
        dtype=torch.bfloat16))
    nbytes = sum(t._data.numel() * t._data.element_size()
                 for _, t in _leaves(tree))
    root = tempfile.mkdtemp(prefix="functional_io_")
    path = os.path.join(root, "llama7b_2l.pdparams")
    try:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        paddle.save(tree, path)
        t_save = time.perf_counter() - t0
        device_mod._current = None
        t0 = time.perf_counter()
        back = paddle.load(path)
        torch.cuda.synchronize(dev)
        t_load = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for (p, a), (q, b) in zip(_leaves(tree), _leaves(back)):
        if p != q or b._data.device != dev or \
                b._data.dtype != torch.bfloat16 or not torch.equal(
                    a._data.view(torch.int16), b._data.view(torch.int16)):
            raise AssertionError(f"functional save/load: leaf {p} / {q} "
                                 f"came back as {b._data.dtype} on "
                                 f"{b._data.device} or with other bits")
    mb = nbytes / 1e6
    log(f"[functional] paddle.save / paddle.load of the Llama-2-7B-width "
        f"2-layer bf16 tree ({nbytes / 1e9:.3f} GB, {len(_leaves(tree))} "
        f"leaves): the same bits back on {dev}; save {t_save:.2f} s "
        f"({mb / t_save:.1f} MB/s, from the card to a file under "
        f"{tempfile.gettempdir()}), load {t_load:.2f} s "
        f"({mb / t_load:.1f} MB/s, to the card)")
    return nbytes / 1e9, mb / t_save, mb / t_load


def _functional_native(paddle):
    """The native core builds here; a TCPStore set/get/add/wait between
    this process and a master in another; a flag set through set_flags
    reads back from the C++ registry; a watchdog fires."""
    import socket

    from paddle_tpu_torch.core import native
    from paddle_tpu_torch.framework import flags

    t0 = time.perf_counter()
    ok = native.available()
    log(f"[functional] native core: available() {ok} "
        f"({time.perf_counter() - t0:.1f} s, {native.library_path().name})")
    if not ok:
        raise AssertionError("functional: the native core did not build")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    proc = subprocess.Popen(
        [sys.executable, "-c", STORE_MASTER.format(root=str(ROOT),
                                                   port=port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        client = None
        for _ in range(200):
            try:
                client = native.TCPStore("127.0.0.1", port, world_size=2,
                                         timeout=5.0)
                break
            except RuntimeError:
                time.sleep(0.1)
        if client is None:
            raise AssertionError("functional: no TCPStore master listened")
        client.wait("from_master", timeout=30.0)
        got = (client.get("from_master"), client.add("counter", 2))
        client.set("from_client", b"client")
        echo = client.get("echo", timeout=30.0)
        client.set("done", "1")
        proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    saved = paddle.get_flags(["FLAGS_v"])
    paddle.set_flags({"FLAGS_v": 5})
    flag = native.flags_get("FLAGS_v")
    flags._flags.update(saved)
    fired = []
    wd = native.Watchdog(poll_interval=0.05,
                         on_timeout=lambda name, ms: fired.append(name))
    wd.begin("collective", timeout=0.1)
    deadline = time.time() + 5.0
    while not fired and time.time() < deadline:
        time.sleep(0.05)
    wd.stop()
    log(f"[functional] TCPStore between two processes: get {got[0]!r}, "
        f"add -> {got[1]}, echo {echo!r}, master exit {proc.returncode}; "
        f"set_flags FLAGS_v=5 reads back {flag!r} from the C++ registry; "
        f"watchdog fired {fired}")
    if got != (b"card", 7) or echo != b"client echoed" or \
            proc.returncode != 0 or flag != "5" or fired != ["collective"]:
        raise AssertionError(f"functional native: {got}, {echo}, "
                             f"{proc.returncode}, {flag}, {fired}")


def phase_functional(torch, dev):
    """A10a part 2 and nn.functional on the card (TF32 off, as for the
    whole run): every case of FUNCTIONAL_MODULES against the port on the
    CPU (rtol 1e-4, atol 1e-5, forward and gradient); F.rms_norm on B9/B10
    and off its gate; save/load of a 7B-width bf16 tree; the native
    core."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_op_cases as T

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as device_mod
    from paddle_tpu_torch.kernels import rms_norm as rn

    t0 = time.perf_counter()
    n, bad = _functional_cases(torch, paddle, T)
    log(f"[functional] {n - len(bad)} of {n} op cases (extras, legacy_ps, "
        f"fft, nn.functional) agree on cuda:0 with the port on the CPU at "
        f"rtol {CARD_RTOL}, atol {CARD_ATOL}, forward and gradient, TF32 "
        f"off ({time.perf_counter() - t0:.1f} s)")
    for line in bad:
        log(f"[functional]   {line}")
    device_mod._current = None
    worst = _functional_rms(torch, dev, paddle, rn)
    _functional_io(torch, dev, paddle)
    _functional_native(paddle)
    device_mod._current = None
    log(f"[functional] phase {time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError(f"functional: {len(bad)} op cases disagree")
    return worst


# A10g part 1 on the card: signal, geometric (with incubate's graph ops),
# sparse and distribution at the sizes their users run, each against the
# port on the CPU from the same seeded numpy inputs (TF32 off, as for the
# whole run). The graph is ogbn-arxiv's size (nodes, edges, features; made
# here from a seed, its in-degrees skewed like a citation graph's), the
# signal 10 s of 16 kHz audio in a batch of 8 at the usual speech STFT,
# the sparse matrix 16384^2 at 0.1% density, the distributions at an LLM
# vocabulary and a 64-dimensional Gaussian
NS_GRAPH = dict(nodes=169_343, edges=1_166_243, features=128, seeds=1024,
                sample=10, hops=(15, 10))
NS_SIGNAL = dict(batch=8, samples=160_000, n_fft=512, hop=160)
NS_SPARSE = dict(n=16384, density=1e-3, cols=128)
NS_DIST = dict(draws=1_000_000, batch=4096, mvn_d=64, classes=32000)
# the bars: max/min, integer and host-side outputs exact; a sum the card
# adds in another order (atomics, an FFT's butterflies, a sparse product,
# a reduction) within NS_SUM_RTOL of the sum of the absolute values of its
# terms; everything else elementwise at f32 rtol, atol
NS_SUM_RTOL = 1e-5
NS_RTOL, NS_ATOL = 1e-5, 1e-6


def _ns_sum_ratio(torch, got, ref, abs_sum):
    """max |got - ref| / (NS_SUM_RTOL * abs_sum): <= 1 is within the bar
    (abs_sum: the sum of |terms| of each output, computed on the CPU)."""
    d = (got.detach().cpu().double() - ref.detach().double()).abs()
    bar = NS_SUM_RTOL * abs_sum.detach().double().abs() + 1e-30
    return float((d / bar).max())


def _ns_close_ratio(torch, got, ref):
    """max |got - ref| / (atol + rtol |ref|), complex as its magnitude."""
    d = (got.detach().cpu() - ref.detach()).abs().double()
    return float((d / (NS_ATOL + NS_RTOL * ref.detach().abs().double()))
                 .max())


def _ns_exact(torch, got, ref):
    return bool(torch.equal(got.detach().cpu(), ref.detach()))


def _timed_ms(torch, dev, fn, reps=3):
    """The median wall ms of fn() ending in a synchronize, after one call."""
    fn()
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _ns_geometric(torch, dev, paddle, both, results, timings):
    import numpy as np

    g = NS_GRAPH
    rng = np.random.default_rng(0)
    n, e, f = g["nodes"], g["edges"], g["features"]
    feat = rng.standard_normal((n, f)).astype("float32")
    src = rng.integers(0, n, e).astype("int64")
    dst = np.minimum((n * rng.random(e) ** 2).astype("int64"), n - 1)
    w = (rng.random((e, 1)) + 0.5).astype("float32")
    G = paddle.geometric

    def sums(name, fn, absfn):
        card, cpu = both(fn)
        with on_cpu(paddle):
            ab = absfn()
        results[name] = ("sum", _ns_sum_ratio(torch, card._data, cpu._data,
                                              ab._data))

    def exact(name, fn):
        card, cpu = both(fn)
        results[name] = ("exact", _ns_exact(torch, card._data, cpu._data))

    T = paddle.to_tensor
    absx = np.abs(feat)
    for op in ("sum", "mean"):
        sums(f"send_u_recv {op}",
             lambda op=op: G.send_u_recv(T(feat), T(src), T(dst), op),
             lambda op=op: G.send_u_recv(T(absx), T(src), T(dst), op))
    for op in ("max", "min"):
        exact(f"send_u_recv {op}",
              lambda op=op: G.send_u_recv(T(feat), T(src), T(dst), op))
    sums("send_ue_recv mul sum",
         lambda: G.send_ue_recv(T(feat), T(w), T(src), T(dst), "mul", "sum"),
         lambda: G.send_ue_recv(T(absx), T(w), T(src), T(dst), "mul", "sum"))
    card, cpu = both(lambda: G.send_uv(T(feat), T(feat), T(src), T(dst),
                                       "add"))
    results["send_uv add"] = ("close", _ns_close_ratio(torch, card._data,
                                                       cpu._data))
    # segment ops over messages sorted by destination
    order = np.argsort(dst, kind="stable")
    ids = dst[order]
    msg = feat[src[order]]
    absm = np.abs(msg)
    for op in ("segment_sum", "segment_mean"):
        sums(op, lambda op=op: getattr(G, op)(T(msg), T(ids)),
             lambda op=op: getattr(G, op)(T(absm), T(ids)))
    for op in ("segment_max", "segment_min"):
        exact(op, lambda op=op: getattr(G, op)(T(msg), T(ids)))
    exact("incubate.graph_send_recv max",
          lambda: paddle.incubate.graph_send_recv(T(feat), T(src), T(dst),
                                                  "max"))
    # the samplers over the graph in CSC (neighbours of a node: the sources
    # of its in-edges), host-side, the same seed on both
    row = src[order]
    colptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n))])
    seeds = rng.choice(n, g["seeds"], replace=False).astype("int64")

    def sampled(fn):
        paddle.seed(7)
        return fn()

    card, cpu = both(lambda: sampled(lambda: G.sample_neighbors(
        T(row), T(colptr), T(seeds), sample_size=g["sample"])))
    results["sample_neighbors"] = ("exact", all(
        _ns_exact(torch, a._data, b._data) for a, b in zip(card, cpu))
        and card[0].place.type == "cuda")
    counts = card[1].numpy()
    card, cpu = both(lambda: sampled(lambda: G.khop_sampler(
        T(row), T(colptr), T(seeds), sample_sizes=list(g["hops"]))))
    results["khop_sampler"] = ("exact", all(
        _ns_exact(torch, a._data, b._data) for a, b in zip(card, cpu)))
    x = T(feat)
    si, di = T(src), T(dst)
    timings["geometric send_u_recv sum (ms)"] = _timed_ms(
        torch, dev, lambda: G.send_u_recv(x, si, di, "sum"))
    log(f"[namespaces] geometric: {n} nodes, {e} edges, {f} f32 features "
        f"(in-degree max {int(np.bincount(dst).max())}, seeds "
        f"{g['seeds']}: sample_neighbors drew {int(counts.sum())} of size "
        f"{g['sample']}, khop {list(g['hops'])} reached "
        f"{card[2].shape[0]} nodes over {card[0].shape[0]} edges)")


def _ns_signal(torch, dev, paddle, both, results, timings):
    import numpy as np

    from paddle_tpu_torch import signal as S

    c = NS_SIGNAL
    rng = np.random.default_rng(1)
    x = rng.standard_normal((c["batch"], c["samples"])).astype("float32")
    n_fft, hop = c["n_fft"], c["hop"]
    win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)).astype(
        "float32")
    T = paddle.to_tensor
    kw = dict(n_fft=n_fft, hop_length=hop)
    spec_card, spec_cpu = both(lambda: S.stft(T(x), window=T(win), **kw))
    # a bin is a sum over the frame: the sum of |terms| is the frame's
    # windowed L1 norm (|e^{i theta}| = 1)
    with on_cpu(paddle):
        pad = n_fft // 2
        xp = torch.nn.functional.pad(torch.from_numpy(x)[:, None],
                                     (pad, pad), mode="reflect")[:, 0]
        l1 = (xp.unfold(-1, n_fft, hop).abs() * torch.from_numpy(win)).sum(
            -1)                                   # [batch, frames]
    results["stft"] = ("sum", _ns_sum_ratio(
        torch, spec_card._data, spec_cpu._data,
        l1[:, None, :].expand(spec_cpu.shape)))
    y_card, y_cpu = both(lambda: S.istft(S.stft(T(x), window=T(win), **kw),
                                         window=T(win), length=c["samples"],
                                         **kw))
    # an output sample sums, over the frames covering it, window * (2 / n)
    # * sum_k |X_k|, over the squared-window envelope
    with on_cpu(paddle):
        spec = spec_cpu._data
        mag = spec.abs().sum(-2) * 2.0 / n_fft    # [batch, frames]
        w = torch.from_numpy(win)
        frames = mag[..., None] * w.abs()         # [batch, frames, n_fft]
        out = S._overlap_add(frames, hop)
        env = S._overlap_add((w * w).expand(frames.shape[-2], n_fft), hop)
        bound = (out / env.clamp_min(1e-11))[..., pad:pad + c["samples"]]
    results["istft"] = ("sum", _ns_sum_ratio(torch, y_card._data, y_cpu._data,
                                             bound))
    results["istft round trip"] = ("close", float(
        (y_card._data.cpu() - torch.from_numpy(x)).abs().max() / 1e-5))
    fr_card, fr_cpu = both(lambda: S.frame(T(x), n_fft, hop))
    results["frame"] = ("exact", _ns_exact(torch, fr_card._data,
                                           fr_cpu._data))
    oa_card, oa_cpu = both(lambda: S.overlap_add(S.frame(T(x), n_fft, hop),
                                                 hop))
    with on_cpu(paddle):
        oa_abs = S.overlap_add(S.frame(T(np.abs(x)), n_fft, hop), hop)
    results["overlap_add"] = ("sum", _ns_sum_ratio(
        torch, oa_card._data, oa_cpu._data, oa_abs._data))
    xc, wc = T(x), T(win)
    timings["signal stft (ms)"] = _timed_ms(
        torch, dev, lambda: S.stft(xc, window=wc, **kw))
    log(f"[namespaces] signal: stft/istft of {c['batch']} x {c['samples']} "
        f"samples, n_fft {n_fft}, hop {hop}, Hann: spectrum "
        f"{list(spec_card.shape)} {spec_card.dtype}")


def _ns_sparse(torch, dev, paddle, both, results, timings):
    import numpy as np

    c = NS_SPARSE
    rng = np.random.default_rng(2)
    n = c["n"]
    flat = np.unique(rng.integers(0, n * n, int(n * n * c["density"])))
    idx = np.stack([flat // n, flat % n]).astype("int64")
    vals = rng.standard_normal(len(flat)).astype("float32")
    dense = rng.standard_normal((n, c["cols"])).astype("float32")
    yt = rng.standard_normal((c["cols"], n)).astype("float32")
    inp = rng.standard_normal((n, c["cols"])).astype("float32")
    SP = paddle.sparse
    T = paddle.to_tensor

    def coo(v):
        return SP.sparse_coo_tensor(idx, T(v), [n, n])

    def csr(v):
        return coo(v).to_sparse_csr()

    with on_cpu(paddle):
        prod_abs = SP.matmul(coo(np.abs(vals)), T(np.abs(dense)))
        mm_abs = SP.masked_matmul(T(np.abs(dense)), T(np.abs(yt)),
                                  coo(vals))
        add_abs = SP.addmm(T(np.abs(inp)), coo(np.abs(vals)),
                           T(np.abs(dense)), 0.5, 2.0)
    for fmt, make in (("coo", coo), ("csr", csr)):
        card, cpu = both(lambda make=make: SP.matmul(make(vals), T(dense)))
        results[f"matmul {fmt}"] = ("sum", _ns_sum_ratio(
            torch, card._data, cpu._data, prod_abs._data))
    card, cpu = both(lambda: SP.masked_matmul(T(dense), T(yt), coo(vals)))
    results["masked_matmul"] = ("sum", _ns_sum_ratio(
        torch, card.values()._data, cpu.values()._data,
        mm_abs.values()._data)) if _ns_exact(
        torch, card.indices()._data, cpu.indices()._data) else ("exact",
                                                               False)
    card, cpu = both(lambda: SP.addmm(T(inp), coo(vals), T(dense), 0.5, 2.0))
    results["addmm"] = ("sum", _ns_sum_ratio(torch, card._data, cpu._data,
                                             add_abs._data))
    for op in ("sin", "tanh", "square", "abs", "relu", "expm1"):
        card, cpu = both(lambda op=op: getattr(SP, op)(coo(vals)))
        results[f"{op} values"] = ("close", _ns_close_ratio(
            torch, card.values()._data, cpu.values()._data))
    card, cpu = both(lambda: SP.sqrt(SP.abs(csr(vals))))
    results["sqrt(abs) csr values"] = ("close", _ns_close_ratio(
        torch, card.values()._data, cpu.values()._data))
    a, y = coo(vals), T(dense)
    timings[f"sparse COO @ dense [{n}, {c['cols']}] (ms)"] = _timed_ms(
        torch, dev, lambda: SP.matmul(a, y))
    log(f"[namespaces] sparse: {n} x {n} COO/CSR, {len(flat)} nonzeros "
        f"({len(flat) / n / n:.4%}), times a dense [{n}, {c['cols']}]")


def _ns_distribution(torch, dev, paddle, both, results, timings):
    import numpy as np

    c = NS_DIST
    rng = np.random.default_rng(3)
    D = paddle.distribution
    T = paddle.to_tensor
    b, d, k = c["batch"], c["mvn_d"], c["classes"]
    loc, scale = (rng.standard_normal(b).astype("float32"),
                  (rng.random(b) + 0.5).astype("float32"))
    loc2, scale2 = (rng.standard_normal(b).astype("float32"),
                    (rng.random(b) + 0.5).astype("float32"))
    v = rng.standard_normal(b).astype("float32")
    a = rng.standard_normal((d, d)).astype("float32")
    cov = (a @ a.T / d + np.eye(d)).astype("float32")
    mloc = rng.standard_normal(d).astype("float32")
    mval = rng.standard_normal(d).astype("float32")
    logits = rng.standard_normal((4, k)).astype("float32")
    logits2 = rng.standard_normal((4, k)).astype("float32")
    cls = rng.integers(0, k, 4).astype("int64")
    conc = (rng.random((16, 8)) + 0.5).astype("float32")
    simplex = rng.random((16, 8)).astype("float32") + 0.1
    simplex /= simplex.sum(-1, keepdims=True)
    ga, gb = (rng.random(b) + 0.5).astype("float32"), (
        rng.random(b) + 0.5).astype("float32")
    pos = (rng.random(b) + 0.1).astype("float32")
    unit = (rng.random(b) * 0.8 + 0.1).astype("float32")

    def close(name, fn):
        card, cpu = both(fn)
        results[name] = ("close", _ns_close_ratio(torch, card._data,
                                                  cpu._data))

    close("Normal log_prob", lambda: D.Normal(T(loc), T(scale)).log_prob(
        T(v)))
    close("Normal entropy", lambda: D.Normal(T(loc), T(scale)).entropy())
    close("Normal kl", lambda: D.kl_divergence(D.Normal(T(loc), T(scale)),
                                               D.Normal(T(loc2),
                                                        T(scale2))))
    close(f"MultivariateNormal d{d} log_prob", lambda: D.MultivariateNormal(
        T(mloc), covariance_matrix=T(cov)).log_prob(T(mval)))
    close(f"MultivariateNormal d{d} entropy", lambda: D.MultivariateNormal(
        T(mloc), covariance_matrix=T(cov)).entropy())
    close(f"Categorical {k} log_prob", lambda: D.Categorical(
        logits=T(logits)).log_prob(T(cls)))
    # entropy and kl sum over the 32000 classes
    card, cpu = both(lambda: D.Categorical(logits=T(logits)).entropy())
    with on_cpu(paddle):
        lp = torch.log_softmax(torch.from_numpy(logits), -1)
        ent_abs = (lp.exp() * lp.abs()).sum(-1)
        lq = torch.log_softmax(torch.from_numpy(logits2), -1)
        kl_abs = (lp.exp() * (lp - lq).abs()).sum(-1)
    results[f"Categorical {k} entropy"] = ("sum", _ns_sum_ratio(
        torch, card._data, cpu._data, ent_abs))
    card, cpu = both(lambda: D.kl_divergence(
        D.Categorical(logits=T(logits)), D.Categorical(logits=T(logits2))))
    results[f"Categorical {k} kl"] = ("sum", _ns_sum_ratio(
        torch, card._data, cpu._data, kl_abs))
    close("Dirichlet log_prob", lambda: D.Dirichlet(T(conc)).log_prob(
        T(simplex)))
    close("Gamma log_prob", lambda: D.Gamma(T(ga), T(gb)).log_prob(T(pos)))
    close("Beta log_prob", lambda: D.Beta(T(ga), T(gb)).log_prob(T(unit)))
    # draws on the card: a seed repeats them; their moments
    n = c["draws"]

    def draws(make):
        paddle.seed(5)
        x1 = make().sample([n])._data
        paddle.seed(5)
        x2 = make().sample([n])._data
        return x1, bool(torch.equal(x1, x2)) and x1.device.type == "cuda"

    def moment(name, make, mean, var):
        x, same = draws(make)
        x = x.double()
        se = math.sqrt(var / n)
        z = abs(float(x.mean()) - mean) / se
        results[f"{name} draws"] = ("moments", (z, same))

    moment("Normal(0.5, 2)", lambda: D.Normal(0.5, 2.0), 0.5, 4.0)
    moment("Gamma(3, 2)", lambda: D.Gamma(3.0, 2.0), 1.5, 0.75)
    moment("Beta(2, 3)", lambda: D.Beta(2.0, 3.0), 0.4, 0.04)
    x, same = draws(lambda: D.Dirichlet(T(np.asarray([1.0, 2.0, 3.0],
                                                      "float32"))))
    mu = torch.tensor([1 / 6, 2 / 6, 3 / 6], dtype=torch.float64)
    se = (mu * (1 - mu) / 7 / n).sqrt()
    results["Dirichlet(1, 2, 3) draws"] = ("moments", (float(
        ((x.double().mean(0).cpu() - mu).abs() / se).max()), same))
    x, same = draws(lambda: D.MultivariateNormal(T(mloc),
                                                 covariance_matrix=T(cov)))
    se = torch.from_numpy(np.sqrt(np.diag(cov) / n)).double()
    results[f"MultivariateNormal d{d} draws"] = ("moments", (float(
        ((x.double().mean(0).cpu() - torch.from_numpy(mloc).double()).abs()
         / se).max()), same))
    p = torch.softmax(torch.from_numpy(logits[0]).double(), -1)
    x, same = draws(lambda: D.Categorical(logits=T(logits[0])))
    freq = torch.bincount(x.cpu(), minlength=k).double() / n
    z = float(((freq - p).abs() / (p * (1 - p) / n).sqrt()).max())
    # the largest of 32000 |z| of N(0, 1) draws sits near 4.2; hold it at 6
    results[f"Categorical {k} draws"] = ("moments", (z * 5.0 / 6.0, same))
    cat = D.Categorical(logits=T(logits[0]))
    timings[f"distribution Categorical({k}) {n} draws (ms)"] = _timed_ms(
        torch, dev, lambda: cat.sample([n]))
    log(f"[namespaces] distribution: batch {b}, MultivariateNormal d {d}, "
        f"Categorical over {k} classes, {n} draws each")


def phase_namespaces(torch, dev):
    """signal, geometric (with incubate's graph ops), sparse and
    distribution (ROADMAP A10g part 1) on cuda:0 at the NS_* sizes, each
    output against the port on the CPU from the same inputs at the NS_*
    bars; the draws repeat under a seed and meet their moments within 5
    standard errors; one timed call a namespace."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as device_mod

    device_mod._current = None   # the default: the card
    t_phase = time.perf_counter()

    def both(fn):
        """fn() on the card (the default place), then on the CPU."""
        card = fn()
        torch.cuda.synchronize(dev)
        with on_cpu(paddle):
            cpu = fn()
        return card, cpu

    results, timings, spent = {}, {}, {}
    for label, part in (("geometric", _ns_geometric),
                        ("signal", _ns_signal), ("sparse", _ns_sparse),
                        ("distribution", _ns_distribution)):
        t0 = time.perf_counter()
        part(torch, dev, paddle, both, results, timings)
        spent[label] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
    bad = {}
    for name, (kind, r) in results.items():
        ok = (r if kind == "exact" else
              (r[0] <= 5.0 and r[1]) if kind == "moments" else
              (math.isfinite(r) and r <= 1.0))
        if not ok:
            bad[name] = (kind, r)
    log(f"[namespaces] card against the port on the CPU (exact: equal; sum: "
        f"fraction of {NS_SUM_RTOL} x the sum of |terms|; close: fraction of "
        f"{NS_ATOL} + {NS_RTOL} |ref|; moments: (|z| of the draws' mean, "
        f"in standard errors, bar 5; a seed repeats the draw)): "
        f"{ {n: (k, r if isinstance(r, bool) else tuple(round(x, 3) if isinstance(x, float) else x for x in r) if isinstance(r, tuple) else round(r, 4)) for n, (k, r) in results.items()} }")
    log(f"[namespaces] one timed call each: "
        f"{ {n: round(ms, 3) for n, ms in timings.items()} }; seconds by "
        f"namespace {spent}; phase {time.perf_counter() - t_phase:.1f} s")
    device_mod._current = None
    if bad:
        raise AssertionError(f"namespaces: {bad}")


MATMUL_NAMES = ("gemm", "nvjet", "xmma", "cutlass")
NORMS = ("rms_norm_fwd", "rms_norm_bwd")
TRAIN_RANGES = ("fused_ce", "adamw_update")


def phase_train_profile(torch, dev, eng, params, opt, ids, labels, label,
                        n_steps=2):
    """Where a step's device time goes: n_steps under torch.profiler. The
    port runs the fused CE and the AdamW update inside the named ranges
    TRAIN_RANGES; a kernel belongs to a range when it runs inside the
    range's span on the device. Kernels split into attention (B1-B3),
    matrix products outside the CE (cuBLAS), the fused CE (its matmuls
    included), the optimizer, and the rest (norms, RoPE, SwiGLU, embedding,
    grad accumulation and casts). Reports "not measured" when the profiler
    sees no device activity, and fails when it sees kernels but not both
    ranges."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            loss, params, opt = eng.train_batch(params, opt, ids, labels)
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    on_card = [e for e in prof.events()
               if str(e.device_type).endswith("CUDA")]
    spans = [e for e in on_card if e.name in TRAIN_RANGES]
    kern = [e for e in on_card if e.name not in TRAIN_RANGES
            and e.time_range.end > e.time_range.start]
    if not kern:
        log(f"[{label}] device time not measured: the profiler saw no "
            "device activity")
        return None
    missing = set(TRAIN_RANGES) - {r.name for r in spans}
    if missing:
        raise AssertionError(f"{label}: the profiler saw no device span of "
                             f"the port's ranges {sorted(missing)}")

    def us(kernels):
        return sum(e.time_range.end - e.time_range.start for e in kernels)

    def within(name):
        rs = [(r.time_range.start, r.time_range.end) for r in spans
              if r.name == name]
        return [k for k in kern if any(a <= k.time_range.start
                                       and k.time_range.end <= b
                                       for a, b in rs)]

    def is_mm(name):
        return any(f in name for f in MATMUL_NAMES)

    busy = us(kern)
    ce_k, opt_k = within("fused_ce"), within("adamw_update")
    ce_ids = {id(k) for k in ce_k}
    shares = {"matmul": us(k for k in kern
                           if is_mm(k.name) and id(k) not in ce_ids),
              "attention B1-B3": us(k for k in kern if "flash_" in k.name),
              "norms B9/B10": us(k for k in kern if "rms_norm_" in k.name),
              "fused CE": us(ce_k), "optimizer": us(opt_k)}
    shares["other"] = busy - sum(shares.values())
    per = n_steps * 1e3
    log(f"[{label}] {n_steps} profiled steps: wall {wall_us / per:.1f} ms a "
        f"step, device busy {busy / per:.1f} ms ({busy / wall_us:.1%}); of "
        "device time: " + ", ".join(
            f"{k} {v / busy:.1%} ({v / per:.1f} ms)"
            for k, v in shares.items())
        + f"; the fused CE's matmuls {us(k for k in ce_k if is_mm(k.name)) / busy:.1%}")
    top = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")
           and e.key not in TRAIN_RANGES and e.self_device_time_total > 0]
    for e in sorted(top, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[{label}]   {e.self_device_time_total / busy:6.1%} "
            f"{e.count / n_steps:5.0f}/step  {e.key[:90]}")
    for kid in ("B1", "B2", "B3", "B9", "B10"):
        frags = PROFILE_NAMES[kid]
        t = us(k for k in kern if any(f in k.name for f in frags))
        log(f"[{label}]   {kid}: {t / busy:.1%} of device time, "
            f"{t / per:.3f} ms a step")
    return {"wall_ms": wall_us / per, "busy_ms": busy / per}


def phase_train(torch, dev, name, label, warmup=2, steps=8):
    """bench.py's `_bench` on the port: `HybridParallelEngine` at one
    training leg, bf16 params from seed 0, numpy ids/labels from seed 0;
    2 warm-up and `steps` timed steps ending in a synchronise. Returns the
    launch counts of the timed steps."""
    import types

    import numpy as np
    from paddle_tpu_torch.distributed import HybridParallelEngine
    from paddle_tpu_torch.observability.hardware import llama_flops_per_token

    cfg_kw, batch, seq, mb = TRAIN_LEGS[label]
    torch.cuda.empty_cache()
    PEAK_SEEN.append(torch.cuda.max_memory_allocated(dev))
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = types.SimpleNamespace(**cfg_kw)    # the reference's names
    eng = HybridParallelEngine(cfg, dp=1, pp=1, mp=1, micro_batches=mb,
                               dtype=torch.bfloat16, remat=False, lr=1e-4,
                               loss_chunk=128, moments="f32", device=dev)
    args = eng.args
    params, opt = eng.init_state(0)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, args.vocab_size, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, args.vocab_size, (batch, seq)).astype(np.int32)
    ids, labels = eng.shard_batch(ids, labels)
    first = None
    for _ in range(warmup):
        loss, params, opt = eng.train_batch(params, opt, ids, labels)
        first = loss if first is None else first
    torch.cuda.synchronize(dev)
    reset_launches()
    mon, lbl = eng.monitor, {"source": "hybrid_engine"}
    mfu0 = mon.registry.observation("train/mfu", labels=lbl)
    wall0 = mon.registry.observation("train/step_time_s", labels=lbl)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, params, opt = eng.train_batch(params, opt, ids, labels)
    # the gauge as the last step's end_step left it, beside the allocator's
    # high water now (nothing is allocated after that end_step)
    hbm_gauge = mon.registry.gauge("train/hbm_high_water_bytes", labels=lbl)
    hbm_now = torch.cuda.max_memory_allocated(dev)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = launch_counts()
    final = loss.item()
    tps = batch * seq * steps / secs
    mfu = tps * llama_flops_per_token(args, seq) / peaks(name)[1]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    per_step = {k: launches[k] / steps for k in flash + NORMS}
    log(f"[{label}] hidden {args.hidden_size}, {args.num_layers} layers, b"
        f"{batch} s{seq}, {mb} micro-batches, bf16, no remat, loss_chunk "
        f"128, f32 moments: {tps:.0f} tokens/s, {secs / steps * 1e3:.1f} ms "
        f"a step, MFU {mfu:.1%} (model FLOPs over the bf16 peak), peak "
        f"device memory {peak:.1f} GiB; loss {first.item():.4f} at the "
        f"first step, {final:.4f} at the last (one batch, repeated, as "
        f"bench.py trains); B1/B2/B3/B9/B10 "
        f"launches a step {per_step}")
    mfu1 = mon.registry.observation("train/mfu", labels=lbl)
    wall1 = mon.registry.observation("train/step_time_s", labels=lbl)
    mon_mfu = (mfu1["sum"] - mfu0["sum"]) / (mfu1["count"] - mfu0["count"])
    mon_ms = (wall1["sum"] - wall0["sum"]) / steps * 1e3
    log(f"[{label}] the engine's default monitor (nan_action 'none': each "
        f"step's wall time is its dispatch, the step never waits for the "
        f"card): {mon.steps} steps, the timed steps' mean step time "
        f"{mon_ms:.1f} ms against {secs / steps * 1e3:.1f} ms synchronised "
        f"and mean MFU {mon_mfu:.1%} against {mfu:.1%} "
        f"(peak {mon.peak_flops / 1e12:.0f} TFLOP/s), HBM high water "
        f"{hbm_gauge / 2**30:.2f} GiB (torch.cuda.max_memory_allocated "
        f"{hbm_now / 2**30:.2f} GiB)")
    if mon.steps != warmup + steps or hbm_gauge != hbm_now or \
            mon.peak_flops != peaks(name)[1]:
        raise AssertionError(f"{label}: monitor steps {mon.steps}, HBM gauge "
                             f"{hbm_gauge} vs {hbm_now}, peak "
                             f"{mon.peak_flops}")
    # B1-B3 once a layer, B9/B10 once a norm (2L + 1), each micro-batch
    want = dict.fromkeys(flash, args.num_layers * mb)
    want.update(dict.fromkeys(NORMS, (2 * args.num_layers + 1) * mb))
    if not (math.isfinite(final) and per_step == want):
        raise AssertionError(f"{label}: loss {final}, launches a step "
                             f"{per_step} (want {want})")
    phase_train_profile(torch, dev, eng, params, opt, ids, labels,
                        f"{label}-profile")
    return launches


def cuda_ms(torch, fn, l2):
    """Median per-call device time of fn() in ms under the kernel table's
    method (`timing.METHOD`: CUDA events around each call, the L2 cache
    flushed before each one by `l2`, a `timing.ColdL2`)."""
    from paddle_tpu_torch.kernels import timing

    return timing.cold_ms(fn, l2)


def methods_line(torch, fn, l2):
    """fn's time under each of `timing.METHODS`, as one log fragment."""
    from paddle_tpu_torch.kernels import timing

    return ", ".join(f"{how} flush{' + sleep' if sleep else ''} {t:.4f}"
                     for (how, sleep), t in timing.methods_ms(fn, l2).items())


def cuda_ms_loop(torch, fn, iters=50):
    """Mean per-call device time of fn() issued back to back (host overhead
    hidden behind the queue, caches as the previous call left them)."""
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return a.elapsed_time(e) / iters


def graph_ms(torch, fn, reps=200):
    """Mean device time of fn() with no host work between calls: `reps`
    calls captured into one CUDA graph, replayed once (the caches stay as
    the previous call left them). For calls that take less device time
    than the host takes to launch them, which `cuda_ms` cannot separate."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    e.record()
    e.synchronize()
    return a.elapsed_time(e) / reps


def phase_timing(torch, dev, name, main_err, launches):
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import attention as at
    from paddle_tpu_torch.kernels import quantized_matmul as qm

    from paddle_tpu_torch.kernels import timing

    bw, flops_peak = peaks(name)
    # two 256 MB buffers, past the 50 MB L2: the flush before each timed
    # call (`timing.METHOD` for every number of the JSON line)
    l2 = timing.ColdL2(dev)
    rows = []
    held = (", the card held by torch.cuda._sleep while the host enqueues"
            if timing.METHOD[1] else "")
    log(f"[timing] card at the start: {card_state()}; every time below is "
        f"L2 flushed by {timing.METHOD[0]}ing 256 MB{held} unless a line says "
        f"otherwise")

    def record(wrapper, fn, plain, library, nbytes, flops, label, row=True,
               methods=False):
        """Times one shape; the kernel's JSON row when `row` (True: under
        the wrapper's key of KERNELS; a string: under that key). `library`:
        a callable, or its time in ms measured already. `methods`: the
        kernel's time under every timing method, logged. Returns the
        kernel's ms and the bound's."""
        ms = cuda_ms(torch, fn, l2)
        log(f"[timing] {label}: back-to-back kernel "
            f"{cuda_ms_loop(torch, fn):.4f} ms, plain "
            f"{cuda_ms_loop(torch, plain):.4f} ms")
        if methods:
            log(f"[timing] {label}: kernel by timing method (ms): "
                f"{methods_line(torch, fn, l2)}")
        plain_ms = cuda_ms(torch, plain, l2)
        lib_ms = (library if isinstance(library, float)
                  else cuda_ms(torch, library, l2))
        t_bytes = nbytes / bw * 1e3
        t_ops = flops / flops_peak * 1e3
        bound, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
        log(f"[timing] {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
            f"{bound / ms:.1%} of bound")
        if row:
            key = row if isinstance(row, str) else wrapper
            js, src, replaces = KERNELS[key]
            rows.append({"name": js, "route": "cuda", "source": src,
                         "replaces": replaces, "launches": launches[key],
                         "max_abs_err": main_err[key], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": by, "library_ms": lib_ms})
        return ms, bound

    # B1-B3 at the 7B training leg's micro-batch (b2 h32 s2048 d128, causal,
    # bf16: the JSON rows), then B2 and B3 at the h2048 leg's (b4 h16 s1024,
    # log lines only); bounds count the visible (query, key) pairs. The
    # library call is SDPA: its forward beside B1, its backward (dq, dk and
    # dv together) beside both B2 and B3
    from paddle_tpu_torch.kernels import flash_attention as fa

    for b, s, h, d in ((2, 2048, 32, 128), (4, 1024, 16, 128)):
        main = s == 2048
        q, k, v, do = flash_case(torch, dev, b, s, s, h, h, d,
                                 torch.bfloat16)
        scale = 1.0 / math.sqrt(d)
        out, lse = fa.flash_fwd(q, k, v, True)
        delta = fa._delta(out, do)
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        lq, lk, lv = (x.clone().requires_grad_() for x in (qt, kt, vt))
        lout = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)

        def sdpa_backward():
            return torch.autograd.grad(lout, (lq, lk, lv), dot,
                                       retain_graph=True)

        sdpa_bwd_ms = cuda_ms(torch, sdpa_backward, l2)
        log(f"[timing] SDPA backward (dq, dk, dv) b{b} h{h} s{s} d{d} "
            f"causal bf16: {sdpa_bwd_ms:.4f} ms")

        flops = 2 * d * b * h * s * (s + 1) // 2       # one product
        t16, vec = b * s * h * d * 2, b * h * s * 4     # a bf16 [B,S,H,D]
        label = f"b{b} h{h} s{s} d{d} causal bf16"
        if main:
            record("flash_fwd", lambda: fa.flash_fwd(q, k, v, True),
                   lambda: fa.flash_fwd_plain(q, k, v, True),
                   lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True),
                   4 * t16 + vec, 2 * flops, f"B1 {label}")
        record("flash_bwd_dq",
               lambda: fa._launch_dq(q, k, v, do, lse, delta, True, scale),
               lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, True,
                                             scale),
               sdpa_bwd_ms, 5 * t16 + 2 * vec, 3 * flops, f"B2 {label}",
               row=main)
        record("flash_bwd_dkv",
               lambda: fa._launch_dkv(q, k, v, do, lse, delta, True, scale),
               lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True,
                                              scale),
               sdpa_bwd_ms, 4 * t16 + 2 * vec + 2 * 2 * t16, 4 * flops,
               f"B3 {label}", row=main)
        del q, k, v, do, out, lse, delta, qt, kt, vt, dot, lq, lk, lv, lout
        torch.cuda.empty_cache()

    # B1 in fp16 and at head_dim 32 at config 5's shapes (unet_sd_like at
    # 64^2 latents, full attention, 8 heads): level 2 and the middle block
    # in fp16 (the fp16 row), level 1 in bf16 (the head_dim-32 row), then
    # level 1 in fp16 (a log line). The library call is SDPA in the same
    # dtype; the bound counts both products and each input read once
    for key, (b, s, h, d, dt), row in (
            ("flash_fwd_f16", (1, 256, 8, 64, torch.float16), True),
            ("flash_fwd_hd32", (1, 1024, 8, 32, torch.bfloat16), True),
            ("flash_fwd_hd32", (1, 1024, 8, 32, torch.float16), False)):
        q, k, v, _ = flash_case(torch, dev, b, s, s, h, h, d, dt)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        record(key, lambda: fa.flash_fwd(q, k, v, False),
               lambda: fa.flash_fwd_plain(q, k, v, False),
               lambda: F.scaled_dot_product_attention(qt, kt, vt),
               4 * b * s * h * d * 2 + b * h * s * 4, 4 * b * h * s * s * d,
               f"B1 b{b} h{h} s{s} d{d} non-causal "
               f"{str(dt).split('.')[-1]} (config 5's UNet)", row=row)
        del q, k, v, qt, kt, vt

    # B6 and B4 at the engine's decode shape: 8 rows, ragged up to 2048
    q, pk, pv, bt, pos = paged_case(torch, dev, torch.bfloat16)
    b, _, nh, hd = q.shape
    nkv, ps = pk.shape[1], pk.shape[2]
    keys = [int(p) + 1 for p in pos.tolist()]
    kv_bytes = sum(keys) * nkv * hd * 2 * 2
    qo_bytes = 2 * b * nh * hd * 2
    flops = 4 * nh * hd * sum(keys)
    bt_bytes = sum((k - 1) // ps + 1 for k in keys) * 4 + b * 4
    ck = at.paged_gather(pk, bt)
    cv = at.paged_gather(pv, bt)
    mask = (torch.arange(ck.shape[2], device=dev)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    qt = q.transpose(1, 2)
    record("paged_decode_attention",
           lambda: at.paged_decode_attention(q, pk, pv, bt, pos),
           lambda: at.paged_decode_attention_plain(q, pk, pv, bt, pos),
           lambda: F.scaled_dot_product_attention(qt, ck, cv, attn_mask=mask),
           kv_bytes + qo_bytes + bt_bytes, flops,
           "B6 b=8 nh=nkv=32 hd=128 ps=16 P=128", methods=True)
    record("decode_attention",
           lambda: at.decode_attention(q, ck, cv, pos),
           lambda: at.decode_attention_plain(q, ck, cv, pos),
           lambda: F.scaled_dot_product_attention(qt, ck, cv, attn_mask=mask),
           kv_bytes + qo_bytes + b * 4, flops,
           f"B4 b=8 nh=nkv=32 hd=128 len=2048, "
           f"{at.decode_splits(ck.shape[2] - 1)} "
           f"split(s)", methods=True)
    log(f"[timing] B4's shared CUDA-core body (the kernel the cluster kernel "
        f"replaced in bf16, its C entry point with splits 0), same inputs, by "
        f"timing method (ms): "
        f"{methods_line(torch, b4_shared(torch, q, ck, cv, pos), l2)}")
    # B4 at the speculative draft's stripe (h2048: 16 kv heads, 1029 keys
    # a row, ragged rows), beside the shared body
    q, ck, cv, _, _, pos = b4_case(torch, dev, torch.bfloat16,
                                   *B4_CASES[0][1:])
    keys = [min(int(p), ck.shape[2] - 1) + 1 for p in pos.tolist()]
    record("decode_attention",
           lambda: at.decode_attention(q, ck, cv, pos),
           lambda: at.decode_attention_plain(q, ck, cv, pos),
           lambda: F.scaled_dot_product_attention(
               q.transpose(1, 2), ck, cv, attn_mask=(
                   torch.arange(ck.shape[2], device=dev)[None, :]
                   <= pos[:, None].long())[:, None, None, :]),
           sum(keys) * ck.shape[1] * 128 * 2 * 2 + 2 * 8 * 16 * 128 * 2
           + 8 * 4, 4 * 16 * 128 * sum(keys),
           f"B4 at the draft's stripe, b=8 nh=nkv=16 hd=128 len=1029 "
           f"pos={pos.tolist()}", row=False)
    log(f"[timing] B4's shared body at the draft's stripe: "
        f"{cuda_ms(torch, b4_shared(torch, q, ck, cv, pos), l2):.4f} ms")
    del q, ck, cv
    # B5 at a paged-prefill suffix (16 new tokens after a 512-token hit:
    # the JSON row), then at the spec-verify window (b=8, s=5, ragged
    # rows). The library call is SDPA over the keys the kernel reads, up
    # to each batch's last watermark (PR 6 gave it the whole stripe: that
    # reading is logged beside it)
    for b, s, pos_l in ((1, 16, [512]),
                        (8, 5, [1000, 3, 64, 59, 0, 500, 127, 777])):
        q, ck, cv, pos = window_case(torch, dev, torch.bfloat16, s, b=b,
                                     length=2048 + s if b == 1 else 1100,
                                     pos=pos_l)
        nh, nkv, L = q.shape[2], ck.shape[1], ck.shape[2]
        lasts = [min(p + s - 1, L - 1) for p in pos_l]
        last = max(lasts)
        keys = sum(min(p + i, L - 1) + 1 for p in pos_l for i in range(s))
        qpos = pos[:, None, None, None].long() + torch.arange(
            s, device=dev)[None, None, :, None]
        mask = torch.arange(L, device=dev)[None, None, None, :] <= qpos
        ckr, cvr = ck[:, :, :last + 1], cv[:, :, :last + 1]
        mask_r = mask[..., :last + 1]
        qt = q.transpose(1, 2)
        if b == 1:
            stripe_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, ck, cv, attn_mask=mask), l2)
            log(f"[timing] B5's library call as PR 6 timed it, SDPA over the "
                f"whole {L}-key stripe: {stripe_ms:.4f} ms")
        splits = at.window_splits(at._window_last(pos, s, L))
        record("window_attention",
               lambda: at.window_attention(q, ck, cv, pos),
               lambda: at.window_attention_plain(q, ck, cv, pos),
               lambda: F.scaled_dot_product_attention(qt, ckr, cvr,
                                                      attn_mask=mask_r),
               sum(x + 1 for x in lasts) * nkv * hd * 2 * 2
               + 2 * b * s * nh * hd * 2 + 4 * b,
               4 * hd * (nh // nkv) * nkv * keys,
               f"B5 b={b} s={s} nh=nkv=32 hd=128 len={L} pos={pos_l}, "
               f"{splits} split(s)", row=b == 1)
        del q, ck, cv, ckr, cvr

    # B7 at the engine's decode shape over int8 pages; the library call
    # attends over the dequantized (bf16) gathered cache
    q, kq, vq, ks, vs, bt, pos = paged_q8_case(torch, dev, torch.bfloat16)
    b, _, nh, hd = q.shape
    nkv, ps = kq.shape[1], kq.shape[2]
    keys = [int(p) + 1 for p in pos.tolist()]
    pages = sum((k - 1) // ps + 1 for k in keys)
    ck = at.paged_gather(kq, bt, ks, torch.bfloat16)
    cv = at.paged_gather(vq, bt, vs, torch.bfloat16)
    mask = (torch.arange(ck.shape[2], device=dev)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    qt = q.transpose(1, 2)
    record("paged_decode_attention_int8",
           lambda: at.paged_decode_attention(q, kq, vq, bt, pos, k_scale=ks,
                                             v_scale=vs),
           lambda: at.paged_decode_attention_plain(q, kq, vq, bt, pos,
                                                   k_scale=ks, v_scale=vs),
           lambda: F.scaled_dot_product_attention(qt, ck, cv, attn_mask=mask),
           sum(keys) * nkv * hd * 2 + pages * nkv * 4 * 2
           + 2 * b * nh * hd * 2 + pages * 4 + b * 4,
           4 * nh * hd * sum(keys),
           "B7 b=8 nh=nkv=32 hd=128 ps=16 P=128 int8 pool", methods=True)
    del ck, cv

    # B4-B7 in fp16 at their bf16 rows' shapes (the fp16 rows of the JSON
    # line); the library call is SDPA in fp16 over the same keys
    q, pk, pv, bt, pos = paged_case(torch, dev, torch.float16)
    keys = [int(p) + 1 for p in pos.tolist()]
    kv_bytes = sum(keys) * nkv * hd * 2 * 2
    ck, cv = at.paged_gather(pk, bt), at.paged_gather(pv, bt)
    mask = (torch.arange(ck.shape[2], device=dev)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    qt = q.transpose(1, 2)
    record("paged_decode_attention",
           lambda: at.paged_decode_attention(q, pk, pv, bt, pos),
           lambda: at.paged_decode_attention_plain(q, pk, pv, bt, pos),
           lambda: F.scaled_dot_product_attention(qt, ck, cv, attn_mask=mask),
           kv_bytes + qo_bytes + bt_bytes, 4 * nh * hd * sum(keys),
           "B6 fp16 b=8 nh=nkv=32 hd=128 ps=16 P=128",
           row="paged_decode_attention_f16")
    record("decode_attention",
           lambda: at.decode_attention(q, ck, cv, pos),
           lambda: at.decode_attention_plain(q, ck, cv, pos),
           lambda: F.scaled_dot_product_attention(qt, ck, cv, attn_mask=mask),
           kv_bytes + qo_bytes + b * 4, 4 * nh * hd * sum(keys),
           "B4 fp16 b=8 nh=nkv=32 hd=128 len=2048",
           row="decode_attention_f16")
    del q, pk, pv, ck, cv
    q, ck, cv, pos = window_case(torch, dev, torch.float16, 16, b=1,
                                 length=2048 + 16, pos=[512])
    L = ck.shape[2]
    keys = sum(min(512 + i, L - 1) + 1 for i in range(16))
    qpos = pos[:, None, None, None].long() + torch.arange(
        16, device=dev)[None, None, :, None]
    mask = (torch.arange(L, device=dev)[None, None, None, :] <= qpos)[
        ..., :512 + 16]
    ckr, cvr, qt = ck[:, :, :512 + 16], cv[:, :, :512 + 16], q.transpose(1, 2)
    record("window_attention",
           lambda: at.window_attention(q, ck, cv, pos),
           lambda: at.window_attention_plain(q, ck, cv, pos),
           lambda: F.scaled_dot_product_attention(qt, ckr, cvr,
                                                  attn_mask=mask),
           (512 + 16) * nkv * hd * 2 * 2 + 2 * 16 * nh * hd * 2 + 4,
           4 * hd * keys * nh, "B5 fp16 b=1 s=16 nh=nkv=32 hd=128 "
           f"len={L} pos=[512]", row="window_attention_f16")
    del q, ck, cv, ckr, cvr
    q, kq, vq, ks, vs, bt, pos = paged_q8_case(torch, dev, torch.float16)
    keys = [int(p) + 1 for p in pos.tolist()]
    pages = sum((k - 1) // ps + 1 for k in keys)
    ck = at.paged_gather(kq, bt, ks, torch.float16)
    cv = at.paged_gather(vq, bt, vs, torch.float16)
    mask = (torch.arange(ck.shape[2], device=dev)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    qt = q.transpose(1, 2)
    record("paged_decode_attention_int8",
           lambda: at.paged_decode_attention(q, kq, vq, bt, pos, k_scale=ks,
                                             v_scale=vs),
           lambda: at.paged_decode_attention_plain(q, kq, vq, bt, pos,
                                                   k_scale=ks, v_scale=vs),
           lambda: F.scaled_dot_product_attention(qt, ck, cv, attn_mask=mask),
           sum(keys) * nkv * hd * 2 + pages * nkv * 4 * 2
           + 2 * b * nh * hd * 2 + pages * 4 + b * 4,
           4 * nh * hd * sum(keys),
           "B7 fp16 query, b=8 nh=nkv=32 hd=128 ps=16 P=128 int8 pool",
           row="paged_decode_attention_int8_f16")
    del q, kq, vq, ks, vs, ck, cv

    # B6 and B7 at the engine's own decode shape (phase_profile's 8 rows
    # after 256-token prompts: 256-319 keys over tables of 128 pages of
    # 16), log lines, with the bound on pos the engine's scheduler passes
    # (max_pos) and without it
    eng_pos = tuple(256 + 9 * i for i in range(8))
    keys = [p + 1 for p in eng_pos]
    for q8 in (False, True):
        if q8:
            q, kq, vq, ks, vs, bt, pos = paged_q8_case(
                torch, dev, torch.bfloat16, pos=eng_pos)
            args, kw = (q, kq, vq, bt, pos), {"k_scale": ks, "v_scale": vs}
            ck = at.paged_gather(kq, bt, ks, torch.bfloat16)
            cv = at.paged_gather(vq, bt, vs, torch.bfloat16)
            nbytes = sum(keys) * nkv * hd * 2 + 2 * b * nh * hd * 2 + \
                sum((k - 1) // ps + 1 for k in keys) * (nkv * 8 + 4) + b * 4
        else:
            args, kw = paged_case(torch, dev, torch.bfloat16,
                                  pos=eng_pos), {}
            ck, cv = (at.paged_gather(t, args[3]) for t in args[1:3])
            nbytes = sum(keys) * nkv * hd * 2 * 2 + 2 * b * nh * hd * 2 + \
                sum((k - 1) // ps + 1 for k in keys) * 4 + b * 4
        mask = (torch.arange(ck.shape[2], device=dev)[None, :]
                <= args[4][:, None].long())[:, None, None, :]
        qt = args[0].transpose(1, 2)
        kid, name = (("B7", "paged_decode_attention_int8") if q8
                     else ("B6", "paged_decode_attention"))
        splits = at.paged_splits(128, ps, max(eng_pos))
        unbound = cuda_ms(torch, lambda: at.paged_decode_attention(
            *args, **kw), l2)
        record(name,
               lambda: at.paged_decode_attention(*args, **kw,
                                                 max_pos=max(eng_pos)),
               lambda: at.paged_decode_attention_plain(*args, **kw),
               lambda: F.scaled_dot_product_attention(qt, ck, cv,
                                                      attn_mask=mask),
               nbytes, 4 * nh * hd * sum(keys),
               f"{kid} at the engine's decode shape (8 rows of 257-320 "
               f"keys, ps=16 P=128), max_pos {max(eng_pos)}: {splits} "
               f"split(s); without the bound "
               f"{at.paged_splits(128, ps)} split(s), "
               f"{unbound:.4f} ms", row=False)
        del args, kw, ck, cv

    # B8: one call per shape of the decode step at M = 8 (the JSON row: the
    # FFN's 4096 x 11008), then prefill at M = 2048 (its own row) and at
    # the int8 engine's prompt lengths 512 and 1500; the library call is
    # torch.matmul with the weight already dequantized to bf16
    step_ms = step_bound = 0.0
    for m, k, n, calls in [(8, k, n, c) for k, n, c in DECODE_MATMULS] + [
            (m, k, n, 0) for m in (1, 16) for k, n, _ in DECODE_MATMULS] + [
            (2048, 4096, 11008, 0), (512, 4096, 4096, 0),
            (512, 4096, 11008, 0), (1500, 4096, 4096, 0),
            (1500, 4096, 11008, 0)]:
        x, w, s = matmul_case(torch, dev, torch.bfloat16, m, k, n)
        wd = w.to(torch.bfloat16) * (s.to(torch.bfloat16) / 127.0)
        way = qm.route(m, k, n, x.dtype, x.data_ptr(), w.data_ptr())
        if way == "tma":
            way += f", tile {qm.tile(m, n, qm._sms(dev))}"
        else:
            way += (f", (K rows a block, cluster) "
                    f"{qm.gemv_split(k, n, qm._sms(dev))}")
        row = ("weight_only_matmul_prefill" if (m, k, n) == (2048, 4096,
                                                             11008)
               else (m, k, n) == (8, 4096, 11008))
        ms, bound = record(
            "weight_only_matmul", lambda: qm.weight_only_matmul(x, w, s),
            lambda: qm.dequant_matmul_plain(x, w, s),
            lambda: torch.matmul(x, wd),
            k * n + n * 4 + m * k * 2 + m * n * 2, 2 * m * k * n,
            f"B8 M={m} K={k} N={n} ({way})", row=row)
        step_ms += calls * ms
        step_bound += calls * bound
        del x, w, s, wd
    n_calls = sum(c for *_, c in DECODE_MATMULS)
    log(f"[timing] B8 over one decode step at M=8 ({n_calls} calls): "
        f"{step_ms:.3f} ms of kernel time, bound {step_bound:.3f} ms")

    # B9 and B10 at the 7B training leg's micro-batch (the JSON rows, bf16
    # and fp16) and at the decode step's 8 rows, bf16; the library calls
    # are F.rms_norm's forward and its autograd backward
    from paddle_tpu_torch.kernels import rms_norm as rn

    bf, hf = torch.bfloat16, torch.float16
    for n, h, dt in ((4096, 4096, bf), (4096, 2048, bf), (8, 4096, bf),
                     (4096, 4096, hf)):
        dname = "bf16" if dt == torch.bfloat16 else "fp16"
        x, w, g = rms_case(torch, dev, n, h, dt)
        _, r = rn.rms_norm_fwd(x, w, RMS_EPS)
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        yl = F.rms_norm(xl, (h,), wl, RMS_EPS)

        def lib_backward():
            return torch.autograd.grad(yl, (xl, wl), g, retain_graph=True)

        t16 = n * h * 2
        main = (n, h) == (4096, 4096)
        record("rms_norm_fwd", lambda: rn.rms_norm_fwd(x, w, RMS_EPS),
               lambda: rn.rms_norm_fwd_plain(x, w, RMS_EPS),
               lambda: F.rms_norm(x, (h,), w, RMS_EPS),
               2 * t16 + h * 2 + n * 4, 4 * n * h,
               f"B9 [{n}, {h}] {dname}",
               row=main and f16_key("rms_norm_fwd", dt))
        record("rms_norm_bwd", lambda: rn.rms_norm_bwd(x, w, r, g),
               lambda: rn.rms_norm_bwd_plain(x, w, r, g), lib_backward,
               3 * t16 + 2 * h * 2 + n * 4, 9 * n * h,
               f"B10 [{n}, {h}] {dname}, (blocks, cluster) "
               f"{rn.bwd_grid(n, h, 2, qm._sms(dev))}",
               row=main and f16_key("rms_norm_bwd", dt),
               methods=dt == torch.bfloat16)

        def lib_both():
            xg = x.detach().requires_grad_()
            wg = w.detach().requires_grad_()
            return torch.autograd.grad(F.rms_norm(xg, (h,), wg, RMS_EPS),
                                       (xg, wg), g)

        # device time alone, from CUDA graphs: at 8 rows the host launches
        # a call slower than the card runs it
        log(f"[timing] B9/B10 [{n}, {h}] {dname} from CUDA graphs (device "
            f"time, no host launch work): B9 "
            f"{graph_ms(torch, lambda: rn.rms_norm_fwd(x, w, RMS_EPS)):.4f}"
            f" ms, F.rms_norm "
            f"{graph_ms(torch, lambda: F.rms_norm(x, (h,), w, RMS_EPS)):.4f}"
            f" ms; B10 "
            f"{graph_ms(torch, lambda: rn.rms_norm_bwd(x, w, r, g)):.4f} ms"
            f", F.rms_norm forward and backward "
            f"{graph_ms(torch, lib_both):.4f} ms")
        del x, w, g, r, xl, wl, yl
    log(f"[timing] card at the end: {card_state()}")
    return rows


def card_state():
    """The card's SM and memory clocks, temperature and power draw now
    (nvidia-smi), to read beside the times."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
         "power.draw", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# the main path: the paged engine and generate at Llama-2-7B width
# ---------------------------------------------------------------------------


def engine_traffic(vocab, seed=0):
    """12 requests, 64 new tokens each. Six share a 512-token system prefix
    (radix hits); two of those also share 7 tokens past it, so the second
    one's hit ends mid-page (a COW split); a 40-token suffix after the
    prefix and the 24-, 64-token prompts prefill through kernel B5; two
    requests sample."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def u(n):
        return rng.integers(1, vocab, size=n).astype(np.int32)

    sys_p, x7 = u(512), u(7)
    cat = np.concatenate
    return [
        dict(prompt=cat([sys_p, u(100)])),
        dict(prompt=u(24)),
        dict(prompt=u(1500)),
        dict(prompt=cat([sys_p, x7, u(33)])),
        dict(prompt=cat([sys_p, x7, u(45)])),
        dict(prompt=cat([sys_p, u(40)])),
        dict(prompt=u(300), temperature=0.8, top_p=0.9, seed=7),
        dict(prompt=cat([sys_p, u(200)])),
        dict(prompt=u(800)),
        dict(prompt=u(64), temperature=1.0, top_k=50, seed=11),
        dict(prompt=cat([sys_p, u(10)])),
        dict(prompt=u(1000)),
    ]


def phase_engine(torch, dev, model, kv_dtype=None, label="engine",
                 max_slots=8, max_len=2048, page_size=16, min_bucket=16,
                 new_tokens=64):
    """Serve the traffic; returns (requests, launches, stats, engine)."""
    from paddle_tpu_torch.serving import PagedEngine, Request

    eng = PagedEngine(model, max_slots=max_slots, max_len=max_len,
                      page_size=page_size, min_bucket=min_bucket,
                      kv_dtype=kv_dtype, device=dev)
    eng.serve([Request(list(range(1, 21)), 4)])      # warm-up, not counted
    eng.reset()
    traffic = engine_traffic(model.args.vocab_size)
    reqs = [Request(t.pop("prompt"), new_tokens, request_id=i, **t)
            for i, t in enumerate(traffic)]
    torch.cuda.synchronize(dev)
    reset_launches()
    t0 = time.perf_counter()
    eng.serve(reqs)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = launch_counts()

    m = eng.metrics.summary()
    c = m["counters"]
    n_tok = sum(len(r.token_ids) for r in reqs)
    # TTFT from the requests themselves (the registry's quantiles are
    # interpolated inside 1-2.5-5 buckets, too coarse for 12 requests)
    ttft = [r.ttft_s for r in reqs]
    ttft_p50 = statistics.median(ttft)
    pool_bytes = int(m["gauges"]["kv_pool_bytes"]["value"])
    log(f"[{label}] {len(reqs)} requests, {n_tok} tokens in {secs:.2f} s: "
        f"{n_tok / secs:.1f} tokens/s, TTFT p50 {ttft_p50 * 1e3:.1f} ms "
        f"max {max(ttft) * 1e3:.1f} ms; decode step p50 "
        f"{m['observations']['decode_step_s']['p50'] * 1e3:.2f} ms "
        f"(bucket-interpolated), {c['decode_steps']} decode steps; pool "
        f"{eng.num_pages} pages, {pool_bytes / 2**30:.3f} GiB")
    log(f"[{label}] prefix tokens hit {c.get('prefix_tokens_hit', 0)} of "
        f"{c['prompt_tokens']}, partial hits "
        f"{c.get('prefix_partial_hits', 0)}, "
        f"radix splits {c.get('radix_splits', 0)}, COW copies "
        f"{c.get('cow_copies', 0)}; launches {launches}")
    vocab = model.args.vocab_size
    for r in reqs:
        if not (r.finished and len(r.token_ids) == new_tokens
                and all(0 <= t < vocab for t in r.token_ids)):
            raise AssertionError(f"request {r.request_id} did not complete "
                                 f"cleanly: {r.finish_reason}, "
                                 f"{len(r.token_ids)} tokens")
    paged = ("B7 launched", "paged_decode_attention_int8") if kv_dtype \
        else ("B6 launched", "paged_decode_attention")
    checks = {"prefix hits": c.get("prefix_tokens_hit", 0) >= 5 * 512,
              "mid-page partial hit": c.get("prefix_partial_hits", 0) >= 1,
              "COW copy": c.get("cow_copies", 0) >= 1,
              "radix split": c.get("radix_splits", 0) >= 1,
              "B5 launched": launches["window_attention"] > 0,
              paged[0]: launches[paged[1]] > 0,
              "pages returned": eng._alloc.pages_in_use == 0}
    if model.quantized:
        checks["B8 launched"] = launches["weight_only_matmul"] > 0
        checks["B8 prefill (TMA) route launched"] = \
            launches["weight_only_matmul_prefill"] > 0
        checks["B8 off-gate route not launched"] = \
            launches["weight_only_matmul_offgate"] == 0
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{label} phase: {failed}")
    stats = {"tokens_per_s": n_tok / secs, "ttft_p50_s": ttft_p50,
             "ttft_max_s": max(ttft),
             "decode_step_p50_s": m["observations"]["decode_step_s"]["p50"],
             "decode_steps": c["decode_steps"], "seconds": secs,
             "counters": c, "kv_pool_bytes": pool_bytes,
             "num_pages": eng.num_pages}
    return reqs, launches, stats, eng


# kernel-name fragments of each ported kernel in a profiler trace
PROFILE_NAMES = {"B1": ("flash_fwd",), "B2": ("flash_bwd_dq",),
                 "B3": ("flash_bwd_dkv",),
                 "B5": ("window_mma_kernel", "window_attention_kernel"),
                 "B4": ("CacheKeys", "::decode_attention_kernel<"),
                 "B6": ("PagedKeys<__nv_bfloat16", "PagedKeys<__half",
                        "paged_decode_attention_kernel"),
                 "B7": ("PagedKeys<signed char", "PagedKeys<char",
                        "paged_decode_attention_q8_kernel"),
                 "B8": ("b8_gemv_mma_kernel", "b8_gemv_kernel",
                        "b8_reduce_kernel",
                        "b8_tma_kernel", "b8_mma_kernel", "b8_simt_kernel"),
                 "B9": ("rms_norm_fwd_kernel",),
                 "B10": ("rms_norm_bwd_kernel",)}


# kernel launches a decode step in the last run before B9 (PERF.md)
LAUNCHES_BEFORE_B9 = {"profile": 1682, "profile-int8": 3218}
# ... in the last run before B6/B7 were split over clusters (PERF.md), which
# the step may not exceed, and the paged kernel each profile must see once
# a layer a step
# launches a decode step at most, every launch counted (the window opens
# with throwaway kernels: without them it lost up to ~30 first records)
LAUNCH_CEILING = {"profile": 1227, "profile-int8": 2539,
                  "profile-fp16": 1227}
PAGED_KERNEL = {"profile": "B6", "profile-int8": "B7", "profile-fp16": "B6"}


def phase_profile(torch, dev, eng, label="profile", n_steps=8,
                  prompt_len=256):
    """Where a decode step's time goes: 8 rows at 256-token prompts, n_steps
    decode steps under torch.profiler; the device-busy share is kernel time
    over wall time. Reports "not measured" when the profiler sees no
    device activity. The window opens with PROFILE_PAD_KERNELS throwaway
    kernels, left out of every figure: a torch.profiler session late in
    the run can lose its first device records (`_b8_share`; after the jit
    phase it lost one of the 256 B6 launches here)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import Request

    eng.reset()
    rng = np.random.default_rng(9)
    for i in range(eng.max_slots):
        eng.submit(Request(rng.integers(1, eng.args.vocab_size, prompt_len),
                           n_steps + 2, request_id=1000 + i))
    while eng.queue:
        eng.step()
    eng.step()                                   # one unprofiled decode
    torch.cuda.synchronize(dev)
    before = launch_counts()["rms_norm_fwd"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD_KERNELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    norms = (launch_counts()["rms_norm_fwd"] - before) / n_steps
    eng.run_until_idle()
    want = 2 * eng.args.num_layers + 1
    if norms != want:
        raise AssertionError(f"{label}: B9 launched {norms} times a decode "
                             f"step, want {want} (one a norm)")
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0
            and "spin_kernel" not in e.key]
    busy_us = sum(e.self_device_time_total for e in kern)
    if not kern:
        log(f"[{label}] device time not measured: the profiler saw no "
            "device activity")
        return None
    n_launch = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    before_b9 = (f" ({LAUNCHES_BEFORE_B9[label]} in another run before the "
                 f"norms were fused)" if label in LAUNCHES_BEFORE_B9 else "")
    log(f"[{label}] {n_steps} decode steps at {eng.max_slots} rows, "
        f"{prompt_len}-token prompts: wall {wall_us / n_steps / 1e3:.2f} ms "
        f"a step, device busy {busy_us / n_steps / 1e3:.2f} ms a step "
        f"({busy_us / wall_us:.1%}), {n_launch / n_steps:.0f} kernel "
        f"launches a step{before_b9}, B9 {norms:.0f} a step")
    for e in top:
        log(f"[{label}]   {e.self_device_time_total / busy_us:6.1%} "
            f"{e.count / n_steps:5.0f}/step  {e.key[:90]}")
    for kid, frags in PROFILE_NAMES.items():
        mine = [e for e in kern if any(f in e.key for f in frags)]
        if mine:
            us = sum(e.self_device_time_total for e in mine)
            log(f"[{label}]   {kid}: {us / busy_us:.1%} of device time, "
                f"{us / n_steps / 1e3:.3f} ms and "
                f"{sum(e.count for e in mine) / n_steps:.0f} launches a step")
    # the step's launches kernel by kernel, for a diff against another run
    by_kernel = {}
    for e in kern:
        by_kernel[e.key[:120]] = by_kernel.get(e.key[:120], 0) + e.count
    log(f"[{label}] launches a step by kernel: " + json.dumps(
        {k: by_kernel[k] / n_steps for k in sorted(by_kernel)}))
    kid = PAGED_KERNEL[label]
    paged = sum(e.count for e in kern
                if any(f in e.key for f in PROFILE_NAMES[kid])) / n_steps
    if paged != eng.args.num_layers or \
            n_launch / n_steps > LAUNCH_CEILING[label] + 0.5:
        raise AssertionError(
            f"{label}: {kid} launched {paged} times a decode step (want "
            f"{eng.args.num_layers}), {n_launch / n_steps} launches a step "
            f"(at most {LAUNCH_CEILING[label]})")
    return {"wall_ms": wall_us / n_steps / 1e3,
            "busy_ms": busy_us / n_steps / 1e3,
            "launches_per_step": n_launch / n_steps}


def _widen(leaf, dtype):
    """A weight in `dtype` (f32 or f64): a float tensor upcast, or an int8
    QuantizedWeight dequantized (q * scale / 127)."""
    from paddle_tpu_torch.models import QuantizedWeight

    if isinstance(leaf, QuantizedWeight):
        return leaf.q.to(dtype) * (leaf.scale.to(dtype) / 127.0).unsqueeze(-2)
    return leaf.to(dtype)


def _attention(torch, q, k, v):
    """Causal softmax attention in f32 of q [Tq, nh, hd] over k, v
    [Tk, nkv, hd] (GQA); query i sits at position Tk - Tq + i."""
    Tq, Tk, hd = q.shape[0], k.shape[0], q.shape[-1]
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    s = (q.transpose(0, 1) @ k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril(
        Tk - Tq)
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return (p @ v).transpose(0, 1)


def int8_pool_attention(torch, n, page_size):
    """The attention an int8 page pool gives, written out in f32 from the
    reference's semantics and sharing no code with the port: the n prompt
    positions attend to their own K/V unrounded (the prefill); their pages
    are then quantized per (page, kv head) over the prompt's positions
    (absmax, x / absmax * 127 rounded half to even, 0 past the prompt;
    `paged_engine._paged_prefill`); each later position is written with
    the running absmax, restarted at offset 0, the page's codes rescaled
    as round(q * old / new) (`generation._kv_quant_write`), and then
    attends over the dequantized pages (q * scale / 127)."""
    ps = page_size

    def quantize_prompt(x):
        P = -(-x.shape[0] // ps)
        xp = x.new_zeros(P * ps, *x.shape[1:])
        xp[:n] = x[:n]
        xp = xp.view(P, ps, *x.shape[1:])
        scale = xp.abs().amax(dim=(1, 3))                    # [P, nkv]
        codes = torch.round(xp / scale.clamp(min=1e-9)[:, None, :, None]
                            * 127.0).clamp(-127, 127)
        return codes, scale

    def write(codes, scale, t, x):
        p, off = divmod(t, ps)
        old = torch.zeros_like(scale[p]) if off == 0 else scale[p]
        new = torch.maximum(old, x.abs().amax(dim=-1))
        safe = new.clamp(min=1e-9)
        page = codes[p] * (old / safe)[None, :, None]
        page[off] = x / safe[:, None] * 127.0
        codes[p] = torch.round(page).clamp(-127, 127)
        scale[p] = new

    def dequantize(codes, scale, t):
        return (codes * (scale / 127.0)[:, None, :, None]).flatten(0, 1)[
            :t + 1]

    def attend(q, k, v):
        out = torch.empty_like(q)
        out[:n] = _attention(torch, q[:n], k[:n], v[:n])
        (ck, sk), (cv, sv) = quantize_prompt(k), quantize_prompt(v)
        for t in range(n, q.shape[0]):
            write(ck, sk, t, k[t])
            write(cv, sv, t, v[t])
            out[t] = _attention(torch, q[t:t + 1], dequantize(ck, sk, t),
                                dequantize(cv, sv, t))[0]
        return out

    return attend


def _norm(torch, x, w, eps):
    """RMSNorm written out, sharing no code with the port: normalise in
    f32, cast back to x's dtype (an f64 forward's norms round through f32),
    scale by w."""
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * r).to(x.dtype) * w


def reference_logits(torch, model, ids, attend=None, dtype=None):
    """Plain full-sequence forward with no cache, in f32 from the model's
    weights (upcast, or dequantized, one layer at a time): logits
    [T, vocab] f32. The norms are written here (`_norm`), not the port's
    B9. `attend(q, k, v)` ([T, heads, hd] each) replaces causal attention
    over the unrounded K/V (`int8_pool_attention`); `dtype` float64 runs
    the matmuls and the attention in f64 (the norms and RoPE still round
    through f32)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.models import llama_functional as lf

    a = model.args
    T, hd = ids.shape[0], a.head_dim
    attend = attend or (lambda q, k, v: _attention(torch, q, k, v))
    dtype = dtype or torch.float32
    cos, sin = lf.rope_tables(T, hd, a.rope_theta, ids.device)
    h = model.embedding[ids.long()].to(dtype)[None]
    for i in range(a.num_layers):
        lp = {k: _widen(v, dtype) for k, v in model.layer(i).items()}
        x = _norm(torch, h, lp["ln1"], a.rms_eps)
        q = (x @ lp["wq"]).view(1, T, a.num_heads, hd)
        k = (x @ lp["wk"]).view(1, T, a.num_kv_heads, hd)
        v = (x @ lp["wv"]).view(1, T, a.num_kv_heads, hd)
        q, k = lf.apply_rope(q, k, cos, sin)
        o = attend(q[0], k[0], v[0])
        h = h + o.reshape(1, T, -1) @ lp["wo"]
        x = _norm(torch, h, lp["ln2"], a.rms_eps)
        h = h + (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"]
    h = _norm(torch, h, model.final_norm.to(dtype), a.rms_eps)
    return (h @ _widen(model.lm_head, dtype))[0].float()


# paged logits vs an f32 forward: relative error of the logit matrix,
# largest difference against the largest logit, top-1 agreement.
#   bf16 (set before the first run, PERF.md): the paged path rounds
#     activations, K/V and probabilities to bf16 in every one of 32 layers.
#   f32: both sides compute in f32 with TF32 off and differ only in the
#     order of their sums.
#   int8 weights are held to these bars against the f32 forward of their
#     own dequantized values (q * scale / 127): B8 sums the same codes, so
#     what remains is rounding. The int8 pool is held against the f32
#     forward with the pool's rounding written out (`int8_pool_attention`).
#   int8 pool in f32 (set after the f32 bars failed at 7B width, PERF.md
#     section 6): rounding is discontinuous, so the ~1e-5 by which two f32
#     paths differ lands a few codes on the neighbouring one in every
#     layer; those flips moved the logits by 1.3e-3 where the f32 bars
#     allowed 1e-3. The bars sit ~4x above that and an order of magnitude
#     below what the pool's rounding itself moves (~0.09), which is less
#     than what a wrong page scale or a dropped rescale moves. The f64
#     reference measures the floor that flips alone give.
#   fp16 (set before its first run, PERF.md section 6): the paged path
#     rounds where the bf16 one does, to 3 more mantissa bits, so its
#     errors should be about an eighth of bf16's (rel_err 0.066 on these
#     weights); the bars are half of bf16's, top-1 bf16's. The int8 pool
#     under fp16 weights is held to the int8 pool's bars.
#   int8 pool in bf16 (set before its first run): rounding every K/V
#     value to 1/254 of its page's absmax lands on another code wherever
#     the bf16 path's K/V have drifted from the f32 ones by a fraction of a
#     code step, as they have in the later layers; the two roundings then
#     add. Top-1 is recorded, not held (ROADMAP.md section C).
LOGIT_BARS = {"bfloat16": {"rel_err": 0.10, "max_abs_over_max": 0.15,
                           "top1": 0.80},
              "float32": {"rel_err": 1e-3, "max_abs_over_max": 1e-3,
                          "top1": 0.98},
              "int8 pool": {"rel_err": 0.20, "max_abs_over_max": 0.25,
                            "top1": None},
              "int8 pool, f32": {"rel_err": 5e-3, "max_abs_over_max": 1e-2,
                                 "top1": 0.98},
              "float16": {"rel_err": 0.05, "max_abs_over_max": 0.075,
                          "top1": 0.80}}


def as_f32(model):
    """An f32 copy of the model's weights (27 GB at Llama-2-7B width); int8
    weights are dequantized (q * scale / 127)."""
    import torch
    from paddle_tpu_torch.models import Llama

    f32 = torch.float32
    return Llama(model.args, {
        "embedding": model.embedding.float(),
        "layers": {k: _widen(v, f32)
                   for k, v in model.tree()["layers"].items()},
        "final_norm": model.final_norm.float(),
        "lm_head": _widen(model.lm_head, f32)})


def paged_logits(torch, dev, model, req, page_size=16, kv_dtype=None):
    """The request's prompt + generated tokens, teacher-forced: prefill,
    then one paged_decode_step per generated token over a page pool
    holding the prefill's cache (an int8 pool quantizes its pages as the
    engine's prefill does). Returns the next-token logits [m, vocab] f32
    of positions n-1 .. n+m-2."""
    import numpy as np
    from paddle_tpu_torch.models import QuantizedKVPage
    from paddle_tpu_torch.models import generation as gen
    from paddle_tpu_torch.serving.paged_engine import _scatter_pages

    a = model.args
    prompt = req.prompt_ids
    gen_toks = np.asarray(req.token_ids, np.int32)
    n, m = prompt.size, gen_toks.size
    max_len = -(-(n + m) // page_size) * page_size
    P = max_len // page_size
    logits0, ck, cv = gen.prefill(model, prompt[None], max_len, device=dev)
    shape = (a.num_layers, 1 + P, a.num_kv_heads, page_size, a.head_dim)
    pages = torch.arange(1, P + 1, device=dev)
    valid = (torch.arange(max_len, device=dev) < n).reshape(P, page_size)
    pools = []
    for c in (ck, cv):
        new = c[:, 0].reshape(a.num_layers, a.num_kv_heads, P, page_size,
                              a.head_dim).transpose(1, 2)
        if kv_dtype:
            pool = QuantizedKVPage(
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape[:3], dtype=torch.float32, device=dev))
        else:
            pool = torch.zeros(shape, dtype=model.dtype, device=dev)
        _scatter_pages(pool, pages, new, valid)
        pools.append(pool)
    del ck, cv
    pk, pv = pools
    bt = pages.to(torch.int32)[None]
    rows = [logits0[0]]
    for i in range(m - 1):
        lg, _, _ = gen.paged_decode_step(
            model, torch.tensor([int(gen_toks[i])], device=dev), pk, pv, bt,
            torch.tensor([n + i], dtype=torch.int32, device=dev), page_size,
            device=dev)
        rows.append(lg[0])
    return torch.stack(rows)


def forward_ids(torch, dev, req):
    import numpy as np

    return torch.from_numpy(np.concatenate(
        [req.prompt_ids, np.asarray(req.token_ids, np.int32)])).to(dev)


def compare(torch, label, what, paged, ref, bars=None):
    """Error statistics of `paged` against `ref` [m, vocab]; raises when a
    bar is missed (bars None, or a top-1 bar of None: recorded, not
    held)."""
    err = (paged - ref).abs()
    stats = {"max_abs_err": err.max().item(),
             "max_abs_over_max": (err.max() / ref.abs().max()).item(),
             "rel_err": ((paged - ref).norm() / ref.norm()).item(),
             "top1": (paged.argmax(-1) == ref.argmax(-1)).float().mean()
             .item(),
             "positions": paged.shape[0]}
    held = bars or {"rel_err": None, "max_abs_over_max": None, "top1": None}
    shown = {k: "recorded, not held" if b is None else b
             for k, b in held.items()}
    log(f"[{label}] {what}, {stats['positions']} positions: "
        f"max_abs_err {stats['max_abs_err']:.3e} "
        f"({stats['max_abs_over_max']:.3e} of the largest logit, bar "
        f"{shown['max_abs_over_max']}), rel_err {stats['rel_err']:.3e} "
        f"(bar {shown['rel_err']}), top-1 agreement {stats['top1']:.3f} "
        f"(bar {shown['top1']})")
    ok = torch.isfinite(paged).all().item() and all(
        b is None or (stats[k] >= b if k == "top1" else stats[k] <= b)
        for k, b in held.items())
    if not ok:
        raise AssertionError(f"{what}: {stats}")
    return stats


def phase_logits(torch, dev, model, req):
    """bf16 paged logits against the plain f32 forward of the same weights,
    then the paged path with the weights in f32 against the same forward."""
    n = req.prompt_ids.size
    ref = reference_logits(torch, model, forward_ids(torch, dev, req))
    ref = ref[n - 1:n - 1 + len(req.token_ids)]
    compare(torch, "logits", f"bf16 weights vs the f32 forward, after a "
            f"{n}-token prompt", paged_logits(torch, dev, model, req), ref,
            LOGIT_BARS["bfloat16"])
    f32 = as_f32(model)
    compare(torch, "logits", "f32 weights vs the f32 forward",
            paged_logits(torch, dev, f32, req), ref, LOGIT_BARS["float32"])


def phase_logits_cuts(torch, dev, model, req):
    """The logits phase's bf16 check, recorded and not held, with the
    decode rows' keys (B6, 9-10 tiles) cut over 1, 2, 3 and 4 splits
    (`attention.PAGED_SPLIT_TILES` set by hand to 16, 5, 4 and 3): how far
    its statistics move with the rounding of one kernel's split alone."""
    from paddle_tpu_torch.kernels import attention as at

    n = req.prompt_ids.size
    ref = reference_logits(torch, model, forward_ids(torch, dev, req))
    ref = ref[n - 1:n - 1 + len(req.token_ids)]
    saved = at.PAGED_SPLIT_TILES
    try:
        for tiles in (16, 5, 4, 3):
            at.PAGED_SPLIT_TILES = tiles
            compare(torch, "logits-cuts", f"bf16 weights vs the f32 forward, "
                    f"after a {n}-token prompt, {tiles} tiles a split",
                    paged_logits(torch, dev, model, req), ref)
    finally:
        at.PAGED_SPLIT_TILES = saved


def phase_logits_int8(torch, dev, qmodel, req, page_size=16):
    """int8 weights against the f32 forward of their dequantized values:
    (a) with the bf16 pool; (b) with the int8 pool, against that forward
    with the pool's rounding written out, and the same in f32 (the
    check that leaves no room for a fault). Recorded beside: the floor
    the code flips of f32 summation order give (the reference against
    itself with f64 matmuls), and what the int8 pool's rounding itself
    moves (the two f32 forwards against each other)."""
    n = req.prompt_ids.size
    ids = forward_ids(torch, dev, req)[:-1]
    ref = reference_logits(torch, qmodel, ids)[n - 1:]
    compare(torch, "logits-int8", f"(a) int8 weights, bf16 pool vs the f32 "
            f"forward, after a {n}-token prompt",
            paged_logits(torch, dev, qmodel, req, page_size), ref,
            LOGIT_BARS["bfloat16"])
    ref8 = reference_logits(torch, qmodel, ids, int8_pool_attention(
        torch, n, page_size))[n - 1:]
    q8 = paged_logits(torch, dev, qmodel, req, page_size, kv_dtype="int8")
    compare(torch, "logits-int8", "(b) int8 weights, int8 pool vs the f32 "
            "forward over the int8 pool's rounding", q8, ref8,
            LOGIT_BARS["int8 pool"])
    f32 = as_f32(qmodel)
    q8_f32 = paged_logits(torch, dev, f32, req, page_size, kv_dtype="int8")
    del f32
    compare(torch, "logits-int8", "(b) in f32: the int8-pool path with f32 "
            "weights vs the same forward", q8_f32, ref8,
            LOGIT_BARS["int8 pool, f32"])
    ref8_64 = reference_logits(torch, qmodel, ids, int8_pool_attention(
        torch, n, page_size), dtype=torch.float64)[n - 1:]
    compare(torch, "logits-int8", "floor: that forward vs itself with f64 "
            "matmuls and attention", ref8, ref8_64)
    compare(torch, "logits-int8", "the int8 pool's rounding: the f32 "
            "forward over it vs the f32 forward", ref8, ref)


def phase_generate(torch, dev, model, b=4, lengths=(48, 128), new_tokens=32,
                   label="generate"):
    """`generate` (the stripe cache) at b=4; returns the launch counts."""
    import numpy as np
    from paddle_tpu_torch.models import generate

    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, model.args.vocab_size, size=(b, s)).astype(
        np.int32) for s in lengths]
    torch.cuda.synchronize(dev)
    reset_launches()
    t0 = time.perf_counter()
    outs = [generate(model, p, max_new_tokens=new_tokens, device=dev)
            for p in prompts]
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = launch_counts()
    for p, o in zip(prompts, outs):
        o = o.cpu().numpy()
        if o.shape != (b, p.shape[1] + new_tokens) or \
                not (o[:, :p.shape[1]] == p).all() or \
                not ((o >= 0) & (o < model.args.vocab_size)).all():
            raise AssertionError(f"generate output malformed: {o.shape}")
    log(f"[{label}] b={b} prompts {list(lengths)}, {new_tokens} new tokens "
        f"each, in {secs:.2f} s; launches {launches}")
    need = ["decode_attention", "window_attention"] + (
        ["weight_only_matmul"] if model.quantized else [])
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"generate did not run {need}: {launches}")
    log(f"[{label}] B4: {launches['decode_attention']} launches on its "
        f"{b4_route(model.dtype)}")
    return launches


def b4_route(dtype):
    """Which of B4's kernels a call in `dtype` launches, in words."""
    from paddle_tpu_torch.kernels import attention as at

    return ("cluster route (decode_mma_kernel, keys by TMA)"
            if at.paged_route(dtype) == "cluster"
            else "shared body") + f" ({str(dtype).replace('torch.', '')})"


def _quantile(xs, q):
    """bench.py's quantile (`_bench_chunked_prefill` :576)."""
    xs = sorted(xs)
    return xs[min(int(q * len(xs)), len(xs) - 1)]


def phase_chunked(torch, dev, model, seed=0):
    """Chunked prefill against monolithic prefill at the reference's TPU
    settings (bench.py `_bench_chunked_prefill` :537-546): 16 slots,
    max_len 2048, pages of 64, chunks of 256, buckets from 64; a burst of 2
    long prompts (1536 tokens) dropped into 32 short ones (24-96 tokens),
    arriving 2.5 steps apart, 32 new tokens each. Holds: every request
    completes with its tokens, 2 chunked prefills, the chunk count the
    prompts imply. Records the short requests' TTFT (p50, p99) of both runs
    and their p99 ratio (the reference's bar, <= 0.5 on its TPU, is
    recorded, not held), tokens/s, and the greedy agreement of the two runs.
    Returns the launch counts of the chunked run."""
    from paddle_tpu_torch.serving import (PagedEngine, make_mixed_trace,
                                          trace_stats)

    slots, max_len, ps, chunk, min_bucket = 16, 2048, 64, 256, 64
    trace = make_mixed_trace(seed=seed, n_short=32,
                             short_len_choices=(24, 40, 57, 96), n_long=2,
                             long_len=1536, mean_interarrival_steps=2.5,
                             new_tokens_choices=(32,), long_new_tokens=32,
                             vocab_size=model.args.vocab_size)
    long_ids = {t["request_id"] for t in trace if t["long"]}
    runs = {}
    for mode, prefill_chunk in (("monolithic", None), ("chunked", chunk)):
        eng = PagedEngine(model, max_slots=slots, max_len=max_len,
                          page_size=ps, min_bucket=min_bucket,
                          prefill_chunk=prefill_chunk, device=dev)
        torch.cuda.synchronize(dev)
        reset_launches()
        t0 = time.perf_counter()
        reqs = eng.replay(trace)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        launches = launch_counts()
        m = eng.metrics.summary()
        c = m["counters"]
        short = [r.ttft_s for r in reqs if r.request_id not in long_ids]
        long_max = max(r.ttft_s for r in reqs if r.request_id in long_ids)
        toks = sum(len(r.token_ids) for r in reqs)
        runs[mode] = {"reqs": reqs, "launches": launches,
                      "p50": _quantile(short, 0.5),
                      "p99": _quantile(short, 0.99)}
        obs = m["observations"]
        pre, dec = obs["prefill_s"], obs["decode_step_s"]
        log(f"[chunked] {mode}: {len(reqs)} requests, {toks} tokens in "
            f"{secs:.2f} s ({toks / secs:.1f} tokens/s), {eng.step_count} "
            f"steps: {pre['count']} prefill windows (mean "
            f"{pre['mean'] * 1e3:.1f} ms, max {pre['max'] * 1e3:.1f} ms, "
            f"{pre['sum']:.2f} s in all), {dec['count']} decode steps (mean "
            f"{dec['mean'] * 1e3:.1f} ms, {dec['sum']:.2f} s in all); "
            f"short TTFT p50 {runs[mode]['p50'] * 1e3:.1f} ms, p99 "
            f"{runs[mode]['p99'] * 1e3:.1f} ms; long TTFT max "
            f"{long_max * 1e3:.1f} ms; chunked prefills "
            f"{c.get('chunked_prefills', 0)}, chunks "
            f"{c.get('prefill_chunks', 0)}, prefill stall steps "
            f"{int(m['gauges'].get('prefill_stall_steps', {}).get('max', 0))}"
            f"; launches {launches}")
        for r in reqs:
            if not (r.finished and len(r.token_ids) == r.max_new_tokens):
                raise AssertionError(f"chunked ({mode}): request "
                                     f"{r.request_id} did not complete")
        if prefill_chunk:
            want = sum(-(-len(t["prompt"]) // chunk) for t in trace
                       if len(t["prompt"]) > chunk)
            if c.get("chunked_prefills", 0) != len(long_ids) or \
                    c.get("prefill_chunks", 0) != want:
                raise AssertionError(f"chunked: {c.get('chunked_prefills')} "
                                     f"streams, {c.get('prefill_chunks')} "
                                     f"chunks (want {len(long_ids)}, {want})")
        del eng
        torch.cuda.empty_cache()
    mono, chk = runs["monolithic"], runs["chunked"]
    same = [x.token_ids == y.token_ids for x, y in zip(mono["reqs"],
                                                       chk["reqs"])]
    agree = [sum(a == b for a, b in zip(x.token_ids, y.token_ids))
             / len(x.token_ids) for x, y in zip(mono["reqs"], chk["reqs"])]
    log(f"[chunked] trace {trace_stats(trace)}; short TTFT p99 chunked / "
        f"monolithic {chk['p99'] / mono['p99']:.3f} (the reference's bar "
        f"on its TPU was <= 0.5: recorded, not held); greedy tokens of the "
        f"two runs: {sum(same)} of {len(same)} requests equal, mean token "
        f"agreement {sum(agree) / len(agree):.3f} (bf16: recorded; the "
        f"CPU tests hold exactness)")
    need = ("rms_norm_fwd", "window_attention", "paged_decode_attention")
    if not all(chk["launches"][k] > 0 for k in need):
        raise AssertionError(f"chunked: {need} not all launched: "
                             f"{chk['launches']}")
    return chk["launches"]


def spec_model(torch, dev, dtype, draft_layers=4):
    """`_bench_speculative`'s target at its TPU settings (bench.py
    :629-639): h2048, 16 layers, 16 heads, vocab 32000, random weights
    from seed 0 whose later layers' wo and w_down are damped to 0.02 (a
    stand-in for a trained draft's agreement), and its 4-layer draft."""
    from paddle_tpu_torch.models import Llama, LlamaArgs, init_params
    from paddle_tpu_torch.models import draft_from_params

    args = LlamaArgs(vocab_size=32000, hidden_size=2048,
                     intermediate_size=5504, num_layers=16, num_heads=16,
                     num_kv_heads=16, rope_theta=1e4, rms_eps=1e-6,
                     use_flash=False)
    gen_ = torch.Generator(device=dev).manual_seed(0)
    params = init_params(args, gen_, device=dev, dtype=dtype)
    damp = torch.tensor([1.0] * draft_layers
                        + [0.02] * (args.num_layers - draft_layers),
                        device=dev).reshape(-1, 1, 1).to(dtype)
    for k in ("wo", "w_down"):
        params["layers"][k] = params["layers"][k] * damp
    target = Llama(args, params)
    return target, draft_from_params(target, draft_layers)


def _serve_trace(torch, dev, model, trace, **kw):
    """One replay of `trace` through a PagedEngine at the speculative leg's
    settings: (requests, seconds, metrics summary, launches)."""
    from paddle_tpu_torch.serving import PagedEngine

    eng = PagedEngine(model, max_slots=8, max_len=1024, page_size=64,
                      min_bucket=64, device=dev, **kw)
    torch.cuda.synchronize(dev)
    reset_launches()
    t0 = time.perf_counter()
    reqs = eng.replay(trace)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    return reqs, secs, eng.metrics.summary(), launch_counts()


def phase_spec(torch, dev, model):
    """Speculative decoding. (a) parity: `_bench_speculative`'s settings
    (`spec_model`, spec_tokens 4, 8 slots, max_len 1024, pages of 64,
    make_trace seed 0: 24 requests of 24-96 tokens, 128 new tokens each) in
    f32, plain greedy against speculative: equal token for token, as
    bench.py asserts (:682-685). (b) speed: the same in bf16, tokens/s of
    both and their ratio (the reference's bar, >= 1.5x on its TPU, is
    recorded, not held). (c) Llama-2-7B width: the engine phase's model
    with its 4-layer draft, 4 greedy requests x 32 tokens, one at a time,
    beside a plain engine brought to the same positions after each round:
    the block tables, refcounts and reservations must be equal after every
    round (a random 7B draft is rejected in most rounds, so this holds the
    all-rejected rollback at full width).
    Returns the launch counts of (b)'s speculative run."""
    from paddle_tpu_torch.serving import make_trace

    trace = make_trace(seed=0, n_requests=24, mean_interarrival_steps=0.5,
                       prompt_len_choices=(24, 40, 57, 96),
                       new_tokens_choices=(128,), vocab_size=32000)
    spec_launches = None
    for leg, dtype in (("(a) parity, f32", torch.float32),
                       ("(b) speed, bf16", torch.bfloat16)):
        target, draft = spec_model(torch, dev, dtype)
        greedy, g_secs, _, _ = _serve_trace(torch, dev, target, trace)
        spec, s_secs, m, launches = _serve_trace(
            torch, dev, target, trace, draft_params=draft, spec_tokens=4)
        c = m["counters"]
        toks = sum(len(r.token_ids) for r in spec)
        equal = [x.token_ids == y.token_ids for x, y in zip(greedy, spec)]
        acc = c.get("draft_tokens_accepted", 0) / max(
            c.get("draft_tokens_proposed", 1), 1)
        log(f"[spec] {leg}: h2048, 16 layers, 4-layer draft, spec_tokens "
            f"4: greedy {toks / g_secs:.1f} tokens/s, speculative "
            f"{toks / s_secs:.1f} tokens/s, ratio {g_secs / s_secs:.3f} (the "
            f"reference's bar on its TPU was >= 1.5: recorded, not held); "
            f"acceptance rate {acc:.3f}, {c.get('spec_rounds', 0)} rounds, "
            f"{c.get('spec_pages_rewound', 0)} pages rewound; "
            f"{sum(equal)} of {len(equal)} requests equal to plain greedy; "
            f"launches {launches}")
        if not all(r.finished and len(r.token_ids) == r.max_new_tokens
                   for r in spec):
            raise AssertionError(f"spec {leg}: unfinished requests")
        if dtype == torch.float32 and not all(equal):
            first = equal.index(False)
            raise AssertionError(
                f"spec {leg}: speculative decoding broke greedy parity "
                f"(request {spec[first].request_id})")
        need = ("rms_norm_fwd", "decode_attention", "window_attention")
        if not all(launches[k] > 0 for k in need):
            raise AssertionError(f"spec {leg}: {need} not all launched: "
                                 f"{launches}")
        log(f"[spec] {leg}: the draft's decode steps launched B4 "
            f"{launches['decode_attention']} times on its "
            f"{b4_route(draft.dtype)}")
        spec_launches = launches
        del target, draft, greedy, spec
        torch.cuda.empty_cache()
    spec_7b_leg(torch, dev, model)
    return spec_launches


def spec_7b_leg(torch, dev, model, label="spec"):
    """`phase_spec`'s leg (c): the model at Llama-2-7B width with its
    4-layer draft, 4 greedy requests x 32 tokens one at a time beside a
    plain engine; block tables, refcounts and reservations held equal
    after every round. Returns the leg's launch counts (B5 through the
    verify window)."""
    import numpy as np
    from paddle_tpu_torch.models import draft_from_params
    from paddle_tpu_torch.serving import PagedEngine, Request

    dname = str(model.dtype).replace("torch.", "")
    torch.cuda.synchronize(dev)
    reset_launches()
    draft = draft_from_params(model, 4)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, model.args.vocab_size, size=n).astype(np.int32)
               for n in (40, 77, 130, 300)]
    kw = dict(max_slots=8, max_len=2048, page_size=16, min_bucket=16,
              device=dev)
    plain = PagedEngine(model, **kw)
    spec = PagedEngine(model, draft_params=draft, spec_tokens=4, **kw)

    def state(eng):
        return (tuple(tuple(row) for row in eng._bt),
                tuple(tuple(eng._alloc.refcount(pg) for pg in row)
                      for row in eng._bt),
                eng._alloc.free_count, eng._alloc.available,
                dict(eng._resv), eng._reserved_total)

    def held(what):
        if state(plain) != state(spec):
            raise AssertionError(f"spec 7B: after {what} the block tables, "
                                 "refcounts or reservations differ from a "
                                 "plain engine's at the same positions")

    rounds = rejected = 0
    agree = []
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        rp = plain.submit(Request(p, 32, request_id=i))
        rs = spec.submit(Request(p, 32, request_id=i))
        plain.step(), spec.step()                         # prefill
        held("a prefill")
        while not rs.finished:
            (committed,) = spec.step()["tokens"].values()
            rounds += 1
            rejected += len(committed) == 1
            while len(rp.token_ids) < len(rs.token_ids):
                plain.step()
            held(f"round {rounds} ({len(committed)} tokens committed)")
        agree.append(sum(a == b for a, b in zip(rp.token_ids, rs.token_ids))
                     / len(rs.token_ids))
    secs = time.perf_counter() - t0
    c = spec.metrics.summary()["counters"]
    acc = c.get("draft_tokens_accepted", 0) / max(
        c.get("draft_tokens_proposed", 1), 1)
    torch.cuda.synchronize(dev)
    launches = all_counts()
    log(f"[{label}] (c) Llama-2-7B width, {dname}, 4-layer draft, 4 "
        f"requests x 32 tokens, one at a time, in {secs:.2f} s beside the "
        f"plain engine: {rounds} rounds, {rejected} of them rejecting every "
        f"draft, acceptance rate {acc:.3f}, "
        f"{c.get('spec_pages_rewound', 0)} pages rewound; block tables, "
        f"refcounts and reservations equal to the plain engine's after "
        f"every round; token agreement with plain greedy "
        f"{[round(a, 3) for a in agree]} ({dname}: recorded); B5 "
        f"{launches['window_attention']} launches")
    if not (rejected > 0 and spec._alloc.pages_in_use == 0
            and c.get("spec_pages_rewound", 0) > 0
            and launches["window_attention"] > 0):
        raise AssertionError(f"{label} 7B: no all-rejected round, no page "
                             "rewound, pages still held or no B5 launch")
    return launches


# the kernels each leg of the serve-fp16 phase must launch in fp16. The
# engine's prefill runs `generation._cached_attention` as the reference's
# does: B5 for windows of at most 64 query rows a kv head, the plain masked
# attention above that; B1 is not on the serving path in any dtype
SERVE_FP16_LAUNCHES = {
    "fp16 pool": ("paged_decode_attention_f16", "window_attention_f16",
                  "rms_norm_fwd_f16"),
    "int8 pool": ("paged_decode_attention_int8_f16", "rms_norm_fwd_f16"),
    "generate": ("decode_attention_f16", "window_attention_f16"),
    "spec": ("window_attention_f16",)}
# each fp16 variant beside its total: on the card every call of the kernel
# in an fp16 leg is an fp16 launch (none took another route, none raised)
F16_OF = {f"{k}_f16": k for k in ("decode_attention", "window_attention",
                                  "paged_decode_attention",
                                  "paged_decode_attention_int8",
                                  "rms_norm_fwd")}


def handoff_fp16(torch, dev, model, new_tokens=32):
    """One fp16 request (the engine traffic's 712-token prompt) through
    `DisaggServer`: its pages packed by `KVHandoff.to_bytes` (dtype
    "float16" in the header), read back by `from_bytes` and scattered into
    the decode worker's fp16 pool, each shipped page bit-identical there
    (`_watch_admissions`); its tokens must equal the monolithic
    `PagedEngine`'s, served alone the same way."""
    from paddle_tpu_torch.serving import DisaggServer, PagedEngine, Request

    kw = dict(max_slots=8, max_len=2048, page_size=16, min_bucket=16,
              device=dev)
    prompt = engine_traffic(model.args.vocab_size)[7]["prompt"]
    mono = Request(prompt, new_tokens, request_id=0)
    PagedEngine(model, **kw).serve([mono])
    srv = DisaggServer(model, **kw)
    seen = _watch_admissions(torch, srv.decode)
    moved = Request(prompt, new_tokens, request_id=0)
    srv.serve([moved])
    torch.cuda.synchronize(dev)
    pm = srv.prefill.metrics
    equal = moved.token_ids == mono.token_ids
    log(f"[serve-fp16] hand-off: a {prompt.size}-token request, "
        f"{sum(seen['pages'])} fp16 pages "
        f"({pm.counter('handoff_bytes') / 1e6:.1f} MB) through to_bytes / "
        f"from_bytes into the decode pool ({srv.decode._pk.dtype}), each "
        f"page bit-identical there; latency {_ms(seen['latency_s'])}; its "
        f"{len(moved.token_ids)} tokens equal to the monolithic engine's: "
        f"{equal}")
    _drained("serve-fp16 hand-off", srv.prefill, srv.decode)
    if not (equal and len(seen["pages"]) == 1
            and srv.decode._pk.dtype == torch.float16
            and len(moved.token_ids) == new_tokens):
        raise AssertionError(f"serve-fp16 hand-off: tokens {moved.token_ids}"
                             f" vs {mono.token_ids}")


def phase_serve_fp16(torch, dev, bf16=None):
    """Serving in fp16: `Llama(LLAMA2_7B, init_params(..., float16))`, all
    32 layers, from the engine phase's seed. (a) `phase_engine` on the
    engine traffic over an fp16 pool, then its profiled decode window; (b)
    the same traffic over an int8 pool; (c) `generate`; (d) `phase_spec`'s
    Llama-2-7B leg (B5 through the verify window); (e) one request's fp16
    pages handed off (`handoff_fp16`); (f) the fp16 paged logits against
    the f32 forward of the same weights (LOGIT_BARS["float16"]), and over
    the int8 pool against that forward over the pool's rounding. Each leg
    must launch its kernels in fp16 (SERVE_FP16_LAUNCHES), and every
    launch of those kernels in a leg must be an fp16 one. `bf16`: the
    engine phase's stats and profile, logged beside. Returns the phase's
    launch counts."""
    from paddle_tpu_torch.models import LLAMA2_7B, Llama, init_params

    t0 = time.perf_counter()
    gen_ = torch.Generator(device=dev).manual_seed(0)
    model = Llama(LLAMA2_7B, init_params(LLAMA2_7B, gen_, device=dev,
                                         dtype=torch.float16))
    log(f"[serve-fp16] Llama-2-7B width, {LLAMA2_7B.num_layers} layers, "
        f"fp16, drawn in {time.perf_counter() - t0:.1f} s")
    total, legs = {}, {}
    reqs, _, stats, eng = phase_engine(torch, dev, model, label="serve-fp16")
    legs["fp16 pool"] = all_counts()
    prof = phase_profile(torch, dev, eng, label="profile-fp16")
    eng = None
    _, _, qstats, eng = phase_engine(torch, dev, model, kv_dtype="int8",
                                     label="serve-fp16-int8")
    legs["int8 pool"] = all_counts()
    eng = None
    torch.cuda.empty_cache()
    phase_generate(torch, dev, model, label="generate-fp16")
    legs["generate"] = all_counts()
    legs["spec"] = spec_7b_leg(torch, dev, model, label="serve-fp16 spec")
    torch.cuda.empty_cache()
    handoff_fp16(torch, dev, model)
    torch.cuda.empty_cache()

    req = reqs[3]
    n = req.prompt_ids.size
    ids = forward_ids(torch, dev, req)[:-1]
    ref = reference_logits(torch, model, ids)[n - 1:]
    compare(torch, "serve-fp16", f"fp16 weights and pool vs the f32 forward, "
            f"after a {n}-token prompt", paged_logits(torch, dev, model, req),
            ref, LOGIT_BARS["float16"])
    ref8 = reference_logits(torch, model, ids, int8_pool_attention(
        torch, n, 16))[n - 1:]
    compare(torch, "serve-fp16", "fp16 weights, int8 pool vs the f32 forward "
            "over the int8 pool's rounding",
            paged_logits(torch, dev, model, req, kv_dtype="int8"), ref8,
            LOGIT_BARS["int8 pool"])
    del ref, ref8

    for leg, counts in legs.items():
        _add(total, counts)
        zero = [k for k in SERVE_FP16_LAUNCHES[leg] if counts[k] == 0]
        other = {k: (counts[k], counts[base]) for k, base in F16_OF.items()
                 if counts[k] != counts[base]}
        log(f"[serve-fp16] {leg}: fp16 launches "
            + ", ".join(f"{k} {counts[k]}" for k in F16_OF))
        if zero or other:
            raise AssertionError(f"serve-fp16 {leg}: not launched in fp16 "
                                 f"{zero}; launches not in fp16 {other}")
    busy = (f"{prof['busy_ms']:.2f} of {prof['wall_ms']:.2f} ms "
            f"({prof['busy_ms'] / prof['wall_ms']:.1%})" if prof
            else "not measured")
    line = (f"[serve-fp16] fp16: {stats['tokens_per_s']:.1f} tokens/s, decode "
            f"step p50 {stats['decode_step_p50_s'] * 1e3:.2f} ms, a profiled "
            f"decode step's device busy {busy}; int8 pool "
            f"{qstats['tokens_per_s']:.1f} tokens/s")
    if bf16 is not None:
        st, bp = bf16
        line += (f"; bf16 (the engine phase): {st['tokens_per_s']:.1f} "
                 f"tokens/s, decode step p50 "
                 f"{st['decode_step_p50_s'] * 1e3:.2f} ms"
                 + (f", busy {bp['busy_ms']:.2f} of {bp['wall_ms']:.2f} ms"
                    if bp else ""))
    log(line + f"; the phase took {time.perf_counter() - t0:.1f} s")
    return total


def phase_capacity(torch, dev, model, seed=0):
    """The reference's equal-KV-bytes leg at its TPU settings (bench.py
    `_bench_int8_kv_pool`): page size 64, max_len 1024, 24 slots, buckets
    from 64; 48 requests arriving 0.25 steps apart on average, prompts of
    192/256/320 tokens, 64 new tokens each. The model-dtype pool gets 48
    pages; the int8 pool the pages the same bytes buy. Each pool replays
    the trace once (nothing compiles, so nothing warms up). Returns the
    launch counts."""
    import numpy as np
    from paddle_tpu_torch.serving import PagedEngine, make_trace

    a = model.args
    ps, max_len, slots, base_pages, min_bucket = 64, 1024, 24, 48, 64
    trace = make_trace(seed=seed, n_requests=48, mean_interarrival_steps=0.25,
                       prompt_len_choices=(192, 256, 320),
                       new_tokens_choices=(64,), vocab_size=a.vocab_size)
    reset_launches()

    def run(num_pages, kv_dtype):
        eng = PagedEngine(model, max_slots=slots, max_len=max_len,
                          page_size=ps, num_pages=num_pages,
                          min_bucket=min_bucket, kv_dtype=kv_dtype,
                          device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        reqs = eng.replay(trace)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        m = eng.metrics.summary()
        toks = sum(len(r.token_ids) for r in reqs)
        out = {"num_pages": num_pages,
               "kv_pool_bytes": int(m["gauges"]["kv_pool_bytes"]["value"]),
               "slots": int(m["gauges"]["active_slots"]["max"]),
               "tokens_per_s": toks / secs, "seconds": secs,
               "steps": eng.step_count}
        log(f"[capacity] {kv_dtype or str(model.dtype)} pool: {num_pages} "
            f"pages, {out['kv_pool_bytes'] / 2**30:.3f} GiB, sustained "
            f"slots {out['slots']}, {eng.step_count} steps, {toks} tokens "
            f"in {secs:.2f} s ({out['tokens_per_s']:.1f} tokens/s)")
        if not all(r.finished for r in reqs):
            raise AssertionError(f"capacity: unfinished requests "
                                 f"({kv_dtype})")
        return reqs, out

    base_reqs, base = run(base_pages, None)
    int8_page_bytes = 2 * a.num_layers * a.num_kv_heads * (ps * a.head_dim
                                                           + 4)
    int8_reqs, int8 = run(base["kv_pool_bytes"] // int8_page_bytes, "int8")
    ratio = int8["slots"] / max(base["slots"], 1)
    agreement = [float(np.mean(np.asarray(x.token_ids)
                               == np.asarray(y.token_ids)))
                 for x, y in zip(int8_reqs, base_reqs)]
    launches = launch_counts()
    log(f"[capacity] sustained-slot ratio {ratio:.3f} (bar 1.8), pool bytes "
        f"int8/model dtype {int8['kv_pool_bytes'] / base['kv_pool_bytes']:.4f}"
        f"; per-request top-1 agreement with the model-dtype pool: min "
        f"{min(agreement):.3f}, mean {float(np.mean(agreement)):.3f} "
        f"(random weights, free-running: recorded, not held); launches "
        f"{launches}")
    if not (ratio >= 1.8 and int8["kv_pool_bytes"] <= base["kv_pool_bytes"]):
        raise AssertionError(f"capacity: ratio {ratio}, bytes "
                             f"{int8['kv_pool_bytes']} vs "
                             f"{base['kv_pool_bytes']}")
    return launches


# ---------------------------------------------------------------------------
# disaggregated prefill/decode, and the router over three models
# ---------------------------------------------------------------------------


def _small_f32(torch, dev, model, layers=2):
    """The model's width in f32 with `layers` layers, drawn from seed 0."""
    from paddle_tpu_torch.models import Llama, init_params

    args = model.args._replace(num_layers=layers)
    gen_ = torch.Generator(device=dev).manual_seed(0)
    return Llama(args, init_params(args, gen_, device=dev,
                                   dtype=torch.float32))


def _watch_admissions(torch, worker, check=True):
    """Wrap `worker.admit_handoff` to record each hand-off's pages and its
    latency (send to seated, wall clock, exact; the registry keeps only
    bucketed quantiles) and, with `check`, to hold every shipped leaf bit
    for bit against what the pool holds under the slot's block table
    after the scatter (the check's own time is kept apart)."""
    from paddle_tpu_torch.serving.paged_engine import _leaves

    seen = {"pages": [], "latency_s": [], "check_s": 0.0}
    admit = worker.admit_handoff

    def watched(pkg):
        req = admit(pkg)
        torch.cuda.synchronize(worker.device)
        seen["latency_s"].append(time.time() - pkg.sent_at)
        seen["pages"].append(pkg.num_pages)
        if not check:
            return req
        t0 = time.perf_counter()
        slot = next(s for s in worker.slots.active_slots
                    if worker.slots.owner(s) is req)
        idx = torch.tensor(worker._bt[slot], dtype=torch.long,
                           device=worker.device)
        pool = _leaves(worker._pk) + _leaves(worker._pv)
        for shipped, held in zip(pkg._leaves(), pool):
            if not torch.equal(shipped.view(torch.uint8),       # the bits
                               held[:, idx].cpu().view(torch.uint8)):
                raise AssertionError(f"hand-off {pkg.request_id}: the pool "
                                     f"does not hold the shipped pages")
        seen["check_s"] += time.perf_counter() - t0
        return req

    worker.admit_handoff = watched
    return seen


def _pack_scatter(pm, dm):
    """The prefill side's pack (serialise, the D2H copy included) and the
    decode side's scatter times: mean and max (exact in the registry)."""
    pk, sc = pm.observation("handoff_pack_s"), dm.observation("page_scatter_s")
    return (f"pack mean {pk['mean'] * 1e3:.1f} max {pk['max'] * 1e3:.1f} ms, "
            f"scatter mean {sc['mean'] * 1e3:.1f} max "
            f"{sc['max'] * 1e3:.1f} ms")


def _ms(xs):
    """Median and max of seconds, in ms, for a log line."""
    return (f"median {statistics.median(xs) * 1e3:.1f} ms, max "
            f"{max(xs) * 1e3:.1f} ms")


def _drained(label, *workers):
    for w in workers:
        if w._alloc.pages_in_use or w._reserved_total or \
                w.slots.free_count != w.max_slots:
            raise AssertionError(f"{label}: {type(w).__name__} did not drain: "
                                 f"{w._alloc.pages_in_use} pages in use, "
                                 f"{w._reserved_total} reserved")


def _serve_tokens(eng, prompts, new_tokens):
    from paddle_tpu_torch.serving import Request

    reqs = [Request(p, new_tokens, request_id=i)
            for i, p in enumerate(prompts)]
    eng.serve(reqs)
    return [list(r.token_ids) for r in reqs]


DISAGG_LEG = dict(max_slots=8, max_len=2048, page_size=64, min_bucket=64)


def phase_disagg(torch, dev, model, mono_reqs, new_tokens=64):
    """Disaggregated serving on the 7B model. (a) bf16, 32 layers: the
    engine phase's 12 requests through `DisaggServer` over
    `LocalTransport` at the engine's settings: every shipped page equals
    what the decode pool holds after the scatter, bit for bit; first
    tokens equal the monolithic engine's; both workers drain. Token
    agreement with the monolithic run is recorded (bf16 rows decoded in
    other batches may round otherwise). (b) f32, 2 layers at 7B width:
    greedy, over the int8 pool, and chunked (256): tokens equal to the
    monolithic `PagedEngine`'s, request for request. (c) bench.py's disagg
    leg at its TPU settings (:1133-1145): the steady stream's tokens per
    scheduler step through a 4 x 1536-token burst within 0.9-1.1 of its
    base (held), the monolithic counterfactual, hand-off MB and latency,
    decode step ms and tokens/s (recorded). Returns (a)'s launch counts."""
    from paddle_tpu_torch.serving import DisaggServer, PagedEngine, Request

    srv = DisaggServer(model, max_slots=8, max_len=2048, page_size=16,
                       min_bucket=16, device=dev)
    seen = _watch_admissions(torch, srv.decode)
    traffic = engine_traffic(model.args.vocab_size)
    reqs = [Request(t.pop("prompt"), new_tokens, request_id=i, **t)
            for i, t in enumerate(traffic)]
    torch.cuda.synchronize(dev)
    reset_launches()
    t0 = time.perf_counter()
    srv.serve(reqs)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = launch_counts()
    n_tok = sum(len(r.token_ids) for r in reqs)
    firsts = [r.token_ids[0] for r in reqs] == \
        [r.token_ids[0] for r in mono_reqs]
    same = sum(r.token_ids == m.token_ids for r, m in zip(reqs, mono_reqs))
    pos_agree = sum(a == b for r, m in zip(reqs, mono_reqs)
                    for a, b in zip(r.token_ids, m.token_ids))
    pm = srv.prefill.metrics
    served = secs - seen["check_s"]
    log(f"[disagg] (a) bf16: {len(reqs)} requests, {n_tok} tokens in "
        f"{served:.2f} s without the page checks' {seen['check_s']:.2f} s "
        f"({n_tok / served:.1f} tokens/s); {len(seen['pages'])} hand-offs, "
        f"{sum(seen['pages'])} pages, "
        f"{pm.counter('handoff_bytes') / 1e6:.1f} MB, each page bit-identical "
        f"in the decode pool; latency {_ms(seen['latency_s'])}, "
        f"{_pack_scatter(pm, srv.decode.metrics)}; "
        f"first tokens equal to the monolithic "
        f"engine's: {firsts}; agreement with it (recorded): {same}/"
        f"{len(reqs)} requests, {pos_agree}/{n_tok} positions; launches "
        f"{launches}")
    _drained("disagg (a)", srv.prefill, srv.decode)
    if not (firsts and len(seen["pages"]) == len(reqs)
            and all(r.finished and len(r.token_ids) == new_tokens
                    for r in reqs)
            and launches["paged_decode_attention"] > 0
            and launches["window_attention"] > 0):
        raise AssertionError("disagg (a) failed")
    srv = None
    torch.cuda.empty_cache()

    small = _small_f32(torch, dev, model)
    greedy = [t["prompt"] for t in engine_traffic(model.args.vocab_size)]
    for label, kw in (("greedy", {}), ("int8 pool", {"kv_dtype": "int8"}),
                      ("chunked 256", {"prefill_chunk": 256})):
        kw = dict(max_slots=8, max_len=2048, page_size=16, min_bucket=16,
                  device=dev, **kw)
        mono = _serve_tokens(PagedEngine(small, **kw), greedy, 32)
        dis = _serve_tokens(DisaggServer(small, **kw), greedy, 32)
        equal = sum(a == b for a, b in zip(dis, mono))
        log(f"[disagg] (b) f32, 2 layers, {label}: {equal}/{len(mono)} "
            f"requests token for token equal to the monolithic engine")
        if equal != len(mono):
            raise AssertionError(f"disagg (b) {label}: {equal}/{len(mono)}")
    small = None
    torch.cuda.empty_cache()
    disagg_bench_leg(torch, dev, model)
    return launches


def disagg_bench_leg(torch, dev, model, chunk=256, steady_len=128,
                     steady_new=256, burst_len=1536, burst_new=16, win=20,
                     seed=0):
    """bench.py `_bench_serving_disagg`'s leg 1 at its TPU settings on
    `model`; holds the steady stream's rate ratio, records the rest."""
    import numpy as np
    from paddle_tpu_torch.serving import (DecodeWorker, LocalTransport,
                                          PagedEngine, PrefillWorker, Request)

    rng = np.random.default_rng(seed)

    def prompt(n):
        return rng.integers(1, model.args.vocab_size, n).astype(np.int32)

    steady_prompt = prompt(steady_len)
    burst = [prompt(burst_len) for _ in range(4)]
    lt = LocalTransport()
    pw = PrefillWorker(model, transport=lt, prefill_chunk=chunk, device=dev,
                       **DISAGG_LEG)
    done = {}
    dw = DecodeWorker(model, transport=lt, device=dev,
                      completion_cb=lambda r: done.setdefault(
                          r.request_id, len(r.token_ids)), **DISAGG_LEG)
    seen = _watch_admissions(torch, dw, check=False)

    def pw_drain():
        while pw.queue or pw.slots.active_slots or pw._chunk_streams:
            pw.step()

    pw.submit(Request(prompt(burst_len), 4, request_id="warm"))
    pw_drain()
    while "warm" not in done:
        dw.step()
    pw.submit(Request(steady_prompt, steady_new, request_id="steady"))
    pw_drain()
    while not dw.slots.active_slots:
        dw.step()
    for _ in range(6):
        dw.step()
    steady = next(dw.slots.owner(s) for s in dw.slots.active_slots
                  if dw.slots.owner(s).request_id == "steady")

    def window(burst_active=False):
        n0, times = len(steady.token_ids), []
        for _ in range(win):
            if burst_active and (pw.queue or pw.slots.active_slots
                                 or pw._chunk_streams):
                pw.step()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            dw.step()
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        return (len(steady.token_ids) - n0) / win, times

    base_rate, base_t = window()
    for i, p in enumerate(burst):
        pw.submit(Request(p, burst_new, request_id=f"burst{i}"))
    burst_rate, burst_t = window(burst_active=True)
    pw_drain()
    t0, n0 = time.perf_counter(), sum(done.values())
    while len(done) < 6:
        dw.step()
    torch.cuda.synchronize(dev)
    decode_tps = (sum(done.values()) - n0) / (time.perf_counter() - t0)
    ratio = burst_rate / base_rate
    reg = dw.metrics.registry
    pk = pw.metrics.observation("handoff_pack_s")
    sc = dw.metrics.observation("page_scatter_s")
    stats = {
        "handoffs": dw.metrics.counter("handoffs_admitted"),
        "handoff_mb": pw.metrics.counter("handoff_bytes") / 1e6,
        "handoff_pages": seen["pages"],
        "handoff_latency_ms": [x * 1e3 for x in seen["latency_s"]],
        "registry_latency_ms_p50": reg.quantile("handoff_latency_s", 0.5)
        * 1e3,
        "registry_latency_ms_p99": reg.quantile("handoff_latency_s", 0.99)
        * 1e3,
        "pack_ms_mean": pk["mean"] * 1e3, "pack_ms_max": pk["max"] * 1e3,
        "scatter_ms_mean": sc["mean"] * 1e3,
        "scatter_ms_max": sc["max"] * 1e3,
        "decode_step_ms_base_min": min(base_t) * 1e3,
        "decode_step_ms_burst_min": min(burst_t) * 1e3,
        "decode_step_ms_base_median": statistics.median(base_t) * 1e3,
        "decode_step_ms_burst_median": statistics.median(burst_t) * 1e3,
        "steady_tokens_per_step_base": base_rate,
        "steady_tokens_per_step_burst": burst_rate,
        "decode_tokens_per_s": decode_tps}
    _drained("disagg (c)", pw, dw)
    pw = dw = lt = None
    torch.cuda.empty_cache()
    mono = PagedEngine(model, prefill_chunk=chunk, device=dev, **DISAGG_LEG)
    s = mono.submit(Request(steady_prompt, steady_new, request_id="steady"))
    while not mono.slots.active_slots:
        mono.step()
    for _ in range(6):
        mono.step()
    for i, p in enumerate(burst):
        mono.submit(Request(p, burst_new, request_id=f"burst{i}"))
    n0 = len(s.token_ids)
    for _ in range(win):
        mono.step()
    stats["monolithic_steady_tokens_per_step"] = (len(s.token_ids) - n0) / win
    mono = None
    torch.cuda.empty_cache()
    log(f"[disagg] (c) bench leg: steady tokens/step {base_rate:.3f} base, "
        f"{burst_rate:.3f} under the burst: ratio {ratio:.3f} (bar 0.9-1.1); "
        f"DISAGG_LEG {json.dumps(stats)}")
    if not 0.9 <= ratio <= 1.1:
        raise AssertionError(f"disagg (c): steady rate ratio {ratio}")


def router_trace(vocab, gpt_vocab, bert_vocab, llama_new=32, gpt_new=32,
                 scale=16, seed=0):
    """bench.py `_bench_router_trace` (:1303-1321): three tenants, both SLO
    classes, its arrival steps and model mix; prompts `scale` times its
    lengths (Llama 192-272 tokens, GPT 144-192, BERT 160-208)."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    tenants = ("acme", "globex", "initech")

    def u(hi, n):
        return rng.integers(1, hi, n * scale).astype(np.int32)

    trace = [{"model": "llama", "arrival_step": i, "prompt": u(vocab, 12 + i),
              "max_new_tokens": llama_new, "tenant": tenants[i % 3],
              "slo": "interactive" if i % 2 == 0 else "batch"}
             for i in range(6)]
    trace += [{"model": "gpt", "arrival_step": 2 * i + 1,
               "prompt": u(gpt_vocab, 9 + i), "max_new_tokens": gpt_new,
               "tenant": tenants[i % 3], "slo": "interactive"}
              for i in range(4)]
    trace += [{"model": "bert", "arrival_step": 3 * i,
               "prompt": u(bert_vocab, 10 + i),
               "tenant": tenants[(i + 1) % 3], "slo": "batch"}
              for i in range(4)]
    return trace


def gpt_reference_logits(torch, model, ids):
    """Plain full-sequence GPT-2 forward with no cache, in f32 from the
    model's weights, sharing no code with the port (LayerNorm, exact GELU
    and causal attention written here): logits [T, vocab] f32."""
    a = model.args
    T, nh, hd = ids.shape[0], a.num_heads, a.head_dim

    def ln(x, w, b):
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + a.ln_eps) * w.float() + b.float()

    h = (model.word_emb[ids.long()] + model.pos_emb[:T]).float()
    for i in range(a.num_layers):
        lp = {k: v.float() for k, v in model.layer(i).items()}
        x = ln(h, lp["ln1_w"], lp["ln1_b"])
        q, k, v = ((x @ lp[w] + lp[b]).view(T, nh, hd)
                   for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        o = _attention(torch, q, k, v).reshape(T, -1)
        h = h + o @ lp["wo"] + lp["bo"]
        x = ln(h, lp["ln2_w"], lp["ln2_b"])
        f = x @ lp["fc1_w"] + lp["fc1_b"]
        f = 0.5 * f * (1.0 + torch.erf(f / math.sqrt(2.0)))
        h = h + f @ lp["fc2_w"] + lp["fc2_b"]
    h = ln(h, model.lnf_w, model.lnf_b)
    return h @ model.word_emb.float().t()


def gpt_cached_logits(torch, dev, model, req):
    """The request's prompt + generated tokens, teacher-forced through the
    port's cached forward (prefill, then one decode step a token at per-row
    positions): next-token logits [m, vocab] f32 of positions n-1 ..
    n+m-2."""
    import numpy as np
    from paddle_tpu_torch.models import gpt as gpt_m

    n, toks = req.prompt_ids.size, list(req.token_ids)
    ck, cv = gpt_m.gpt_cache(model, 1, n + len(toks))
    rows = [gpt_m._gpt_forward_cached(
        model, torch.from_numpy(req.prompt_ids[None]).to(dev), ck, cv, 0)[0]]
    for i, t in enumerate(toks[:-1]):
        rows.append(gpt_m._gpt_forward_cached(
            model, torch.tensor([[t]], device=dev), ck, cv,
            torch.tensor([n + i], dtype=torch.int32, device=dev))[0])
    return torch.cat(rows)


def _f32_copy(cls, model, cfg):
    """The same weights in f32 (a Gpt or Bert)."""
    tree = {k: v.float() for k, v in model.named_parameters()
            if not k.startswith("layers.")}
    tree["layers"] = {k: v.float() for k, v in model.layers.items()}
    return cls(cfg, tree, device=model.device)


def phase_router(torch, dev, model, gpt_cfg=None, bert_cfg=None, seed=0):
    """One `Router` over three backends on the card: the 7B `PagedEngine`
    (bf16, 2 slots, max_len 1024, pages of 16: an interactive arrival must
    preempt a batch slot), GPT-2 small (`GPTConfig()`, bf16, `GptEngine`,
    4 slots, max_len 1024) and BERT-base (`BertConfig()`, bf16,
    `BertBackend`, batch 8), on `router_trace`. Holds: every request
    finishes; router_preemptions >= 1 and equal to router_resumes; B4 and
    B5 launch (and nothing else) while GPT-2 serves alone; GPT-2 in f32
    (`GptEngine`) gives `gpt_generate`'s tokens for 4 prompts; GPT-2's bf16
    logits within rel 0.10, top-1 0.80 of a plain f32 forward
    (`gpt_reference_logits`); BERT-base's bf16 pooled output within rel
    0.05 of the f32 forward of its weights; in f32 at 7B width, 2 layers, a
    request the router preempted and resumed gives its uninterrupted
    tokens. Records tokens/s per model, TTFT p50 per model and SLO class,
    BERT's embed step at batch 8, the per-tenant counters. Returns the
    launch counts of the bf16 runs: GPT-2 alone and the router's."""
    import numpy as np
    from paddle_tpu_torch.models import (Bert, BertConfig, Gpt, GPTConfig,
                                         GPTGenArgs, gpt_generate)
    from paddle_tpu_torch.serving import (BertBackend, GptEngine,
                                          PagedEngine, Request, Router)

    gcfg, bcfg = gpt_cfg or GPTConfig(), bert_cfg or BertConfig()
    gargs = GPTGenArgs.from_config(gcfg)
    bf16 = torch.bfloat16
    gen_ = torch.Generator(device=dev).manual_seed(seed)
    gpt = Gpt(gargs, device=dev, dtype=bf16, generator=gen_)
    bert = Bert(bcfg, device=dev, dtype=bf16, generator=gen_)
    rng = np.random.default_rng(seed + 7)

    # GPT-2 alone: short prompts prefill through B5, decode through B4
    short = [rng.integers(1, gcfg.vocab_size, n).astype(np.int32)
             for n in (16, 40, 64, 24)]
    eng = GptEngine(gpt, max_slots=4, max_len=1024, device=dev)
    torch.cuda.synchronize(dev)
    reset_launches()
    greqs = eng.serve([Request(p, 32) for p in short])
    torch.cuda.synchronize(dev)
    alone = launch_counts()
    log(f"[router] GPT-2 alone (bf16, 4 prompts of {[p.size for p in short]}"
        f" tokens, 32 new): launches {alone}")
    others = {k: v for k, v in alone.items()
              if v and k not in ("decode_attention", "window_attention")}
    if not (alone["decode_attention"] > 0 and alone["window_attention"] > 0
            and not others):
        raise AssertionError(f"GPT-2 alone did not run B4 and B5 only: "
                             f"{alone}")
    ref = gpt_reference_logits(torch, gpt, forward_ids(torch, dev, greqs[2]))
    n = greqs[2].prompt_ids.size
    compare(torch, "router", f"GPT-2 bf16 cached logits vs the f32 forward, "
            f"after a {n}-token prompt",
            gpt_cached_logits(torch, dev, gpt, greqs[2]),
            ref[n - 1:n - 1 + len(greqs[2].token_ids)],
            LOGIT_BARS["bfloat16"])
    g32 = _f32_copy(Gpt, gpt, gargs)
    e32 = GptEngine(g32, max_slots=4, max_len=1024, device=dev)
    r32 = e32.serve([Request(p, 32) for p in short])
    equal = sum(list(r.token_ids) == gpt_generate(
        g32, p[None], max_new_tokens=32, device=dev)[0, p.size:].tolist()
        for p, r in zip(short, r32))
    log(f"[router] GPT-2 f32: GptEngine equal to gpt_generate for "
        f"{equal}/{len(short)} prompts")
    if equal != len(short):
        raise AssertionError(f"GPT-2 f32 GptEngine vs gpt_generate: {equal}")
    eng = e32 = g32 = None

    # BERT-base: bf16 pooled output against the f32 forward; embed step ms
    be = BertBackend(bert, max_batch=8, device=dev)
    lens = [int(x) for x in rng.integers(160, 209, 8)]
    prompts = [rng.integers(1, bcfg.vocab_size, k).astype(np.int32)
               for k in lens]
    step_ms = []
    for _ in range(6):
        reqs = [be.submit(p) for p in prompts]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        be.step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    got = torch.from_numpy(np.stack([r.embedding for r in reqs]))
    ids = torch.zeros(8, max(lens), dtype=torch.long)
    mask = torch.zeros_like(ids)
    for i, p in enumerate(prompts):
        ids[i, :p.size] = torch.from_numpy(p)
        mask[i, :p.size] = 1
    b32 = _f32_copy(Bert, bert, bcfg)
    ref = b32(ids.to(dev), mask.to(dev))[1].cpu()
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"[router] BERT-base bf16 pooled vs f32 forward: rel {rel:.3e} (bar "
        f"0.05); embed step at batch 8 (lengths {min(lens)}-{max(lens)}): "
        f"median {statistics.median(step_ms[1:]):.2f} ms of "
        f"{[round(x, 2) for x in step_ms[1:]]}")
    if not (math.isfinite(rel) and rel <= 0.05):
        raise AssertionError(f"BERT-base bf16 pooled rel {rel}")
    b32 = be = None

    # the router
    router = Router({
        "llama": PagedEngine(model, max_slots=2, max_len=1024, page_size=16,
                             device=dev),
        "gpt": GptEngine(gpt, max_slots=4, max_len=1024, device=dev),
        "bert": BertBackend(bert, max_batch=8, device=dev)})
    trace = router_trace(model.args.vocab_size, gcfg.vocab_size,
                         bcfg.vocab_size)
    torch.cuda.synchronize(dev)
    reset_launches()
    t0 = time.perf_counter()
    out = router.replay(trace)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = launch_counts()
    snap = router.metrics.registry.snapshot()["counters"]

    def by(name, key):
        tot = {}
        for labels, v in snap.get(name, {}).items():
            part = dict(kv.split("=") for kv in labels.split(","))
            tot[part[key]] = tot.get(part[key], 0) + v
        return tot

    pre = sum(snap.get("router_preemptions", {}).values())
    res = sum(snap.get("router_resumes", {}).values())
    tokens = by("router_tokens", "model")
    ttft = {}
    for t, r in zip(trace, out):
        ttft.setdefault(f"{t['model']}/{t['slo']}", []).append(r.ttft_s)
    embeds = by("router_completed", "model").get("bert", 0)
    stats = {"seconds": secs, "router_steps": router.step_count,
             "tokens_per_s": {m: v / secs for m, v in tokens.items()
                              if m != "bert"},
             "bert_embeddings_per_s": embeds / secs,
             "ttft_ms_p50": {k: statistics.median(v) * 1e3
                             for k, v in ttft.items()},
             "preemptions": pre, "resumes": res,
             "completed_by_tenant": by("router_completed", "tenant"),
             "tokens_by_tenant": by("router_tokens", "tenant"),
             "embed_step_ms_batch8": statistics.median(step_ms[1:])}
    log(f"[router] {len(trace)} requests in {secs:.2f} s, "
        f"{router.step_count} router steps; ROUTER {json.dumps(stats)}; "
        f"launches {launches}")
    if not (all(r.finished for r in out) and pre >= 1 and pre == res):
        raise AssertionError(f"router: finished "
                             f"{sum(r.finished for r in out)}/{len(out)}, "
                             f"preemptions {pre}, resumes {res}")
    router = gpt = bert = None
    torch.cuda.empty_cache()
    _add(launches, alone)

    # f32, 7B width, 2 layers: preempted and resumed = uninterrupted
    small = _small_f32(torch, dev, model)
    p_batch, p_inter = (rng.integers(1, model.args.vocab_size, k)
                        .astype(np.int32) for k in (192, 208))
    kw = dict(max_slots=1, max_len=1024, page_size=16, device=dev)
    ref = PagedEngine(small, **kw).serve([Request(p_batch, 32)])[0]
    eng = PagedEngine(small, **kw)
    router = Router({"llama": eng})
    victim = router.submit("llama", p_batch, slo="batch", tenant="nightly",
                           max_new_tokens=32)
    for _ in range(6):
        router.step()
    router.submit("llama", p_inter, tenant="acme", max_new_tokens=8)
    router.run_until_idle()
    reg = router.metrics.registry
    labels = {"model": "llama", "tenant": "nightly"}
    ok = (list(victim.token_ids) == list(ref.token_ids)
          and reg.counter("router_preemptions", labels=labels) == 1
          and reg.counter("router_resumes", labels=labels) == 1)
    log(f"[router] f32 at 7B width, 2 layers: the preempted and resumed "
        f"request gives its uninterrupted tokens: {ok}")
    _drained("router f32", eng)
    if not ok:
        raise AssertionError("router f32 preempt/resume parity failed")
    return launches


# ---------------------------------------------------------------------------
# c2: a row's bf16 result independent of its batch (B4-B8); c3: B10 on two
# streams
# ---------------------------------------------------------------------------

# (label, nh, nkv, hd, cache length, the probed row's pos, the other rows'
# pos): Llama-2-7B's decode and GPT-2's in the router (12 kv heads). The
# other rows are shorter and longer than the probed one; at 7B width all
# under 1024 keys, where the bound on pos used to cut every row's keys
# over 1 split and the row alone over 2
C2_SHAPES = (("7B decode", 32, 32, 128, 2048, 600,
              (50, 200, 800, 950, 1000, 10, 400)),
             ("GPT-2 decode", 12, 12, 64, 1024, 700,
              (30, 150, 1000, 400, 90, 1023, 5)))
# where the probed row sits in the batches of 8 and of 3 rows
C2_AT = {8: 3, 3: 1}
C2_PS = 16
C2_WINDOW = 16        # B5's window: a paged-prefill suffix
# B8's GEMV: the probed x row among M rows, at row C2_GEMV_AT[M]
C2_GEMV_AT = {1: 0, 8: 3, 9: 8, 16: 15}


def _c2_rows(torch, dev, nh, nkv, hd, length, n, seed, dtype):
    """n rows' q [n, 1, nh, hd], window q [n, C2_WINDOW, nh, hd] and caches
    [n, nkv, length, hd] in `dtype` (bf16 or fp16), and int8 pages (codes,
    scales): each row its own seed, so a row holds the same values in any
    batch."""
    rows = []
    for i in range(n):
        g = torch.Generator(device=dev).manual_seed(seed + 1000 * i)
        k = torch.randn(nkv, length, hd, generator=g, device=dev).to(dtype)
        v = torch.randn(nkv, length, hd, generator=g, device=dev).to(dtype)
        q = torch.randn(1, nh, hd, generator=g, device=dev).to(dtype)
        qw = torch.randn(C2_WINDOW, nh, hd, generator=g,
                         device=dev).to(dtype)
        pages = length // C2_PS
        codes = [torch.randint(-127, 128, (pages, nkv, C2_PS, hd),
                               generator=g, device=dev, dtype=torch.int8)
                 for _ in range(2)]
        scales = [torch.rand(pages, nkv, generator=g, device=dev) * 2 + 0.5
                  for _ in range(2)]
        rows.append((q, qw, k, v, codes, scales))
    return rows


def _c2_batch(torch, dev, rows, pos, nkv, hd, length):
    """The rows as one batch: q, window q, contiguous caches, bf16 and int8
    pools (page 0 the null page, a row's pages in order) with their block
    tables, and pos."""
    b = len(rows)
    pages = length // C2_PS
    q = torch.stack([r[0] for r in rows])
    qw = torch.stack([r[1] for r in rows])
    ck = torch.stack([r[2] for r in rows])
    cv = torch.stack([r[3] for r in rows])

    def pool(c):   # [b, nkv, len, hd] -> [1 + b * pages, nkv, ps, hd]
        body = c.reshape(b, nkv, pages, C2_PS, hd).transpose(1, 2).reshape(
            b * pages, nkv, C2_PS, hd)
        return torch.cat([torch.zeros_like(body[:1]), body]).contiguous()

    def stacked(i):   # the int8 codes / scales of half i, page 0 null
        codes = torch.cat([torch.zeros_like(rows[0][4][i][:1])]
                          + [r[4][i] for r in rows]).contiguous()
        scales = torch.cat([torch.ones_like(rows[0][5][i][:1])]
                           + [r[5][i] for r in rows]).contiguous()
        return codes, scales

    bt = (torch.arange(b * pages, dtype=torch.int32, device=dev)
          .reshape(b, pages) + 1).contiguous()
    (kq, ks), (vq, vs) = stacked(0), stacked(1)
    return dict(q=q, qw=qw, ck=ck, cv=cv, pk=pool(ck), pv=pool(cv), kq=kq,
                vq=vq, ks=ks, vs=vs, bt=bt,
                pos=torch.tensor(pos, dtype=torch.int32))


def _c2_outputs(torch, at, d, bound, max_pos):
    """Each of B4-B7's output for batch `d` (bf16 or fp16). bound: the
    host knows
    every row's pos (a CPU tensor, and max_pos for B6/B7) or only that
    they are on the card (max_pos None)."""
    pos = d["pos"] if bound else d["pos"].to(d["q"].device)
    return {
        "B4": at.decode_attention(d["q"], d["ck"], d["cv"], pos),
        "B5": at.window_attention(d["qw"], d["ck"], d["cv"], pos),
        "B6": at.paged_decode_attention(d["q"], d["pk"], d["pv"], d["bt"],
                                        pos, max_pos=max_pos),
        "B7": at.paged_decode_attention(d["q"], d["kq"], d["vq"], d["bt"],
                                        pos, k_scale=d["ks"], v_scale=d["vs"],
                                        max_pos=max_pos)}


def phase_c2(torch, dev, check=True):
    """Fault C2: one row through each bf16 and fp16 kernel in three
    batches, alone (b = 1, its own pos as the bound), among 7 rows shorter
    and longer (the batch's largest pos as max_pos, pos known to the host)
    and among 3 rows with max_pos=None (pos on the card): B4, B5, B6 and B7
    must give the row bit-identical outputs in either dtype. B8's GEMV:
    one x row at M = 1, 8, 9 and 16 at the four decode shapes,
    bit-identical. With check=False (a
    record of a tree before the repair) it only prints which differ. The
    disagg phase prints the agreement of whole requests."""
    from paddle_tpu_torch.kernels import attention as at
    from paddle_tpu_torch.kernels import quantized_matmul as qm

    differ = []
    for (label, nh, nkv, hd, length, pos0, others), dtype in [
            (shape, dt) for dt in (torch.bfloat16, torch.float16)
            for shape in C2_SHAPES]:
        dname = "bf16" if dtype == torch.bfloat16 else "fp16"
        rows = _c2_rows(torch, dev, nh, nkv, hd, length, 1 + len(others),
                        seed=11, dtype=dtype)
        target, rest = rows[0], rows[1:]
        alone = _c2_outputs(torch, at, _c2_batch(
            torch, dev, [target], [pos0], nkv, hd, length), True, pos0)
        results = {k: [] for k in alone}
        for b, bound in ((8, True), (3, False)):
            at_i = C2_AT[b]
            brows = rest[:at_i] + [target] + rest[at_i:b - 1]
            bpos = list(others[:at_i]) + [pos0] + list(others[at_i:b - 1])
            outs = _c2_outputs(torch, at, _c2_batch(
                torch, dev, brows, bpos, nkv, hd, length), bound,
                max(bpos) if bound else None)
            for k, out in outs.items():
                results[k].append(torch.equal(out[at_i], alone[k][0]))
        torch.cuda.synchronize()
        for k, same in results.items():
            log(f"[c2] {k} {dname} {label} (nh={nh} nkv={nkv} hd={hd} "
                f"len={length}), a row at pos {pos0}: among 7 rows with "
                f"max_pos {'the same bits' if same[0] else 'DIFFERENT'}, "
                f"among 3 rows with pos on the card "
                f"{'the same bits' if same[1] else 'DIFFERENT'} as alone")
            if not all(same):
                differ.append(f"{k} {dname} {label}")
        del rows, target, rest, alone
    for k, n, _ in DECODE_MATMULS:
        x0, w, s = matmul_case(torch, dev, torch.bfloat16, 1, k, n, seed=21)
        ref = qm.weight_only_matmul(x0, w, s)
        same = {}
        for m, row in C2_GEMV_AT.items():
            g = torch.Generator(device=dev).manual_seed(m)
            x = torch.randn(m, k, generator=g, device=dev).bfloat16()
            x[row] = x0[0]
            same[m] = torch.equal(qm.weight_only_matmul(x, w, s)[row],
                                  ref[0])
        log(f"[c2] B8 GEMV bf16 K={k} N={n}, one x row at M = 1, 8, 9, 16: "
            + ", ".join(f"M={m} {'the same bits' if v else 'DIFFERENT'}"
                        for m, v in same.items()))
        if not all(same.values()):
            differ.append(f"B8 GEMV K={k} N={n}")
    log(f"[c2] rows whose bf16 or fp16 output depends on their batch: "
        f"{differ or 'none'}")
    if check and differ:
        raise AssertionError(f"fault C2: a row's output depends on its "
                             f"batch in {differ}")
    return differ


# B10's rows on the two streams: the 7B micro-batch (132 blocks, one an
# SM: two calls barely overlap) and 64 rows (32 blocks in 8 clusters: two
# calls fit on the card at once)
C3_ROWS = (4096, 64)


def phase_c3(torch, dev, check=True, calls=64):
    """Fault C3: B10 on two streams of one card at once, different inputs
    (two seeds, [rows, 4096] bf16 for each of C3_ROWS), `calls` calls
    each, interleaved: every call must give the bits it gives alone on the
    default stream. With check=False it only prints."""
    from paddle_tpu_torch.kernels import rms_norm as rn

    bad = {}
    for rows in C3_ROWS:
        ins = []
        for seed in (6, 60):
            x, w, g = rms_case(torch, dev, rows, 4096, torch.bfloat16,
                               seed=seed)
            _, r = rn.rms_norm_fwd(x, w, RMS_EPS)
            ins.append((x, w, r, g))
        solo = [rn.rms_norm_bwd(*a) for a in ins]
        torch.cuda.synchronize(dev)
        streams = [torch.cuda.Stream(dev) for _ in ins]
        for st in streams:
            st.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(st):
                # hold both streams while the host enqueues every call, so
                # that the two streams' calls are queued when they start
                torch.cuda._sleep(20_000_000)
        outs = [[], []]
        for _ in range(calls):
            for i, (st, a) in enumerate(zip(streams, ins)):
                with torch.cuda.stream(st):
                    outs[i].append(rn.rms_norm_bwd(*a))
        torch.cuda.synchronize(dev)
        bad[rows] = [(i, j) for i in range(2)
                     for j, (dx, dw) in enumerate(outs[i])
                     if not (torch.equal(dx, solo[i][0])
                             and torch.equal(dw, solo[i][1]))]
        log(f"[c3] B10 [{rows}, 4096] bf16 on two streams, {calls} calls "
            f"each, interleaved: {2 * calls - len(bad[rows])} of "
            f"{2 * calls} calls give their solo bits"
            + (f"; the rest differ: {bad[rows][:8]}" if bad[rows] else ""))
    if check and any(bad.values()):
        raise AssertionError(f"fault C3: B10 calls on two streams differ "
                             f"from their solo bits: {bad}")
    return bad


# ---------------------------------------------------------------------------
# tune: the block tuner on B8's tile
# ---------------------------------------------------------------------------

TUNE_SHAPES = ((2048, 4096, 11008), (8192, 4096, 11008))


def phase_tune(torch, dev):
    """The block tuner on B8's tile, on an empty cache in a temporary
    directory: with PADDLE_KERNEL_AUTOTUNE=1 a call at M = 2048 and 8192,
    K = 4096, N = 11008 measures the three TILES candidates
    (`kernels/timing.py`); a second call is a cache hit, and another after
    the in-process mirror is dropped reads the disk; PADDLE_TUNE_BLOCKS
    overrides both; the output under each pick within B8's bar of its
    plain version. The registry's lookup counter says where each pick came
    from."""
    import os
    import shutil
    import tempfile

    from paddle_tpu_torch.kernels import quantized_matmul as qm
    from paddle_tpu_torch.kernels import tuning
    from paddle_tpu_torch.observability import (MetricsRegistry,
                                                set_global_registry)

    env = ("PADDLE_TUNING_CACHE", "PADDLE_KERNEL_AUTOTUNE",
           "PADDLE_TUNE_BLOCKS")
    saved = {k: os.environ.get(k) for k in env}
    tmp = tempfile.mkdtemp(prefix="tune_")
    reg = MetricsRegistry()
    prev = set_global_registry(reg)
    try:
        os.environ["PADDLE_TUNING_CACHE"] = os.path.join(tmp, "tuning.json")
        os.environ["PADDLE_KERNEL_AUTOTUNE"] = "1"
        os.environ.pop("PADDLE_TUNE_BLOCKS", None)
        tuning.clear_memory_cache()

        def picked():
            g = reg.snapshot()["gauges"]["kernel_block"]
            return (g["kernel=b8_tile,param=tile_m"]["value"],
                    g["kernel=b8_tile,param=tile_n"]["value"])

        def source():
            c = reg.snapshot()["counters"].get("kernel_tuning_lookups", {})
            return {k.split("source=")[1]: v for k, v in c.items()
                    if "kernel=b8_tile" in k}

        for m, k, n in TUNE_SHAPES:
            x, w, s = matmul_case(torch, dev, torch.bfloat16, m, k, n)
            plain = qm.dequant_matmul_plain(x, w, s)
            tol = TOL["bfloat16"] * max(1.0, plain.float().abs().max().item())
            rule = qm.tile(m, n, qm._sms(dev))
            steps = []
            for what in ("measured", "cache", "disk", "env"):
                before = dict(source())
                if what == "disk":
                    tuning.clear_memory_cache()
                if what == "env":
                    os.environ["PADDLE_TUNE_BLOCKS"] = json.dumps(
                        {"b8_tile": {"tile_m": 128, "tile_n": 128}})
                out = qm.weight_only_matmul(x, w, s)
                torch.cuda.synchronize(dev)
                err = (out.float() - plain.float()).abs().max().item()
                after = source()
                got = [src for src in after if after[src] != before.get(src)]
                steps.append((what, picked(), got, err))
                if not (math.isfinite(err) and err <= tol):
                    raise AssertionError(f"tune: B8 at M={m} under tile "
                                         f"{picked()}: {err} > {tol}")
            os.environ.pop("PADDLE_TUNE_BLOCKS", None)
            times = {lbl.split("candidate=")[1].split(",kernel=")[0]:
                     v["value"] * 1e3
                     for lbl, v in reg.snapshot()["gauges"][
                         "kernel_tuning_seconds"].items()
                     if f"m={tuning.bucket(m)}," in lbl}
            log(f"[tune] B8 M={m} K={k} N={n}: the rule's tile {rule}; "
                f"measured (ms) {times}; "
                + "; ".join(f"{what}: tile {t} from {g}, max_abs_err "
                            f"{e:.3e} (bar {tol:.3e})"
                            for what, t, g, e in steps))
            want = ["measured", "cache", "cache", "env"]
            if [g for _, _, g, _ in steps] != [[w_] for w_ in want] or \
                    steps[3][1] != (128, 128) or len(times) != len(qm.TILES):
                raise AssertionError(f"tune: lookups {steps}, times {times}")
            del x, w, s, plain, out
    finally:
        set_global_registry(prev)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tuning.clear_memory_cache()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# ckpt: save, kill, resume at 7B width
# ---------------------------------------------------------------------------

# Llama-2-7B's width, 2 layers, f32 params and moments: ~667 M parameters,
# ~8.0 GB of state; 5 steps of b 2, s 1024, saved every 2 steps
CKPT_LEG = dict(layers=2, batch=2, seq=1024, steps=5, save_every=2,
                keep_last_k=2)
CKPT_CHILD = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke
chip_smoke.CKPT_LEG.update({leg!r})
chip_smoke.ckpt_child({ckpt!r}, {device!r}, {args!r})
"""


def ckpt_args():
    from paddle_tpu_torch.models import LLAMA2_7B

    return LLAMA2_7B._replace(num_layers=CKPT_LEG["layers"])


def _ckpt_batch(step, vocab):
    import numpy as np

    rng = np.random.default_rng(100 + step)   # a per-step-seeded pipeline
    shape = (CKPT_LEG["batch"], CKPT_LEG["seq"])
    return (rng.integers(0, vocab, shape).astype(np.int32),
            rng.integers(0, vocab, shape).astype(np.int32))


def ckpt_run(torch, dev, args, root=None, resume=False):
    """The ckpt leg's engine over LlamaArgs `args` from seed 0 (resumed
    when asked), trained to step CKPT_LEG["steps"]; returns ({step: loss},
    engine)."""
    from paddle_tpu_torch.distributed import HybridParallelEngine

    kw = {}
    if root is not None:
        kw = dict(save_every=CKPT_LEG["save_every"], checkpoint=root,
                  resume=resume, keep_last_k=CKPT_LEG["keep_last_k"])
    eng = HybridParallelEngine(args, dtype=torch.float32, remat=False,
                               lr=1e-4, loss_chunk=128, moments="f32",
                               device=dev, **kw)
    params, opt = eng.init_state(0)
    params, opt, start = eng.maybe_resume(params, opt)
    losses = {}
    for step in range(start, CKPT_LEG["steps"]):
        loss, params, opt = eng.train_batch(
            params, opt, *_ckpt_batch(step, eng.args.vocab_size))
        losses[step] = loss.item()
    if eng.checkpoint_manager is not None:
        eng.checkpoint_manager.wait()
    return losses, eng


def ckpt_child(root, device, args):
    """The ckpt phase's child: the leg (LlamaArgs fields `args`) with
    PADDLE_CHAOS crashing (os._exit) inside step 4's save, after its shards
    are written (the second save's `after_shards` point)."""
    import torch

    from paddle_tpu_torch.models import LlamaArgs

    os.environ["PADDLE_CHAOS"] = "crash_at:after_shards#2"
    losses, _ = ckpt_run(torch, torch.device(device), LlamaArgs(**args),
                         root)
    print(f"UNREACHABLE {losses}", flush=True)


def phase_ckpt(torch, dev):
    """Checkpoints at Llama-2-7B width (2 layers, f32 params and moments,
    B1-B3, B9, B10): (1) 5 steps uninterrupted, saving every 2 steps
    (keep 2), in a temporary directory; (2) a child process runs the same
    leg and is killed (os._exit, PADDLE_CHAOS) inside step 4's save: the
    survivor must see committed_steps() == [2]; (3) resume=True from that
    directory: steps 2-4 must give run (1)'s losses bit for bit. Prints
    the snapshot ms, the write MB/s and the GB on disk; the directory is
    deleted."""
    import shutil
    import tempfile

    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.observability import (MetricsRegistry, hardware,
                                                set_global_registry)

    args = ckpt_args()
    base = tempfile.mkdtemp(prefix="ckpt_")
    reg = MetricsRegistry()
    prev = set_global_registry(reg)
    try:
        torch.cuda.empty_cache()
        root = os.path.join(base, "uninterrupted")
        t0 = time.perf_counter()
        ref, eng = ckpt_run(torch, dev, args, root)
        params = hardware.llama_param_count(eng.args)
        snap = reg.observation("checkpoint/snapshot_seconds")
        save = reg.observation("checkpoint/save_seconds")
        write = reg.observation("checkpoint/write_seconds")
        written = reg.counter("checkpoint/bytes_written")
        on_disk = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(root) for f in fs)
        log(f"[ckpt] hidden {args.hidden_size}, {args.num_layers} layers, "
            f"vocab {args.vocab_size}, f32 params and "
            f"moments, b{CKPT_LEG['batch']} s{CKPT_LEG['seq']}: "
            f"{CKPT_LEG['steps']} steps uninterrupted in "
            f"{time.perf_counter() - t0:.1f} s, losses {ref}; "
            f"committed {eng.checkpoint_manager.committed_steps()}; "
            f"snapshot (device to host) {snap['mean'] * 1e3:.1f} ms a save "
            f"(min {snap['min'] * 1e3:.1f}, {snap['count']} saves), save to "
            f"commit {save['mean']:.2f} s, of which the write and commit "
            f"{write['mean']:.2f} s: "
            f"{written / write['count'] / write['mean'] / 1e6:.0f} MB/s "
            f"({written / write['count'] / 1e9:.2f} GB a save); "
            f"{on_disk / 1e9:.2f} GB on disk for "
            f"{len(eng.checkpoint_manager.committed_steps())} snapshots")
        del eng
        shutil.rmtree(root)
        torch.cuda.empty_cache()
        root = os.path.join(base, "killed")
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c",
             CKPT_CHILD.format(root=str(ROOT), ckpt=root, device=str(dev),
                               args=args._asdict(), leg=CKPT_LEG)],
            capture_output=True, text=True, timeout=600)
        from paddle_tpu_torch.distributed.checkpoint.chaos import (
            CRASH_EXIT_CODE)

        survivor = CheckpointManager(root=root, registry=MetricsRegistry())
        steps = survivor.committed_steps()
        leftovers = sorted(n for n in os.listdir(root) if ".tmp." in n)
        log(f"[ckpt] the child killed inside step 4's save: exit "
            f"{child.returncode} (the injector's {CRASH_EXIT_CODE}) after "
            f"{time.perf_counter() - t0:.1f} s; the survivor sees committed "
            f"{steps}, staging leftovers {leftovers}")
        if child.returncode != CRASH_EXIT_CODE or steps != [2] or \
                "UNREACHABLE" in child.stdout:
            raise AssertionError(f"ckpt child: rc {child.returncode}, "
                                 f"committed {steps}\n{child.stdout[-2000:]}"
                                 f"\n{child.stderr[-4000:]}")
        t0 = time.perf_counter()
        resumed, eng = ckpt_run(torch, dev, args, root, resume=True)
        rest = reg.observation("checkpoint/restore_seconds")
        same = {s: resumed[s] == ref[s] for s in resumed}
        log(f"[ckpt] resumed from step {min(resumed)} in "
            f"{rest['mean']:.2f} s (restore), steps {sorted(resumed)} in "
            f"{time.perf_counter() - t0:.1f} s: losses {resumed}, "
            f"bit-identical to the uninterrupted run's: {same}; committed "
            f"{eng.checkpoint_manager.committed_steps()}, staging "
            f"leftovers swept: "
            f"{not any('.tmp.' in n for n in os.listdir(root))}; "
            f"{params / 1e6:.1f} M parameters")
        if sorted(resumed) != [2, 3, 4] or not all(same.values()) or \
                eng.checkpoint_manager.committed_steps() != [2, 4]:
            raise AssertionError(f"ckpt resume: {resumed} vs {ref}")
        del eng
    finally:
        set_global_registry(prev)
        shutil.rmtree(base, ignore_errors=True)
        torch.cuda.empty_cache()


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="build,parity,c2,c3,tune,train-check,eager,"
                    "functional,namespaces,layers,dist,configs,unet,quant,"
                    "recompute,"
                    "incubate,jit,analysis,device,debug,train,"
                    "train-h2048,ckpt,engine,disagg,router,logits,generate,"
                    "chunked,spec,engine-int8,logits-int8,capacity,"
                    "serve-fp16,timing",
                    help="comma-separated subset of the phases, in order")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if "disagg" in phases and "engine" not in phases:
        ap.error("the disagg phase compares with the engine phase's run")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "paddle_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: the paddle_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False   # the f32 reference
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[card] {name}, {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t_start = time.perf_counter()

    from paddle_tpu_torch.models import (LLAMA2_7B, Llama, init_params,
                                         quantize_params)

    main_err = {}
    launches = {k: 0 for k in all_counts()}
    if "build" in phases:
        phase_build()
    if "parity" in phases:
        main_err = phase_parity(torch, dev)
    if "c2" in phases:
        phase_c2(torch, dev)
    if "c3" in phases:
        phase_c3(torch, dev)
    if "tune" in phases:
        phase_tune(torch, dev)
        torch.cuda.empty_cache()
    if "train-check" in phases:
        phase_train_check(torch, dev)
        torch.cuda.empty_cache()
    if "eager" in phases:
        _add(launches, phase_eager(torch, dev))
        torch.cuda.empty_cache()
    if "functional" in phases:
        phase_functional(torch, dev)
        torch.cuda.empty_cache()
    if "namespaces" in phases:
        phase_namespaces(torch, dev)
        torch.cuda.empty_cache()
    if "layers" in phases:
        _add(launches, phase_layers(torch, dev))
        torch.cuda.empty_cache()
    if "dist" in phases:
        _add(launches, phase_dist(torch, dev))
        torch.cuda.empty_cache()
    if "configs" in phases:
        _add(launches, phase_configs(torch, dev, name))
        torch.cuda.empty_cache()
    if "unet" in phases:
        _add(launches, phase_unet(torch, dev, name))
        torch.cuda.empty_cache()
    if "quant" in phases:
        _add(launches, phase_quant(torch, dev, name))
        torch.cuda.empty_cache()
    if "recompute" in phases:
        _add(launches, phase_recompute(torch, dev))
        torch.cuda.empty_cache()
    if "incubate" in phases:
        _add(launches, phase_incubate(torch, dev))
        torch.cuda.empty_cache()
    if "jit" in phases:
        _add(launches, phase_jit(torch, dev))
        torch.cuda.empty_cache()
    if "analysis" in phases:
        _add(launches, phase_analysis(torch, dev, card))
        torch.cuda.empty_cache()
    if "device" in phases:
        _add(launches, phase_device(torch, dev, card))
        torch.cuda.empty_cache()
    if "debug" in phases:
        phase_debug(torch, dev)
        torch.cuda.empty_cache()
    if "train" in phases:
        _add(launches, phase_train(torch, dev, name, "train"))
    if "train-h2048" in phases:
        phase_train(torch, dev, name, "train-h2048")
    torch.cuda.empty_cache()
    if "ckpt" in phases:
        phase_ckpt(torch, dev)
    model = None
    if {"engine", "disagg", "router", "logits", "generate", "chunked",
            "spec", "engine-int8", "logits-int8", "capacity"} & set(phases):
        t0 = time.perf_counter()
        gen_ = torch.Generator(device=dev).manual_seed(0)
        model = Llama(LLAMA2_7B, init_params(LLAMA2_7B, gen_, device=dev,
                                             dtype=torch.bfloat16))
        log(f"[model] Llama-2-7B width, {LLAMA2_7B.num_layers} layers, bf16, "
            f"{sum(t.numel() for t in model.parameters()) / 1e9:.2f} B "
            f"parameters drawn in {time.perf_counter() - t0:.1f} s")
    reqs = eng_stats = eng_prof = None
    if "engine" in phases:
        reqs, eng_launches, eng_stats, eng = phase_engine(torch, dev, model)
        _add(launches, eng_launches)
        eng_prof = phase_profile(torch, dev, eng)
        eng = None
    if "disagg" in phases:
        _add(launches, phase_disagg(torch, dev, model, reqs))
        torch.cuda.empty_cache()
    if "router" in phases:
        _add(launches, phase_router(torch, dev, model))
        torch.cuda.empty_cache()
    if "logits-cuts" in phases:
        phase_logits_cuts(torch, dev, model, reqs[3])
    if "logits" in phases:
        phase_logits(torch, dev, model, reqs[3])
        torch.cuda.empty_cache()
    if "generate" in phases:
        _add(launches, phase_generate(torch, dev, model))
    if "chunked" in phases:
        _add(launches, phase_chunked(torch, dev, model))
        torch.cuda.empty_cache()
    if "spec" in phases:
        _add(launches, phase_spec(torch, dev, model))
        torch.cuda.empty_cache()
    qmodel = qreqs = None
    if {"engine-int8", "logits-int8"} & set(phases):
        t0 = time.perf_counter()
        qmodel = quantize_params(model)
        torch.cuda.synchronize(dev)
        def gib(m):
            return sum(t.numel() * t.element_size()
                       for t in m.parameters()) / 2**30

        log(f"[quantize] quantize_params on the card in "
            f"{time.perf_counter() - t0:.1f} s: {gib(qmodel):.2f} GiB int8 "
            f"model (bf16: {gib(model):.2f} GiB)")
    if "engine-int8" in phases:
        qreqs, q_launches, q_stats, eng = phase_engine(
            torch, dev, qmodel, kv_dtype="int8", label="engine-int8")
        _add(launches, q_launches)
        if eng_stats is not None:
            keys = ("prefix_tokens_hit", "prefix_partial_hits",
                    "radix_splits", "cow_copies")
            diff = {k: (eng_stats["counters"].get(k, 0),
                        q_stats["counters"].get(k, 0)) for k in keys
                    if eng_stats["counters"].get(k, 0)
                    != q_stats["counters"].get(k, 0)}
            share = q_stats["kv_pool_bytes"] / eng_stats["kv_pool_bytes"]
            log(f"[engine-int8] prefix counters equal to the bf16 run's: "
                f"{not diff}; pool bytes {share:.4f}x the bf16 pool's at "
                f"{q_stats['num_pages']} pages (bar 0.51)")
            if diff or share > 0.51 or \
                    q_stats["num_pages"] != eng_stats["num_pages"]:
                raise AssertionError(f"engine-int8 vs engine: counters "
                                     f"{diff}, pool share {share}")
        phase_profile(torch, dev, eng, label="profile-int8")
        eng = None
        _add(launches, phase_generate(torch, dev, qmodel,
                                      label="generate-int8"))
    if "logits-int8" in phases:
        # the bf16 check's token sequence, so the checks differ only in
        # the int8 weights and pool
        phase_logits_int8(torch, dev, qmodel, (reqs or qreqs)[3])
    qmodel = None
    torch.cuda.empty_cache()
    if "capacity" in phases:
        _add(launches, phase_capacity(torch, dev, model))
    if "serve-fp16" in phases:
        model = None      # the bf16 model's 13.5 GB, before the fp16 one's
        torch.cuda.empty_cache()
        _add(launches, phase_serve_fp16(
            torch, dev, None if eng_stats is None else (eng_stats, eng_prof)))
        torch.cuda.empty_cache()
    main_path = {"eager", "layers", "dist", "configs", "unet", "quant",
                 "recompute", "incubate", "jit", "analysis", "device",
                 "train", "engine", "disagg", "router", "generate", "chunked",
                 "spec", "engine-int8", "capacity", "serve-fp16"}
    if main_path <= set(phases):
        missing = [k for k, v in launches.items()
                   if v == 0 and k not in OFF_PATH]
        if missing:
            raise AssertionError(f"kernels never launched on the main path: "
                                 f"{missing}")
        stray = {k: launches[k] for k in OFF_PATH if launches[k]}
        if stray:
            raise AssertionError(f"off-path kernels launched on the main "
                                 f"path: {stray}")
    log(f"[main path] launches {launches}")
    model = None
    torch.cuda.empty_cache()
    rows = []
    if "timing" in phases:
        rows = phase_timing(torch, dev, name, main_err, launches)
    log(f"[done] {time.perf_counter() - t_start:.1f} s; peak device memory "
        f"{max(PEAK_SEEN + [torch.cuda.max_memory_allocated(dev)]) / 2**30:.1f}"
        " GiB")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
