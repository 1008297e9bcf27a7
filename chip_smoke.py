#!/usr/bin/env python3
"""Drive the PyTorch port (dynamo_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  - the card, its count, and `nvidia-smi` name and power limit;
  2. build   - build the CUDA kernels from ops/csrc (one nvcc per source,
               all started together), print each one's `ptxas -v` lines
               and fail if an MLA kernel spills;
  3. kernels - each attention kernel at the main path's shapes (Hk 8, G 3,
               D 128, PS 16, bf16) against its plain PyTorch version, with
               times from CUDA events around back-to-back calls (for
               every attention kernel and its yardstick also as CUDA-graph
               replays, `device_ms`, free of the host's launch cost), the
               library yardstick (SDPA over K/V
               gathered dense beforehand) and the roofline bound: decode,
               chunked prefill, and the ragged kernel over a 264-token
               mixed step (8 decode rows + 4 chunks), the same step with
               its last chunk dropped (tail rows must be exactly 0), a
               verify-shaped step (K+1 = 5 rows per segment) and, untimed,
               rows at the edges of its context splits (`split_edges`),
               each ragged case also row by row within ROW_REL_TOL;
               then (`shapes`) all three kernels at the other shapes they
               take, decode at every (D, G) pair it accepts, each also
               row by row within ROW_REL_TOL of the plain version in
               f32; then
               (`copy_kernels`) the three page-copy kernels at
               the 3B page shape (L 28, PS 16, Hk 8, D 128, bf16) in a
               2048-page pool, 94 pages in random order: token- and head-major
               gather, scatter, and a 4-group layer scatter, bit for bit
               against their plain versions, and, as graph replays beside
               `index_select` / `index_copy_` and the byte bound, the KV
               tiers' shapes: a 1-page gather (an offload), a 1-page
               scatter (a prefetch promotion) and a 64-page scatter in 4
               layer groups (an onboard); then
               (`tier_codec_kernels`) the device tier codec
               (ops/csrc/tier_codec.cu) at that onboard's 64 pages,
               quantize and dequantize bit for bit against the plain
               codec on the CPU, timed beside the plain codec on the card
               and the byte bound; then (`mla_kernels`) the two
               MLA kernels at DeepSeek-V3's shapes (H 128, d_c 512, d_rh
               64, PS 16, bf16): decode at B 8 (an empty row), prefill
               S 512 with q_len 450 over 700 prior tokens, a packed [4, 256]
               prefill with an all-padding row (exactly 0), other page
               sizes and head counts, S 203, a 5-token chunk over 3000
               prior tokens (timed), kv_len 3 past the chunk and q_start
               37, each with its padding rows exactly 0 and each prefill
               also held, within TILES_ULPS bf16 ulps, against
               prefill_mla_tiles_ref (the kernel's tiles and bf16 P in
               plain PyTorch); then
               (`decode_split_edges`)
               both decode kernels with rows at kv_len 0, 1, split - 1,
               split, split + 1, 2 split and 4096 (GQA at the main path's
               heads, MLA at H 16, 32 and 128), untimed;
               then (`gemma_kernels`) the three GQA kernels' Gemma-2
               bodies (window, soft cap, scale, D 256) at D 256 / G 2 and
               D 128 / G 3 against their plain versions in f32 (max abs
               error and, row by row, error over the row's RMS; faults
               planted in the plain computation, a window edge moved by
               one and a tile skipped, must break the row limit), timed
               beside the plain version and SDPA with a window mask or
               the bmm-tanh-softmax-bmm calls (a D 256 instantiation
               that spills fails the build);
               then (`int8_kernels`) the int8 bodies (int8 KV pools,
               models/quant.py) of the three GQA kernels at the
               `kernels` shapes and at the Gemma-2 case, and of MLA
               decode at its shape, each against its plain int8 version
               in f32, timed beside the bf16 yardstick over the K/V
               dequantized beforehand and (prefill, ragged) beside the
               bf16 body's replay; the prefill and ragged ones over pools
               whose per-(token, head) scales spread over three decades,
               also row by row, and at the 3B shape again (`gate_3b`,
               decode, prefill and ragged, untimed) over kv lengths at
               64-token tile edges up to 4097, where planted faults (a
               skipped tile, a window edge moved by one; a K or V
               scale read from the slot before, scales from the next
               head, O's columns left in the kernel's order, Q's dims in
               the kernel's order against K's) must break the row limit;
               int8 MLA decode (its own kernel, mla_decode_codes_kernel)
               also row by row, timed beside the bf16 body's replay at
               the 11,008-token batch and at an engine-shaped one
               (MLA_ENGINE_KV), and gated (untimed) at kv lengths on its
               64-token tile and MLA_INT8_SPLIT_TOKENS split edges at page
               sizes 4-128 (TMA page boxes and a copy a token) over
               scales spread over three decades, with planted faults (a
               scale from the slot before, a row's last tile left out,
               O's dims and Q's dims in the kernel's order) that must
               break the row limit; and kv_quantize on the card against
               the CPU's (codes equal, scales within an ulp);
               then (`head_shape_kernels`) the three GQA kernels at
               qwen2.5-7b's heads (Hk 4, G 7, D 128, `kernels`' decode
               contexts) and phi-3's (Hk 32, G 1, D 96, window 2047,
               contexts 1 to 4000 around the window's edge, chunks
               straddling it; and a 7-token window) and llama-3.2-1b's
               (Hk 8, G 4, D 64), bf16 and int8, checked as
               gemma_kernels' cases (int8 prefill and ragged with their
               planted faults too) and timed with the plain version and
               SDPA, each int8 row beside its bf16 row;
  4. engine  - build_engine for llama-3.2-3b at full width and depth with
               random weights and serve 8 concurrent requests (chunked
               prefill over prior context, a prefix-cache hit, greedy and
               seeded sampled rows) three times on one runner, each with
               every launch count set to 0 just before and read just
               after: `fused` (the default on a card: mixed plans on the
               ragged kernel; the main path), `unfused` (DYN_FUSED_MIXED=0:
               decode, then each chunk on the prefill kernel) and `spec`
               (--spec-ngram, K 4, prompts that repeat n-grams: verify rows
               on the ragged kernel; drafts from the host scan).
               Each kernel's launches must equal its forward passes
               (runner.stats) x 28 layers;
     spec    - speculative decoding on the 3B (before `engine`, the
               `verify_shape` case: the prefill kernel at B 8 rows of
               gamma + 1 = 5 tokens over the traffic's contexts, against
               its plain version, timed beside its bound and SDPA; a
               `variants` entry of prefill_paged_attention in the kernels
               line). `engine_draft_ring`: the spec workload with drafts
               from the device ring, each proposal held against the host
               scan of the ring's window after the run, streams identical
               to engine_spec's;
               `engine_tree`: --spec-ngram with 3 branches on the fused
               engine (branch rows verified on the ragged kernel, no page
               held after the run); `engine_draft`: a llama-3.2-1b draft
               (random, seed 1), gamma 4, two rounds a plan, unfused: the
               decode kernel's launches = target steps x 28 + draft steps
               x 16 (its D64 body), the prefill kernel's = (chunks + verify
               passes) x 28 + draft chunks x 16, no ragged launch, a
               sampled request equal served alone twice; acceptance,
               tokens a target pass and the decode rate reported;
               `engine_draft_self`: the 3B drafting for itself, acceptance
               >= SELF_DRAFT_ACCEPT;
     disagg  - (`engine_disagg`) a prefill and a decode engine on the card,
               one shared params dict, 1024 pages each, each served by
               serve_worker over the in-process request plane, behind a
               PrefillRouter whose prefill pool comes from discovery: the
               same 8 requests, half pulled on the device (a colocated
               prefill instance), half host-staged through the other
               instance's kv_fetch in chunks of 16 pages; no pull may fall
               back to recompute, the decode engine must run no prefill,
               imported pages must equal the prefill engine's byte for
               byte, and the copy kernels' launches must equal the
               transfer calls x 2 pools;
     tiers   - (`engine_tiers`) one engine with a 160-page pool, a 512-block
               host tier and 4 onboard layer groups: a 1100-token request,
               two 1500-token fillers that evict its pages to the host,
               then a request sharing its first 1024 tokens, onboarded
               from the host (bytes equal to what was offloaded, stream
               equal to a cold prefill's on a warm engine), with the
               offload's cost (batches of one alloc's evicted pages),
               the onboard's rate (the engine's clock, and the runner's
               alone ending in a synchronize) and the TTFT onboarded and
               cold; then the same traffic through
               `engine_tiers_g3` (a 16-block host tier spilling to a
               `--disk-kv-root`), `engine_tiers_g4` (`--obj-kv-root`),
               `engine_tiers_quant` (`--kv-tier-quantize` over bf16
               pools: the pages equal the codec's dequantization) and
               `engine_tiers_quant_int8` (over int8 pools: codes and
               scales passed through), each labelled by its deepest tier
               with no recompute; `engine_tiers_remote` (two workers
               over TCP, the KV router's `kv_remote_host` hint: B pulls
               A's host blocks through kv_host_fetch, no recompute, B's
               pages equal A's bytes) and `engine_tiers_prefetch` (the
               router's `kv_prefetch` hint promotes A2's 64 blocks on A
               before A2 arrives: 64 hits, no onboard). Every case holds
               the copy kernels' launches to its transfers (a gather a
               pool part an offload batch, a layer scatter a group a pool
               part an onboard, a whole-pool scatter a pool part a
               promotion) and its stream to the cold one (a quantized
               tier's, lossy, is reported);
  5. parity  - prefill-plus-decode inputs, then one ragged dispatch of
               decode rows and a chunk over prior context, through the
               kernel path and the plain attention path of the forward;
     extras  - the sampling extras on the 3B runner:
               `engine_sampling_ext` (a top-5 logprob request, each greedy
               token its report's top, the report <= 0 and sorted; one
               with repetition 2.0 and frequency penalties on a prompt
               whose unpenalised greedy stream repeats a token, differing
               from it; one with logit_bias -100 on its greedy first token
               and +100 on another: banned never, forced always; the
               launch identities with no ragged launch), `engine_guided`
               (a regex within the device table budget on the ragged
               kernel in fused plans beside a 1500-token prompt, with no
               host mask build; a JSON schema over the budget on the host
               fallback; each output in its DFA's language),
               `engine_branches` (n = 4 seeded: four finishes, one
               prefill pass, three forks, copy_pages called, four distinct
               streams, equal on a second run) and `extras_costs` (the
               decode step's ms at B 8 with no extra, penalties,
               logprobs, the device guided tables and the host fallback;
               the embed pass for 3 x 128 tokens);
     lora    - `engine_lora` (multi-LoRA on the 3B's params: slots 3,
               rank 16, all seven targets; ad-one rank 8 on the default
               targets and ad-mlp rank 16 on all seven, scale 0.25; the
               3B's 8 requests split over base, ad-one and ad-mlp): every
               launch on the decode and prefill kernels (passes x 28),
               none on the ragged kernel (mixed plans on the padded
               fallback); a turn with n-gram speculation (`lora_spec`)
               whose verify passes launch the ragged kernel (passes x 28)
               with a slot a token; base-slot rows of a prefill and a
               decode dispatch bit for bit the LoRA-less forward's; the
               kernel path with adapters within FORWARD_REL_TOL of the
               plain path in bf16 and its adapter rows within
               LORA_F32_REL_TOL of the plain path in f32; each adapter's
               greedy stream unlike the base's;
               no cached token reused across adapters; an adapter
               registered at run time into the free slot served; the
               decode rate and a decode step's device time beside the
               LoRA-less runner's on the same padded path
               (`engine_lora_base_padded`);
     served  - the request plane. `engine_served_disagg`: a prefill
               and a decode worker (the 3B params again, 1024 pages each)
               served by serve_worker over TCP on loopback in this process,
               neither registered colocated, behind the chain of a `kv`
               ModelWatcher's model entry (the frontend's: migration,
               backend, PrefillRouter, KvPushRouter, both pools from
               discovery): the 8 requests, every pull host-staged through
               kv_fetch in chunks of 16 pages; no recompute fallback, the
               copy kernels' launches equal to the chunks pulled and the
               imports x 2 pools, the attention kernels' launches equal to
               both runners' passes x 28, and the prefill worker's KV
               events (a TCP event-plane subscriber) carrying store events
               for every full page of every prompt; the pull's ms and GB/s
               beside engine_disagg's host-staged pull; then a prompt
               repeating the 1500-token prompt's first 1024 tokens must
               hop to the prefill instance with >= 63 blocks of overlap
               on the prefill pool's KvRouter. Then, with this
               process's runners freed, `engine_served`: `python -m
               dynamo_tpu_torch.worker` with engine_fused's flags as a
               process of its own on the card, file discovery on a
               temporary root; a client runtime here discovers it, sends
               8 other requests of the same lengths one at a time (the
               process's first run of each shape), then the 8 requests
               one at a time (each greedy stream equal to this process's
               engine serving it alone, `alone_phase`) and then all at
               once (each finishing with its 32 tokens), and reports TTFT
               and e2e over the wire beside the in-process engine's, run
               the same way, and engine_fused's; SIGTERM must end the
               worker with exit code 0. Then `engine_frontend`: two such
               worker processes behind the HTTP frontend (HttpService in
               `kv` mode in this process, the standard library's HTTP
               client): greedy streams through the chain equal to
               alone_phase's, the same 8 over HTTP unary and streamed
               (32 tokens each, the streamed text its tokens' bytes,
               `data: [DONE]`), TTFT and e2e over HTTP on cold prompts
               beside engine_served's, a repeated 1024-token prefix routed
               to the worker that holds it (>= 63 blocks) with its TTFT
               beside cold prompts', 8 distinct prompts spread over both
               workers, a 256-token stream whose worker is SIGKILLed after
               16 tokens migrating and finishing, a dropped client's pages
               freed (the survivor's FPM), a response_format json_schema
               chat, a completion with logprobs 3 and /v1/embeddings over
               three inputs (norms 1, equal alone twice, batched within
               2e-2 of alone), and `python -m
               dynamo_tpu_torch.frontend --router-mode kv` serving and
               exiting 0 on SIGTERM, as the worker after it. Then
               `lora_served`: two llama-3.2-1b worker processes, one with
               `--lora ad-one`, behind `python -m dynamo_tpu_torch.frontend
               --router-mode kv`: /v1/models lists ad-one, ad-one traffic
               runs forward passes only on its holder (each worker's FPM),
               and an rl load_adapter makes the other a holder that then
               receives ad-one traffic;
     int8    - with the 3B runner freed, the slice's main path:
               llama-3.1-8b at full width, 8 of its 32 layers, with
               --kv-quantize int8 (`engine_int8kv` fused and
               `engine_int8kv_unfused`: every request `length`, each GQA
               kernel's launches equal to its passes x 8, all on the
               D128_int8 bodies, the pools' bytes beside a bf16 pool's),
               and `parity_int8kv` (as `parity`, over int8 pools; the
               distance to bf16 pools reported);
  6. mla     - (`engine_mla`) DeepSeek-V3's three dense layers at full
               width (get_config("deepseek-v3").with_(n_layers=3,
               n_experts=0), random bf16 weights) serve the same 8 requests
               at the card's default (fused plans on the padded fallback:
               MLA has no ragged path); each MLA kernel's launches must
               equal its forward passes x 3 and no GQA kernel may launch.
               Then (`mla_pages`) one request's latent and stub pages go
               through export/import on the device and through the wire
               with a 3-group layer-streamed import, bit for bit,
               (`parity_mla`) prefill and two decode steps through both
               attention paths of the forward, and (`engine_mla_int8`)
               the same params over an int8 latent: every decode launch
               on the int8 body, no MLA prefill launch (int8 prefill
               gathers, as the reference's does).
  7. gemma  - with the 3B and MLA runners freed, gemma-2-9b at full width,
               10 of its 42 layers (head dim 256, a 4096-token window on
               the even layers): `engine_gemma2` (fused, the default) and
               `engine_gemma2_unfused` serve the same 8 requests and two
               prompts of 4600 and 5200 tokens, each request `length`,
               each kernel's launches equal to its passes x 10, half on
               the window bodies; `parity_gemma2` prefills a 4700- and a
               4500-token sequence in 512-token chunks through both
               attention paths, then two decode steps and a ragged step
               past the window; `engine_gemma2_int8`, the same params
               over int8 pools, half the launches on the
               D256_int8_window_softcap bodies.
  8. families - with the Gemma-2 runner freed, this slice's paths, each
               model at full width and 8 layers (llama-3.2-1b at its full
               16) with random weights, 2048
               pages x 16, the 3B's traffic, every request `length` and
               each kernel's launches equal to its passes x L, all on one
               body: `engine_qwen2` and `engine_qwen2_unfused`
               (qwen2.5-7b, G 7, q/k/v biases drawn non-zero; D128) and
               `parity_qwen2`; `engine_phi3`, `engine_phi3_unfused`
               (phi-3-mini-4k, D 96, a 2047-token window on all 32
               layers, prompts of 2600 and 3900 tokens; D96_window),
               `parity_phi3` (sequences of 2600 and 2300 tokens) and
               `engine_phi3_int8` (int8 pools; D96_int8_window); then one
               fused turn and a short parity each, freed in turn, for
               qwen3-8b (D128), mistral-7b (prompts of 4600 and 5200 past
               its 4096-token window on every layer; D128_window),
               gemma-7b (D256), olmo-2-7b and granite-3.1-8b (D128),
               and llama-3.2-1b over int8 pools (16 layers, the card's
               path through the D 64 bodies; D64_int8).
  9. moe     - (`moe_kernels`, after `head_shape_kernels`) the grouped
               GEMM's two entries (ops/csrc/moe_grouped_gemm.cu) at
               qwen3-30b-a3b's experts (E 2048, F 768, 128 of them, top
               8) at T 8, 264 and 512 and DeepSeek-V3's (E 7168, F 2048,
               256) at T 8 and 512, each routed uniformly and skewed (half
               the pairs on one expert, half the experts empty), against
               the plain version in f32: max abs error (x at RMS
               MOE_X_RMS) and row errors over the row's RMS and over its
               max (gate/up is gated on the max form, down on the RMS
               form, both at ROW_REL_TOL; a pair on the wrong expert, a
               dropped last tile and the last tile's middle 64-deep K
               slice left out of its sums, each planted in the plain
               computation, must break the gate), the entries' ptxas
               registers (a spill fails the build check) and route's
               tile size against the kernel's, timed beside the
               per-expert matmul loop, the dense every-expert form and
               torch._grouped_mm, with
               the bound over the touched experts' weights; one
               moe_block under torch.cuda.set_sync_debug_mode("error").
               Then, after every earlier runner is freed,
               `engine_qwen3moe` and `engine_qwen3moe_unfused`
               (qwen3-30b-a3b at full width, 8 of its 48 MoE layers, G 8:
               the 3B's traffic, every request `length`,
               launches = passes x 8 on D128, each grouped-GEMM entry's
               = passes x 8), `parity_qwen3moe_free` (information: each
               path routes on its own logits, and the top-k choices that
               differ are counted) and `parity_qwen3moe` (the plain path
               on the kernel path's routing, held to FORWARD_REL_TOL);
               then `engine_mla_moe` and the two `parity_mla_moe` turns
               (DeepSeek-V3's three dense layers and its first MoE layer,
               get_config("deepseek-v3").with_(n_layers=4), the selection
               bias drawn non-zero: the padded fallback, MLA launches =
               passes x 4, each grouped-GEMM entry's = passes x 1).
 10. quant   - weight-only int8 / e4m3 weights (models/quant.py,
               --quantize). `quant_kernels` (after `moe_kernels`): the
               weight-only GEMM (ops/csrc/quant_gemm.cu) in its KN
               layout at llama-3.1-8b's matrices and mixtral's head and
               its NK layout at llama-3.2-3b's tied table, int8 and e4m3,
               at M 1, 8, 64, 264 and 2048, x at RMS MOE_X_RMS, each
               against its plain version (KERNEL_TOL; ROW_REL_TOL row by
               row; at M 8 and 264 three faults planted in the plain
               version, the scales dropped, the code x's largest element
               meets with its sign flipped and the middle 64-deep K stage
               left out, each of which must break the row gate), timed
               beside the plain version and cuBLAS on the dequantized
               bf16 weight, with the bound over codes, scales, x and y;
               untimed edges (N 4128: half a 64-column tile past the
               end; K 4160: decode rows on the prefill tiles; M 1, 17,
               65 and 130 ending inside a tile) held the same way;
               then the grouped GEMM's quantized bodies at qwen3-30b-a3b's
               and mixtral's experts (T 8, 264, 512, uniform and skewed,
               int8; mixtral's T 264 uniform also e4m3) against their
               plain versions (an expert's scales dropped and a skipped
               stage planted), beside the bf16 body on the dequantized
               experts. After engine_int8kv (whose decode step, 8 rows at
               1024 tokens, is timed), `engine_quant`: llama-3.1-8b with
               int8 weights over int8 pools, the 3B's traffic, fused,
               quant_gemm launches = passes x (7 L + 1) on its KN int8
               body, the params' GB and the decode step beside
               engine_int8kv's; `parity_quant`; `engine_quant_fp8_3b`
               (llama-3.2-3b, e4m3 weights: the tied head on the NK body)
               and `parity_quant_fp8_3b`. Last, with every other runner
               freed, `engine_mixtral`: mixtral-8x7b at full width, 8 of
               its 32 MoE layers (8 experts, top 2), with int8 weights,
               the 3B's traffic, grouped-GEMM launches =
               passes x 8 on the int8 bodies, quant_gemm's = passes x
               (4 L + 1), its memory at 8 layers beside the full depth's
               computed bytes (`mixtral_memory`; the full-depth build
               and its fit check no longer run); then
               `parity_mixtral_free`, `parity_mixtral` (pinned to the
               kernel path's routing) and `repeat_mixtral` at two layers.
               Every engine phase holds quant_gemm's launches by body to
               its quantized matrices a pass (0 over bf16 weights).
 11. observability - the runtime hooks on the card (runtime/
               sanitizer.py, flight_recorder.py, annotations.py,
               tracing.py, fleet_observer.py, status.py). After
               `parity`, on the 3B runner: `observability_engine`
               (sync_mode_phase: which of SYNC_CASES the sync debug mode
               "error" catches, held to the table; guard_phase: the 3B's
               traffic under a warm sanitizer with no violation, and
               none beside a second engine's G2 offloads and onboard
               in the same process (guard_beside_tiers), a
               planted `.item()` inside the guarded decode failing its
               request and recorded, the same sync in an allow scope
               passing, an unknown label a violation, the penalty
               decode's guard reported, a kernel library rebuilt
               after warm-up a violation; anomaly_phase: a stall of
               twice the trigger's threshold fires exactly one anomaly,
               its dump lands and its ANOMALY_PROFILE_MS torch.profiler
               window holds the engine's ranges and the GQA kernels),
               then `observability_costs` (the decode rate a request of
               8 requests of 64 prompt and 32 output tokens with the
               recorder, the span ring, the ranges and the sanitizer off
               and on, in turns off, on (OBS_COST_TURNS); every turn holds the
               launch identities; the "on" turns time each hook's host
               work where it runs, under HOOK_SHARE_MAX of the
               iterations' time, and each hook alone over HOOK_CALLS
               calls) and `hw_profile` (run_hw_sweep at the
               3B's width: kernel and ref x bf16 and int8 KV, batches
               1/8/32, chunks 128/512; launches = the kernel variants'
               passes x 28, the artifact read back). In `tiers`,
               `tier_cost_feed` (the G2 engine's digest carries its
               kv_onboard_ewma; a KvRouter bound to a FleetObserver that
               ingested it prices G2 as measured). In `engine_frontend`,
               the workers run with --sanitize, --status-port,
               --digest-period 0.5 and --anomaly-dump-dir under
               DYN_TRACE_RING, the in-process frontend keeps a span ring
               and serves its status port (frontend/__main__.py
               start_fleet_status), and after the 3B's traffic
               `observability_served` holds: no sanitizer violation over
               guarded dispatches, one timeline record per iteration
               summing to the runner's counters, each streamed request's
               spans under one trace across the processes, the routing
               audit naming the worker that served it, the fleet's TTFT
               counts equal to the requests routed to each worker, the
               reference's /metrics series, every hook's failure count 0
               on /debug/engine and /metrics, no malformed digest at the
               frontend; the frontend's main, behind
               the survivor, serves the same views.
Tensor parallelism (`tp_kernels`, among the kernel phases: each sharded
wrapper on one rank's slice at llama-3.1-8b's TP 2 shapes, Hk 4, G 4,
against its plain version within KERNEL_TOL and ROW_REL_TOL, the page
copies bit for bit, timed beside the bound and the yardstick, and the
sharded MLA pair at DeepSeek-V3's rank shape, H 64 of 128 over the whole
latent pool (decode on the bf16 and the int8 latent, replayed beside TP
1's H 128 call; prefill of a 450-token chunk over 700); then,
after `lora_served` with nothing else on the card, `engine_tp`:
llama-3.1-8b at full width and depth through `--tensor-parallel 2`, two
rank processes on the card over gloo (`tp_ranks` prints the transport),
`tp_parity` against a TP 1 runner on the same seed-0 params (a prefill's
and a fused step's logits within FORWARD_REL_TOL, greedy agreement, a
decode step's ms at 8 rows for both), `tp_pull` (a TP 1 export imported
at TP 2 and exported back, bit for bit), the 3B's traffic fused
(`engine_tp`) and unfused (`engine_tp_unfused`) and, on the same ranks,
over int8 pools (`engine_tp_int8`): every rank's launches of each
sharded wrapper equal to its kernel's and to passes x 32 on Hk 4, the
ranks' counters and the digests of their returned tokens equal, each
rank's peak memory; then, on the same ranks, `engine_tp_mla`
(DeepSeek-V3's three dense layers at full width, MLA_CONFIG: the
sharded MLA pair on 64 heads a rank) and `engine_tp_moe` (qwen3-30b-a3b
at 8 layers: each expert's F / 2, the GQA wrappers at Hk 2, G 8), each
with `tp_parity_<phase>` against a TP 1 runner on the same seed-0 params
(the MoE one pinned to the TP 2 run's routing, its free run beside it),
one fused turn of the traffic with every rank's launch identities, and
the ranks' digests and peaks; then `engine_tp_70b`, llama-3.1-70b at TP
2, and `engine_tp_v3`, DeepSeek-V3 at full depth at TP 2, refused by the
fit check before anything is spawned or drawn).
Expert and data parallelism (after `engine_tp`, with nothing else on the
card; each mesh built through the worker's `build_runner` from
`--expert-parallel`, `--tensor-parallel` and `--data-parallel`, its rank
processes spawned for it and stopped after): `engine_ep_moe`
(qwen3-30b-a3b at 8 layers, EP 2: 64 experts a rank, whole heads),
`engine_ep_tp` (EP 2 x TP 2: four ranks, the GQA wrappers at Hk 2, each
expert's F / 2) and `engine_dp_ep` (DP 2 x EP 2: four ranks, the data
replicas mirroring their peers), each with `ep_parity_<phase>` against an
EP 1 runner on the same seed-0 params (tp_parity: a prefill's and a
fused step's logits, pinned to the mesh's routing, the free run beside
it, and a decode step's ms at 8 rows for both), `ep_buckets_<phase>`
(a 1-row decode all on the dense fallback, an 8-row decode all
dispatched, on every rank), and one fused turn of the 3B's traffic
(`engine_<phase>`: every rank's attention launches passes x 8 (the
sharded wrappers on Hk 2 under TP), the grouped GEMM passes x 8, MoE
blocks dispatched plus fallen back = passes x 8, three all_to_alls a
dispatch, the ranks' counters and digests equal, the collectives a pass
and their host seconds, each rank's peak memory); then
`engine_ep_mla_moe` (MLA_MOE_CONFIG at EP 2: 128 experts a rank, the
selection bias drawn away from 0 on every rank alike, MLA launches
passes x 4), its parity against the 30 GB EP 1 runner counted by the fit
check; and `ep_fit` (qwen3-30b-a3b at its 48 layers at EP 2 checked
against the card, DeepSeek-V3 at 61 layers at EP 2 refused, nothing
drawn).
`python3 chip_smoke.py --only tp` runs the build, these phases and the
tensor-parallel ones alone. Each top-level phase prints its seconds on a line of its own
(`phase_seconds`). For the script's time, the models of DEPTH_CUTS serve
their width at fewer layers (gemma-2-9b 10, the others 8), as the text
above says at each; every launch identity reads the runner's own depth.
The full-depth builds of mixtral-8x7b and qwen3-30b-a3b (and so their fit
checks on the card) no longer run: `mixtral_memory` prints the full
depth's param bytes as computed, not measured.
Then the `kernels` summary line (launches from the fused phase for the
GQA attention kernels, from engine_tp for the three sharded attention
wrappers and tp_pull for the two sharded copies, from engine_tp_mla for
the sharded MLA pair, from engine_disagg for gather and scatter, from
engine_tiers for the layer scatter, from engine_tiers_quant for the device
tier codec's two entries, from engine_mla for the MLA kernels,
from engine_int8kv and engine_mla_int8 for the `*_int8` entries, the
int8 bodies, from engine_qwen2 for the `*_G7` entries and from
engine_phi3 and engine_phi3_int8 for the `*_D96_window` and
`*_D96_int8_window` entries, whose times are head_shape_kernels', from
engine_qwen3moe for the grouped GEMM's two entries, whose times are
moe_kernels' qwen3-30b-a3b T 264 uniform case, from engine_quant and
engine_quant_fp8_3b for the `quant_gemm_*` entries (times: quant_kernels'
w_gate / tied table at M 8) and from engine_mixtral for the grouped
GEMM's `*_int8` entries (times: mixtral's T 264 uniform case); for
the GQA kernels also `variants`, the bodies each engine phase launched),
the
card's name and power limit, and, last, the contract line
{"ok": true, "device": {...}}. Any failed check exits non-zero before it.
It needs a CUDA device and the repository around it; it builds into
build/dynamo_tpu_torch/.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine import shm_weights, st_io, weights
from dynamo_tpu_torch.engine.model_runner import (
    DRAFT_RING_WINDOW,
    ModelRunner,
    layer_group_bounds,
)
from dynamo_tpu_torch.engine.ngram_draft import propose as ngram_propose
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.models.quant import (
    dequantize_weight,
    kv_pool_dequantize,
    kv_pool_quantize,
    kv_quantize,
    quantize_embed,
    quantize_params,
    quantize_weight,
)
from dynamo_tpu_torch.models.toolkit import attn_score_scale, layer_window, pool_values
from dynamo_tpu_torch.models import moe as moe_model
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops import block_copy as bc
from dynamo_tpu_torch.ops import moe_dispatch as md
from dynamo_tpu_torch.ops import quant_gemm as qg
from dynamo_tpu_torch.ops import tier_codec as tc
from dynamo_tpu_torch.ops.flash_prefill import (
    prefill_paged_attention,
    prefill_paged_attention_ref,
    prefill_paged_attention_sharded,
)
from dynamo_tpu_torch.ops.mla_attention import (
    INT8_TILE_TOKENS,
    MLA_INT8_SPLIT_TOKENS,
    MLA_SPLIT_TOKENS,
    decode_mla_attention,
    decode_mla_attention_ref,
    decode_mla_attention_sharded,
    prefill_mla_attention,
    prefill_mla_attention_ref,
    prefill_mla_attention_sharded,
    prefill_mla_tiles_ref,
)
from dynamo_tpu_torch.ops.paged_attention import (
    DECODE_MAX_G,
    DECODE_SPLIT_TOKENS,
    decode_split_tokens,
    decode_paged_attention,
    decode_paged_attention_ref,
    decode_paged_attention_sharded,
)
from dynamo_tpu_torch.ops.ragged_paged_attention import (
    SPLIT_TOKENS,
    build_ragged_metadata,
    ragged_paged_attention,
    ragged_paged_attention_ref,
    ragged_paged_attention_sharded,
)
from dynamo_tpu_torch.ops.block_copy import gather_pages_sharded, scatter_pages_sharded
from dynamo_tpu_torch.frontend.service import ModelManager, ModelWatcher
from dynamo_tpu_torch.router.kv_router import KvPushRouter, KvRouter
from dynamo_tpu_torch.router.prefill_router import DisaggPolicy, PrefillRouter
from dynamo_tpu_torch.router.protocols import KV_EVENT_SUBJECT
from dynamo_tpu_torch.router.scheduling import KvRouterConfig
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import FileDiscovery, MemDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.tracing import SpanRing, set_exporter, span_to_dict
from dynamo_tpu_torch.tokens.hashing import block_hashes
from dynamo_tpu_torch.worker import (
    build_engine,
    build_runner,
    parse_args,
    serve_args,
)

# NVIDIA H100 SXM data sheet (dense): HBM3 rate and bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores
KERNEL_TOL = 0.03  # docs/PERF.md "Kernel parity gate" (max abs err, bf16)
# MLA prefill against prefill_mla_tiles_ref(round_p=True), which rounds P to
# bf16 as the kernel does: max err over the valid rows in bf16 ulps of the
# reference's value (values under 1/8 at 1/8's ulp). The kernel reads 1-6
# ulps there, the f32 plain version 2-5: the tensor cores' accumulation
# moves P by as much as rounding it does, while a missed tile or a mask
# off by one moves outputs by far more (PERF.md, MLA prefill findings)
TILES_ULPS = 8
# forward parity: per-row relative L2 error of the f32 logits between the
# kernel path and the plain path. Both run bf16 activations; the plain
# path also rounds scores and probabilities to bf16, a ~0.4% relative
# error per rounding that 28 layers grow to around 1%. A wrong page, mask
# or softmax moves the logits by O(1) relative.
FORWARD_REL_TOL = 0.05
# the GQA kernels at `kernels`' ragged cases and at `shapes`',
# gemma_kernels' and head_shape_kernels' cases, against the plain version
# in f32: per query row (one head's D
# outputs), the max abs error over the row's RMS. A row over n visible
# tokens has an RMS near n^-1/2 (0.022 at a 2047-token window), so an
# absolute limit is loose exactly where a long window's edge lies. Rounding
# P and the output to bf16 puts a right kernel near 0.01 (a few 2^-9 at
# the row's largest elements); a window edge moved by one token, or a
# skipped 64-token tile, moves some row by more. gemma_case plants both
# faults in the plain computation and fails unless each one breaks this
# limit (the readings on the card: PERF.md, "A row-relative gate")
ROW_REL_TOL = 0.04


def model_args(model: str, max_seq_len: int = 4096, kv_quantize: bool = False):
    """A full-size model's engine flags: 2048 pages of 16 tokens, batch 8,
    chunk 512, as ENGINE_ARGS."""
    return (["--model", model, "--num-pages", "2048", "--page-size", "16",
             "--max-seq-len", str(max_seq_len), "--max-batch", "8",
             "--chunk-size", "512"] + (["--kv-quantize", "int8"] if kv_quantize else []))


ENGINE_ARGS = model_args("llama-3.2-3b")


# Depth cuts for the script's time (the launch identities read each
# runner's own depth): these models' phases serve the preset's width with
# fewer layers, as many of each kind where layers differ (Gemma-2's even
# sliding and odd global ones). The 3B's paths (but its fp8 weights') and
# llama-3.1-8b at TP 2 keep their full depth.
DEPTH_CUTS = {"gemma-2-9b": 10, "phi-3-mini-4k": 8, "qwen2.5-7b": 8,
              "qwen3-30b-a3b": 8, "qwen3-8b": 8, "mistral-7b": 8, "gemma-7b": 8,
              "olmo-2-7b": 8, "granite-3.1-8b": 8, "llama-3.1-8b": 8,
              "mixtral-8x7b": 8, "llama-3.2-3b": 8}


def timed_runner(args, params=None, cut: bool = False, layers: int = 0):
    """build_runner from engine flags: (runner, config, seconds to build).
    `cut`: the model at its DEPTH_CUTS depth; `layers`: at that many
    layers (its preset swapped for the build)."""
    from dynamo_tpu_torch.models import config as config_mod

    model = args[args.index("--model") + 1]
    full = config_mod.PRESETS[model]
    if cut or layers:
        config_mod.PRESETS[model] = full.with_(n_layers=layers or DEPTH_CUTS[model])
    try:
        t0 = time.monotonic()
        runner, cfg = build_runner(parse_args(args), params=params)
        torch.cuda.synchronize()
        return runner, cfg, time.monotonic() - t0
    finally:
        config_mod.PRESETS[model] = full


def free(*runners):
    """Drop the runners' pools and params and return their memory."""
    for r in runners:
        r.k_pool = r.v_pool = r.params = None
        r.draft_k_pool = r.draft_v_pool = r.draft_params = None
    gc.collect()
    torch.cuda.empty_cache()


SOURCES = {
    "decode_paged_attention": (
        "dynamo_tpu_torch/ops/csrc/paged_attention.cu",
        "dynamo_tpu/ops/paged_attention.py:302"),
    "prefill_paged_attention": (
        "dynamo_tpu_torch/ops/csrc/flash_prefill.cu",
        "dynamo_tpu/ops/flash_prefill.py:313"),
    "ragged_paged_attention": (
        "dynamo_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "dynamo_tpu/ops/ragged_paged_attention.py:486"),
    "gather_pages": ("dynamo_tpu_torch/ops/csrc/block_copy.cu",
                     "dynamo_tpu/ops/block_copy.py:79"),
    "scatter_pages": ("dynamo_tpu_torch/ops/csrc/block_copy.cu",
                      "dynamo_tpu/ops/block_copy.py:226"),
    "scatter_pages_layers": ("dynamo_tpu_torch/ops/csrc/block_copy.cu",
                             "dynamo_tpu/ops/block_copy.py:186"),
    "decode_mla_attention": ("dynamo_tpu_torch/ops/csrc/mla_attention.cu",
                             "dynamo_tpu/ops/mla_attention.py:161"),
    "prefill_mla_attention": ("dynamo_tpu_torch/ops/csrc/mla_attention.cu",
                              "dynamo_tpu/ops/mla_attention.py:299"),
    # the grouped GEMM replaces no TPU kernel: XLA computes every expert
    "moe_gate_up": ("dynamo_tpu_torch/ops/csrc/moe_grouped_gemm.cu",
                    "dynamo_tpu/models/moe.py:69 (XLA vmap over experts; no Pallas kernel)"),
    "moe_down": ("dynamo_tpu_torch/ops/csrc/moe_grouped_gemm.cu",
                 "dynamo_tpu/models/moe.py:69 (XLA vmap over experts; no Pallas kernel)"),
}
KERNELS = {"decode_paged_attention": decode_paged_attention,
           "prefill_paged_attention": prefill_paged_attention,
           "ragged_paged_attention": ragged_paged_attention,
           "gather_pages": bc.gather_pages,
           "scatter_pages": bc.scatter_pages,
           "scatter_pages_layers": bc.scatter_pages_layers,
           "decode_mla_attention": decode_mla_attention,
           "prefill_mla_attention": prefill_mla_attention,
           "moe_gate_up": md.moe_gate_up,
           "moe_down": md.moe_down,
           "quant_gemm": qg.quant_matmul,
           "tier_quantize": tc.tier_quantize,
           "tier_dequantize": tc.tier_dequantize}
# the device tier codec replaces no TPU kernel: the reference's codec is
# numpy on the host
TIER_CODEC_SOURCES = {
    "tier_quantize": ("dynamo_tpu_torch/ops/csrc/tier_codec.cu",
                      "dynamo_tpu/kvbm/quant.py:49 (numpy on the host; no Pallas kernel)"),
    "tier_dequantize": ("dynamo_tpu_torch/ops/csrc/tier_codec.cu",
                        "dynamo_tpu/kvbm/quant.py:66 (numpy on the host; no Pallas kernel)"),
}
COPY_KERNELS = ("gather_pages", "scatter_pages", "scatter_pages_layers")
GQA_KERNELS = ("decode_paged_attention", "prefill_paged_attention",
               "ragged_paged_attention")
GQA_STEMS = ("paged_attention", "flash_prefill", "ragged_paged_attention")
MLA_KERNELS = ("decode_mla_attention", "prefill_mla_attention")
MOE_KERNELS = ("moe_gate_up", "moe_down")
# DeepSeek-V3's first three layers (dense FFN) at full width
MLA_CONFIG = get_config("deepseek-v3").with_(n_layers=3, n_experts=0)
# and its first MoE layer after them (256 experts, one shared, V3's routing)
MLA_MOE_CONFIG = get_config("deepseek-v3").with_(n_layers=4)


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


_T_START = time.monotonic()


def timed(name: str, fn, *args):
    """Run one top-level phase and print its seconds on a line of its
    own (also when it fails)."""
    t = time.monotonic()
    try:
        return fn(*args)
    finally:
        emit({"phase_seconds": name, "seconds": time.monotonic() - t})


def emit(obj) -> None:
    """One JSON line, with `t_s`: the seconds since the script started."""
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "t_s": time.monotonic() - _T_START}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 10) -> float:
    """Mean host time of one fn() call, each launched onto an idle device
    (synchronized between calls, outside the timing)."""
    fn()
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / iters * 1e3


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one fn() call: `iters` calls captured in a CUDA
    graph, replayed `replays` times between CUDA events. The host's launch
    cost, which cuda_ms's back-to-back calls include for calls of tens of
    microseconds, is left out."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()  # warm the allocator on the capture stream
        with torch.cuda.graph(graph, stream=side):
            for _ in range(iters):
                fn()
    torch.cuda.synchronize()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound(n_bytes: float, n_flops: float, n_fp32: float = 0.0):
    """Least time (ms) for the bytes at the HBM rate, the bf16 tensor-core
    operations and the f32 ones outside the tensor cores (a soft cap's
    tanh) at their peaks, and which of the two kinds bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_flops / BF16_FLOPS_PER_S, n_fp32 / FP32_FLOPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ptxas_lines(log: str):
    """ptxas -v per kernel instantiation: entry name, registers, spills."""
    return [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]


def ptxas_entries(log: str):
    """{kernel instantiation: {registers, stack, spill_stores, spill_loads}}
    from `ptxas -v`, keyed by a short name: the kernel and its template
    arguments, e.g. "prefill_kernel<256,1,0>" (D 256, soft cap, no window)."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = (re.search(r"Compiling entry function '([^']+)'", ln)
             or re.search(r"Function properties for (\S+)", ln))
        if m:
            name = m.group(1)
            kern = re.search(r"([A-Za-z_]+_kernel)", name)
            args = re.findall(r"L[ib](\d+)E", name)
            key = (kern.group(1) if kern else name) + (f"<{','.join(args)}>" if args else "")
            cur = out.setdefault(key, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m[1])
    return out


def random_pages(gen, B, MP, NP, dev):
    """[B, MP] int32: distinct pages per row (pages 0..NP-1, a permutation
    slice), so a wrong table read lands on another row's data."""
    perm = torch.randperm(NP, generator=gen, device="cpu")[: B * MP]
    return perm.view(B, MP).to(torch.int32).to(dev)


def dense_kv(pool, page_table, Hk, G):
    """[B, H, C, D] K or V gathered from the pool, heads repeated for GQA
    (built once, outside the timed region of the library call)."""
    B, MP = page_table.shape
    _, PS, _, D = pool.shape
    x = pool[page_table.long()].reshape(B, MP * PS, Hk, D)
    return x.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()


# the ragged kernel's main-path step: the chip engine's T bucket (its
# 256-token mixed pool + 8 decode rows), 8 decode rows over contexts up
# to 4096 tokens and 4 chunks (q_len, prior) that cross q-block bounds
RAGGED_T = 264
RAGGED_DECODE_KV = [4096, 1, 17, 1000, 2048, 3333, 513, 64]
RAGGED_CHUNKS = [(125, 700), (67, 0), (48, 1500), (16, 3000)]


def ragged_inputs(gen, segs, T, Hk, G, D, PS, MP, dev):
    """q, pools and kernel operands for segments [(q_len, prior)], each
    on its own pages (a wrong table read lands on another's data)."""
    q_lens = [n for n, _ in segs]
    starts = [p for _, p in segs]
    NP = len(segs) * MP + 1
    pt = random_pages(gen, len(segs), MP, NP, "cpu")
    md = build_ragged_metadata(q_lens, starts, [p + n for n, p in segs],
                               pt.tolist(), T, max_pages=MP)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).bfloat16().to(dev)

    ints = tuple(torch.from_numpy(md[k]).to(dev)
                 for k in ("seg_page_table", "seg_kv_lens", "meta"))
    return (rnd(T, Hk, G, D), rnd(NP, PS, Hk, D), rnd(NP, PS, Hk, D)) + ints, md


def plain32(tensors):
    """The plain version's f32 operands: bf16 tensors in f32, int8 pools
    (dicts, models/quant.py) as they are."""
    return tuple(x.float() if torch.is_tensor(x) and x.dtype == torch.bfloat16 else x
                 for x in tensors)


def row_rel_err(got, want):
    """Max over the rows (the last dim) of the max abs error over the
    row's RMS in `want`; a row that is 0 in both reads 0."""
    want = want.float()
    err = (got.float() - want).abs().amax(-1)
    rms = want.square().mean(-1).sqrt()
    return torch.where(err == 0, 0.0, err / rms).max().item()


def ragged_check(args, segs, what):
    """Kernel against the plain version on the real rows; tail rows (the
    dummy segment) must be exactly 0. Returns the max abs error and
    row_rel_err against the plain version in f32 (within ROW_REL_TOL)."""
    out = ragged_paged_attention(*args)
    torch.cuda.synchronize()
    ref = ragged_paged_attention_ref(*args)
    n = sum(q for q, _ in segs)
    err = (out[:n].float() - ref[:n].float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(),
          f"ragged kernel output not finite ({what})")
    check(n == out.shape[0] or out[n:].float().abs().max().item() == 0.0,
          f"ragged tail rows are not 0 ({what})")
    check(err <= KERNEL_TOL, f"ragged kernel max abs err {err} > {KERNEL_TOL} ({what})")
    e_rel = row_rel_err(out[:n], ragged_paged_attention_ref(*plain32(args[:3]),
                                                             *args[3:])[:n])
    check(e_rel <= ROW_REL_TOL, f"ragged kernel row error {e_rel} > {ROW_REL_TOL} ({what})")
    return err, e_rel


def capped_attention(qd, kd, vd, mask, scale, cap):
    """The soft-capped yardstick (no one PyTorch call caps scores): bmm,
    tanh, softmax, bmm over dense [.., H, S, D] and [.., H, C, D] under a
    boolean mask [.., S, C]."""
    def run():
        s = torch.matmul(qd, kd.transpose(-1, -2)).float() * scale
        s = (cap * torch.tanh(s / cap)).masked_fill(~mask, float("-inf"))
        return torch.matmul(torch.softmax(s, -1).to(vd.dtype), vd)
    return run


def ragged_library(args, segs, md, scale, window=0, softcap=0.0):
    """SDPA yardstick inputs: the real queries [1, H, n, D] against every
    segment's visible K/V gathered dense [1, H, C, D] beforehand, under a
    segment-causal mask [n, C] (and the window, if any; with a soft cap,
    capped_attention instead of SDPA)."""
    q, kp, vp = args[:3]
    T, Hk, G, D = q.shape
    dev = q.device
    ks, vs, col_seg, col_pos = [], [], [], []
    for s, (n, p) in enumerate(segs):
        pages = torch.from_numpy(md["seg_page_table"][s]).to(dev).long()
        ks.append(kp[pages].reshape(-1, Hk, D)[:p + n])
        vs.append(vp[pages].reshape(-1, Hk, D)[:p + n])
        col_seg.append(torch.full((p + n,), s, device=dev))
        col_pos.append(torch.arange(p + n, device=dev))

    def heads(x):
        return x.permute(1, 0, 2).repeat_interleave(G, dim=0)[None].contiguous()

    n = sum(q_len for q_len, _ in segs)
    tok_seg = torch.repeat_interleave(
        torch.arange(len(segs), device=dev),
        torch.tensor([q_len for q_len, _ in segs], device=dev))
    tok_pos = torch.from_numpy(md["tok_positions"][:n]).to(dev)
    col_seg, col_pos = torch.cat(col_seg), torch.cat(col_pos)
    mask = ((col_seg[None, :] == tok_seg[:, None])
            & (col_pos[None, :] <= tok_pos[:, None]))
    if window:
        mask &= col_pos[None, :] > tok_pos[:, None] - window
    mask = mask[None, None]
    qd = q[:n].reshape(n, Hk * G, D).transpose(0, 1)[None].contiguous()
    kd, vd = heads(torch.cat(ks)), heads(torch.cat(vs))
    if softcap:
        return capped_attention(qd, kd, vd, mask, scale, softcap)
    return lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                                  scale=scale)


def ragged_phase(gen, dev):
    """The ragged kernel at the main path's step (timed), the same step
    without its last chunk (a 16-row tail), a verify-shaped step and,
    untimed, rows at the edges of the kernel's context splits: decode
    rows at kv_len L_s - 1, L_s, L_s + 1 and 2 L_s and an 8-token chunk
    from L_s - 3 (L_s = SPLIT_TOKENS), T 16 (a 4-row tail)."""
    Hk, G, D, PS = 8, 3, 128, 16
    H, MP = Hk * G, 4096 // PS
    scale = D ** -0.5
    decode = [(1, kv - 1) for kv in RAGGED_DECODE_KV]
    L_s = SPLIT_TOKENS
    cases = {
        "mixed": decode + RAGGED_CHUNKS,
        "mixed_tail": decode + RAGGED_CHUNKS[:-1],
        "verify": [(5, max(kv - 5, 0)) for kv in RAGGED_DECODE_KV]
        + RAGGED_CHUNKS[:2],
        "split_edges": [(1, kv - 1) for kv in (L_s - 1, L_s, L_s + 1, 2 * L_s)]
        + [(8, L_s - 3)],
    }
    out = {}
    for name, segs in cases.items():
        T = 16 if name == "split_edges" else RAGGED_T
        args, md = ragged_inputs(gen, segs, T, Hk, G, D, PS, MP, dev)
        rec = {"segments": segs, "t_real": sum(n for n, _ in segs)}
        rec["max_abs_err"], rec["row_rel_err"] = ragged_check(args, segs, name)
        if name == "split_edges":
            out[name] = rec
            continue
        rec["ms"] = cuda_ms(lambda: ragged_paged_attention(*args))
        rec["plain_ms"] = cuda_ms(lambda: ragged_paged_attention_ref(*args),
                                  iters=5)
        if name == "mixed":
            # what the data needs: real q rows read, all T out rows
            # written, each segment's visible K/V once, the table entries
            # of its visible pages, seg_kv_lens and meta; one score and
            # one PV product per visible (query, key) pair
            kv_tok = sum(n + p for n, p in segs)
            n_bytes = (rec["t_real"] * H * D * 2 + RAGGED_T * H * D * 2
                       + kv_tok * Hk * D * 2 * 2
                       + sum(-(-(n + p) // PS) for n, p in segs) * 4
                       + md["seg_kv_lens"].size * 4 + md["meta"].size * 4)
            pairs = sum(p + i + 1 for n, p in segs for i in range(n))
            rec["bound_ms"], rec["bound_by"] = bound(n_bytes, 4 * pairs * H * D)
            lib = ragged_library(args, segs, md, scale)
            rec["library_ms"] = cuda_ms(lib)
            rec["device_ms"] = graph_ms(lambda: ragged_paged_attention(*args))
            rec["library_device_ms"] = graph_ms(lib)
        out[name] = rec
        del args
    top = {k: out["mixed"][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "device_ms",
                                        "library_device_ms")}
    top["max_abs_err"] = max(c["max_abs_err"] for c in out.values())
    top["shape"] = {"T": RAGGED_T, "Hk": Hk, "G": G, "D": D, "PS": PS}
    top["cases"] = out
    return top


def kernel_phase(dev):
    gen = torch.Generator(device="cpu").manual_seed(0)
    Hk, G, D, PS = 8, 3, 128, 16
    H = Hk * G
    scale = D ** -0.5
    results = {}

    # decode: B = 8, ragged kv_len up to 4096, one empty row
    kv_list = [4096, 0, 1, 17, 1000, 2048, 3333, 513]
    B, MP = len(kv_list), 4096 // PS
    NP = B * MP + 1
    k_pool = torch.randn(NP, PS, Hk, D, generator=gen).bfloat16().to(dev)
    v_pool = torch.randn(NP, PS, Hk, D, generator=gen).bfloat16().to(dev)
    q = torch.randn(B, Hk, G, D, generator=gen).bfloat16().to(dev)
    pt = random_pages(gen, B, MP, NP, dev)
    kvl = torch.tensor(kv_list, dtype=torch.int32, device=dev)
    out = decode_paged_attention(q, k_pool, v_pool, pt, kvl)
    torch.cuda.synchronize()
    ref = decode_paged_attention_ref(q, k_pool, v_pool, pt, kvl)
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), "decode kernel output not finite")
    check(out[1].float().abs().max().item() == 0.0, "decode kv_len=0 row is not 0")
    check(err <= KERNEL_TOL, f"decode kernel max abs err {err} > {KERNEL_TOL}")
    kq = dense_kv(k_pool, pt, Hk, G)
    vq = dense_kv(v_pool, pt, Hk, G)
    qd = q.reshape(B, H, 1, D)
    mask = (torch.arange(MP * PS, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    n_tok = sum(kv_list)
    n_bytes = (2 * q.numel() * 2 + n_tok * Hk * D * 2 * 2
               + sum(-(-k // PS) for k in kv_list) * 4 + B * 4)
    bound_ms, bound_by = bound(n_bytes, 4 * n_tok * H * D)
    def decode():
        return decode_paged_attention(q, k_pool, v_pool, pt, kvl)

    def library():
        return F.scaled_dot_product_attention(qd, kq, vq, attn_mask=mask, scale=scale)

    results["decode_paged_attention"] = {
        "max_abs_err": err,
        "ms": cuda_ms(decode),
        "plain_ms": cuda_ms(lambda: decode_paged_attention_ref(q, k_pool, v_pool, pt, kvl)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cuda_ms(library),
        "device_ms": graph_ms(decode), "library_device_ms": graph_ms(library),
        "shape": {"B": B, "Hk": Hk, "G": G, "D": D, "PS": PS,
                  "kv_lens": kv_list},
    }
    del k_pool, v_pool, kq, vq

    # prefill: S = 512 with no prior context, then over 700 prior tokens,
    # both with q_len < S (padding rows)
    cases = []
    for prior, q_len in ((0, 500), (700, 450)):
        S, B = 512, 1
        kv = prior + q_len
        MP = -(-kv // PS) + 2  # table tail past kv_len: other pages
        NP = MP + 1
        k_pool = torch.randn(NP, PS, Hk, D, generator=gen).bfloat16().to(dev)
        v_pool = torch.randn(NP, PS, Hk, D, generator=gen).bfloat16().to(dev)
        q = torch.randn(B, S, Hk, G, D, generator=gen).bfloat16().to(dev)
        pt = random_pages(gen, B, MP, NP, dev)
        ints = [torch.tensor([x], dtype=torch.int32, device=dev)
                for x in (prior, q_len, kv)]
        args = (q, k_pool, v_pool, pt, *ints)
        out = prefill_paged_attention(*args)
        torch.cuda.synchronize()
        ref = prefill_paged_attention_ref(*args)
        err = (out[:, :q_len].float() - ref[:, :q_len].float()).abs().max().item()
        check(torch.isfinite(out.float()).all().item(), "prefill kernel output not finite")
        check(out[:, q_len:].float().abs().max().item() == 0.0,
              "prefill padding rows are not 0")
        check(err <= KERNEL_TOL, f"prefill kernel max abs err {err} > {KERNEL_TOL} "
              f"(prior {prior})")
        kq = dense_kv(k_pool, pt, Hk, G)
        vq = dense_kv(v_pool, pt, Hk, G)
        qd = q.reshape(B, S, H, D).transpose(1, 2)
        s_pos = prior + torch.arange(S, device=dev)
        c_pos = torch.arange(MP * PS, device=dev)
        mask = ((c_pos[None, :] <= s_pos[:, None]) & (c_pos[None, :] < kv))[None, None]
        # what the data needs: valid query rows (q read, out written in
        # full), the K/V rows below min(kv_len, causal top), and one score
        # and one PV product per visible (query, key) pair
        n_pairs = sum(min(prior + s + 1, kv) for s in range(q_len))
        n_bytes = (q_len * H * D * 2 + q.numel() * 2 + kv * Hk * D * 4
                   + (-(-kv // PS)) * 4 + 3 * 4)
        bound_ms, bound_by = bound(n_bytes, 4 * n_pairs * H * D)
        def library():
            return F.scaled_dot_product_attention(qd, kq, vq, attn_mask=mask,
                                                  scale=scale)

        cases.append({
            "prior": prior, "q_len": q_len, "S": S, "max_abs_err": err,
            "ms": cuda_ms(lambda: prefill_paged_attention(*args)),
            "plain_ms": cuda_ms(lambda: prefill_paged_attention_ref(*args)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cuda_ms(library),
            "device_ms": graph_ms(lambda: prefill_paged_attention(*args)),
            "library_device_ms": graph_ms(library),
        })
        del k_pool, v_pool, kq, vq
    top = dict(cases[-1])  # the chunked-prefill case heads the summary
    top["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    for k in ("prior", "q_len", "S"):
        top.pop(k)
    top["cases"] = cases
    results["prefill_paged_attention"] = top
    results["ragged_paged_attention"] = ragged_phase(gen, dev)
    emit({"phase": "kernels", "tol": KERNEL_TOL, **results})
    return results


def shapes_phase(dev):
    """The three kernels against their plain versions at the other shapes
    the wrappers accept (head dims 64/96/128, GQA groups, page sizes 4 to
    32, the main path's G 3, qwen2.5-7b's G 7 and phi-3's D 96 among them,
    q-blocks that overrun S), small and untimed; their int8 bodies on the
    same rows, quantized, against the plain int8 versions in f32. Each is
    within KERNEL_TOL of the plain version and within ROW_REL_TOL (row by
    row) of the plain version in f32."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    errs, rel = {}, {}

    def rows(out, ref, name):  # max row error over the plain version in f32
        e = row_rel_err(out, ref)
        check(e <= ROW_REL_TOL, f"{name}: row error {e} > {ROW_REL_TOL}")
        return e

    for D, G, PS in ((128, 4, 16), (128, 1, 8), (128, 8, 32), (64, 4, 16),
                     (64, 2, 4), (128, 3, 16), (128, 3, 4), (64, 3, 32),
                     (96, 1, 16), (96, 7, 4), (128, 7, 16), (96, 4, 32)):
        Hk, MP = 2, max(64, 1024 // PS)  # 1024+ tokens: two context splits
        NP = 3 * MP + 1
        name = f"D{D}_G{G}_PS{PS}"

        def rnd(*shape):
            return torch.randn(*shape, generator=gen).bfloat16().to(dev)

        k_pool, v_pool = rnd(NP, PS, Hk, D), rnd(NP, PS, Hk, D)
        pt = random_pages(gen, 3, MP, NP, dev)
        k8, v8 = kv_pool_quantize(k_pool), kv_pool_quantize(v_pool)
        q = rnd(3, Hk, G, D)
        kvl = torch.tensor([0, 37, 200], dtype=torch.int32, device=dev)
        out = decode_paged_attention(q, k_pool, v_pool, pt, kvl)
        ref = decode_paged_attention_ref(q, k_pool, v_pool, pt, kvl)
        e_dec = (out.float() - ref.float()).abs().max().item()
        r_dec = rows(out, decode_paged_attention_ref(
            *plain32((q, k_pool, v_pool)), pt, kvl), f"decode at {name}")
        check(out[0].float().abs().max().item() == 0.0,
              f"decode kv_len=0 row not 0 at D={D} G={G} PS={PS}")
        out = decode_paged_attention(q, k8, v8, pt, kvl)
        ref = decode_paged_attention_ref(q.float(), k8, v8, pt, kvl)
        e8_dec = (out.float() - ref).abs().max().item()
        r8_dec = rows(out, ref, f"int8 decode at {name}")
        check(out[0].float().abs().max().item() == 0.0,
              f"int8 decode kv_len=0 row not 0 at D={D} G={G} PS={PS}")
        S = 48
        q = rnd(2, S, Hk, G, D)
        qs, ql = [0, 30], [40, 17]
        ints = [torch.tensor(x, dtype=torch.int32, device=dev)
                for x in (qs, ql, [qs[0] + ql[0], qs[1] + ql[1] + 3])]
        args = (q, k_pool, v_pool, pt[:2].contiguous(), *ints)
        out = prefill_paged_attention(*args)
        ref = prefill_paged_attention_ref(*args)
        e_pre = (out.float() - ref.float()).abs().max().item()
        r_pre = rows(out, prefill_paged_attention_ref(*plain32(args[:3]), *args[3:]),
                     f"prefill at {name}")
        torch.cuda.synchronize()
        check(all(out[b, n:].float().abs().max().item() == 0.0
                  for b, n in enumerate(ql)), f"prefill padding rows not 0 at {name}")
        out = prefill_paged_attention(q, k8, v8, *args[3:])
        ref = prefill_paged_attention_ref(q.float(), k8, v8, *args[3:])
        e8_pre = (out.float() - ref).abs().max().item()
        r8_pre = rows(out, ref, f"int8 prefill at {name}")
        check(all(out[b, n:].float().abs().max().item() == 0.0
                  for b, n in enumerate(ql)), f"int8 prefill padding rows not 0 at {name}")
        # ragged: decode rows, chunks over prior context, a row and a
        # chunk past the first context split, a 9-row tail
        segs = [(1, 36), (1, 0), (21, 13), (9, 0), (5, 100), (1, 700),
                (9, SPLIT_TOKENS - 2)]
        args, _ = ragged_inputs(gen, segs, 56, Hk, G, D, PS, MP, dev)
        e_rag, r_rag = ragged_check(args, segs, name)
        args8 = (args[0], kv_pool_quantize(args[1]), kv_pool_quantize(args[2])) + args[3:]
        e8_rag, r8_rag = ragged_check(args8, segs, f"{name} int8")
        errs[name] = {"decode": e_dec, "prefill": e_pre, "ragged": e_rag,
                      "int8": {"decode": e8_dec, "prefill": e8_pre, "ragged": e8_rag}}
        rel[name] = {"decode": r_dec, "prefill": r_pre, "ragged": r_rag,
                     "int8": {"decode": r8_dec, "prefill": r8_pre, "ragged": r8_rag}}
        check(max(e_dec, e_pre, e8_dec, e8_pre) <= KERNEL_TOL,
              f"kernel parity at {name}: decode {e_dec}, prefill {e_pre}, "
              f"int8 decode {e8_dec}, int8 prefill {e8_pre}")
    # decode at every (D, G) its wrapper takes, rows over 1 to 4 splits
    for D in (64, 96, 128):
        for G in range(1, DECODE_MAX_G + 1):
            Hk, PS, MP = 2, 16, 64
            NP = 4 * MP + 1
            k_pool, v_pool = (torch.randn(NP, PS, Hk, D, generator=gen)
                              .bfloat16().to(dev) for _ in range(2))
            pt = random_pages(gen, 4, MP, NP, dev)
            q = torch.randn(4, Hk, G, D, generator=gen).bfloat16().to(dev)
            kvl = torch.tensor([0, 37, DECODE_SPLIT_TOKENS + 5, 1000],
                               dtype=torch.int32, device=dev)
            out = decode_paged_attention(q, k_pool, v_pool, pt, kvl)
            torch.cuda.synchronize()
            ref = decode_paged_attention_ref(q, k_pool, v_pool, pt, kvl)
            err = (out.float() - ref.float()).abs().max().item()
            check(out[0].float().abs().max().item() == 0.0,
                  f"decode kv_len=0 row not 0 at D={D} G={G}")
            check(err <= KERNEL_TOL, f"decode max abs err {err} at D={D} G={G}")
            errs[f"decode_D{D}_G{G}"] = err
            rel[f"decode_D{D}_G{G}"] = rows(out, decode_paged_attention_ref(
                *plain32((q, k_pool, v_pool)), pt, kvl), f"decode at D={D} G={G}")
    emit({"phase": "shapes", "tol": KERNEL_TOL, "max_abs_err": errs,
          "row_tol": ROW_REL_TOL, "row_rel_err": rel})


# page sizes of the int8 decode check beyond the engine's 16: the kernel
# loads a page (or 64 rows) of a head by one TMA box at 8, 32, 64 and 128,
# and a row at a time at 4
INT8_PAGE_SIZES = (4, 8, 32, 64, 128)


def int8_page_sizes(rnd, gate, kv_lens, dev):
    """The int8 decode kernel at INT8_PAGE_SIZES (D 128, Hk 2, G 3; rows at
    kv_lens, the edges of its split), global and with a 100-token window
    (whose low edge falls inside a page and a 64-token tile), against the
    plain int8 version in f32: max abs error within KERNEL_TOL, row error
    within ROW_REL_TOL, the kv_len-0 row exactly 0."""
    Hk, G, D = 2, 3, 128
    B = len(kv_lens)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    q = rnd(B, Hk, G, D)
    out = {}
    for ps in INT8_PAGE_SIZES:
        MP = -(-max(kv_lens) // ps)
        gen = torch.Generator(device="cpu").manual_seed(ps)
        pt = random_pages(gen, B, MP, B * MP + 1, dev)
        k8, v8 = (kv_pool_quantize(rnd(B * MP + 1, ps, Hk, D)) for _ in range(2))
        for window in (0, 100):
            got = decode_paged_attention(q, k8, v8, pt, kvl, window)
            torch.cuda.synchronize()
            want = decode_paged_attention_ref(q.float(), k8, v8, pt, kvl, window=window)
            what = f"int8 decode PS {ps} window {window}"
            rel = row_rel_err(got, want)
            check(rel <= ROW_REL_TOL, f"{what}: row error {rel} > {ROW_REL_TOL}")
            out[f"PS{ps}_w{window}"] = {"max_abs_err": gate(got, want, what),
                                        "row_rel_err": rel}
        del k8, v8
    return out


def decode_split_edges_phase(dev):
    """Both decode kernels with rows at the edges of their context splits
    (kv_len 0, 1, split - 1, split, split + 1, 2 split and 4096), GQA at
    the main path's heads and MLA at H 16, 32 and 128, bf16 and int8
    (the pools quantized; against the plain int8 version in f32; GQA int8
    at its own split, and at other page sizes: int8_page_sizes), untimed:
    max abs err within KERNEL_TOL, the kv_len-0 row exactly 0."""
    gen = torch.Generator(device="cpu").manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).bfloat16().to(dev)

    def edges(split):
        return [0, 1, split - 1, split, split + 1, 2 * split, 4096]

    def gate(out, ref, what):
        err = (out.float() - ref.float()).abs().max().item()
        check(torch.isfinite(out.float()).all().item(), f"{what}: output not finite")
        check(out[0].float().abs().max().item() == 0.0, f"{what}: kv_len=0 row is not 0")
        check(err <= KERNEL_TOL, f"{what}: max abs err {err} > {KERNEL_TOL}")
        return err

    PS, MP = 16, 4096 // 16
    kv_gqa = edges(DECODE_SPLIT_TOKENS)
    B = len(kv_gqa)
    Hk, G, D = 8, 3, 128
    pt = random_pages(gen, B, MP, B * MP + 1, dev)
    kp, vp = rnd(B * MP + 1, PS, Hk, D), rnd(B * MP + 1, PS, Hk, D)
    q = rnd(B, Hk, G, D)
    kvl = torch.tensor(kv_gqa, dtype=torch.int32, device=dev)
    out = decode_paged_attention(q, kp, vp, pt, kvl)
    torch.cuda.synchronize()
    rec = {"gqa": {"split": DECODE_SPLIT_TOKENS, "kv_lens": kv_gqa,
                   "max_abs_err": gate(out, decode_paged_attention_ref(
                       q, kp, vp, pt, kvl), "decode split edges")}}
    # int8 pools: the edges of their own split
    k8, v8 = kv_pool_quantize(kp), kv_pool_quantize(vp)
    kv8 = edges(decode_split_tokens(D, True))
    kvl = torch.tensor(kv8, dtype=torch.int32, device=dev)
    out = decode_paged_attention(q, k8, v8, pt, kvl)
    torch.cuda.synchronize()
    rec["gqa"].update(split_int8=decode_split_tokens(D, True), kv_lens_int8=kv8)
    rec["gqa"]["max_abs_err_int8"] = gate(
        out, decode_paged_attention_ref(q.float(), k8, v8, pt, kvl),
        "int8 decode split edges")
    del kp, vp, k8, v8
    rec["gqa"]["int8_page_sizes"] = int8_page_sizes(rnd, gate, kv8, dev)
    kv_mla = edges(MLA_SPLIT_TOKENS)
    kv_mla8 = edges(MLA_INT8_SPLIT_TOKENS)
    lat = rnd(B * MP + 1, PS, 1, MLA_DC + MLA_DR)
    lat8 = kv_pool_quantize(lat)
    scale = attn_score_scale(MLA_CONFIG, MLA_CONFIG.qk_nope_head_dim + MLA_DR)
    rec["mla"] = {"split": MLA_SPLIT_TOKENS, "kv_lens": kv_mla,
                  "split_int8": MLA_INT8_SPLIT_TOKENS, "kv_lens_int8": kv_mla8,
                  "max_abs_err": {}}
    for H in (16, 32, 128):
        q = rnd(B, H, MLA_DC + MLA_DR)
        for kind, pool, qr, kv in (("", lat, q, kv_mla), ("_int8", lat8, q.float(), kv_mla8)):
            kvl = torch.tensor(kv, dtype=torch.int32, device=dev)
            out = decode_mla_attention(q, pool, pt, kvl, dc=MLA_DC, scale=scale)
            torch.cuda.synchronize()
            ref = decode_mla_attention_ref(qr, pool, pt, kvl, dc=MLA_DC, scale=scale)
            rec["mla"]["max_abs_err"][f"H{H}{kind}"] = gate(
                out, ref, f"MLA{kind} decode split edges H {H}")
    del lat, lat8
    torch.cuda.empty_cache()
    emit({"phase": "decode_split_edges", "tol": KERNEL_TOL, **rec})


# the page-copy kernels at the 3B page shape: the pages of a 1500-token
# prompt in a 2048-page pool, and the onboard's 4 layer groups
COPY_SHAPE = (28, 2048, 16, 8, 128)  # L, NP, PS, Hk, D
COPY_N = 94
COPY_GROUPS = 4
TIER_ONBOARD_PAGES = 64  # engine_tiers' onboard: A2's 1024 shared tokens


def copy_kernel_phase(dev):
    """gather (token- and head-major), scatter and the layered scatter
    against their plain versions, bit for bit, each timed three ways: the
    kernel launch alone (`ms`, operands checked once beforehand), the
    wrapper with its checks (`wrapper_ms`: one readback of the page ids
    per call), the plain version and one PyTorch library call."""
    L, NP, PS, Hk, D = COPY_SHAPE
    dgen = torch.Generator(device=dev).manual_seed(4)
    cgen = torch.Generator(device="cpu").manual_seed(4)
    pool = torch.randn(COPY_SHAPE, generator=dgen, device=dev).bfloat16()
    pages = torch.randn((L, COPY_N, PS, Hk, D), generator=dgen, device=dev).bfloat16()
    idx = torch.randperm(NP, generator=cgen)[:COPY_N].to(torch.int32).to(dev)
    idx_l = idx.long()
    # read once and written once: the pages' bytes twice
    bound_ms, bound_by = bound(2 * pages.numel() * pages.element_size(), 0)
    out = {}

    def exact(a, b, what):
        check(torch.equal(a, b), f"{what}: kernel differs from its plain version")
        return (a.float() - b.float()).abs().max().item()

    for head_major in (False, True):
        got = bc.gather_pages(pool, idx, head_major=head_major)
        torch.cuda.synchronize()
        want = bc.gather_pages_ref(pool, idx, head_major=head_major)
        buf = torch.empty_like(got)
        rec = {
            "max_abs_err": exact(got, want, f"gather head_major={head_major}"),
            "ms": cuda_ms(lambda: bc._launch_gather(pool, idx, buf, head_major)),
            "wrapper_ms": cuda_ms(lambda: bc.gather_pages(pool, idx,
                                                          head_major=head_major)),
            "plain_ms": cuda_ms(lambda: bc.gather_pages_ref(pool, idx,
                                                            head_major=head_major)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        if head_major:
            rec["library_ms"] = cuda_ms(lambda: pool.index_select(1, idx_l)
                                        .transpose(2, 3).contiguous())
            out["gather_pages"]["cases"] = {"head_major": rec}
        else:
            rec["library_ms"] = cuda_ms(lambda: pool.index_select(1, idx_l))
            out["gather_pages"] = rec
    del got, want, buf

    a, b = pool.clone(), pool.clone()
    bc.scatter_pages(a, idx, pages)
    torch.cuda.synchronize()
    bc.scatter_pages_ref(b, idx, pages)
    out["scatter_pages"] = {
        "max_abs_err": exact(a, b, "scatter"),
        "ms": cuda_ms(lambda: bc._launch_scatter(a, idx, pages)),
        "wrapper_ms": cuda_ms(lambda: bc.scatter_pages(a, idx, pages)),
        "plain_ms": cuda_ms(lambda: bc.scatter_pages_ref(a, idx, pages)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cuda_ms(lambda: a.index_copy_(1, idx_l, pages)),
    }
    dup = idx.clone()
    dup[1] = dup[0]
    try:
        bc.scatter_pages(a, dup, pages)
        check(False, "scatter accepted repeated page ids")
    except ValueError:
        pass
    del a

    # the streamed onboard of one pool: 4 layer groups, 4 launches
    c = pool.clone()
    groups = [(g * L // COPY_GROUPS, (g + 1) * L // COPY_GROUPS)
              for g in range(COPY_GROUPS)]
    offs = torch.tensor([lo for lo, _ in groups], dtype=torch.int32, device=dev)
    slabs = [pages[lo:hi] for lo, hi in groups]

    def layered(fn):
        def run():
            for g in range(COPY_GROUPS):
                fn(c, idx, slabs[g], offs[g:g + 1])
        return run

    layered(bc.scatter_pages_layers)()
    torch.cuda.synchronize()
    out["scatter_pages_layers"] = {
        "groups": groups,
        "max_abs_err": exact(c, b, "layer scatter vs whole-pool scatter"),
        "ms": cuda_ms(layered(bc._launch_scatter)),
        "wrapper_ms": cuda_ms(layered(bc.scatter_pages_layers)),
        "plain_ms": cuda_ms(layered(bc.scatter_pages_layers_ref)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cuda_ms(lambda: [
            c[lo:hi].index_copy_(1, idx_l, slab)
            for (lo, hi), slab in zip(groups, slabs)]),
    }
    # the KV tiers' shapes as graph replays of the launches alone:
    # an offload's 1-page gather and a 64-page onboard in 4 layer groups
    page_bytes = L * PS * Hk * D * pool.element_size()
    one = idx[:1].contiguous()
    one_l = one.long()
    buf1 = torch.empty((L, 1, PS, Hk, D), dtype=pool.dtype, device=dev)
    out["gather_pages"]["cases"]["offload_1_page"] = {
        "device_ms": graph_ms(lambda: bc._launch_gather(pool, one, buf1, False)),
        "library_device_ms": graph_ms(
            lambda: torch.index_select(pool, 1, one_l, out=buf1)),
        "bound_ms": bound(2 * page_bytes, 0)[0], "bound_by": "bytes"}
    # a prefetch promotion: one page into every layer
    page1 = pages[:, :1].contiguous()
    e = pool.clone()
    out["scatter_pages"]["cases"] = {"promote_1_page": {
        "device_ms": graph_ms(lambda: bc._launch_scatter(e, one, page1)),
        "library_device_ms": graph_ms(lambda: e.index_copy_(1, one_l, page1)),
        "bound_ms": bound(2 * page_bytes, 0)[0], "bound_by": "bytes"}}
    idx64 = idx[:TIER_ONBOARD_PAGES].contiguous()
    idx64_l = idx64.long()
    slabs64 = [pages[lo:hi, :TIER_ONBOARD_PAGES].contiguous() for lo, hi in groups]
    d = pool.clone()

    def onboard64(fn):
        def run():
            for g in range(COPY_GROUPS):
                fn(d, idx64, slabs64[g], offs[g:g + 1])
        return run

    onboard64(bc.scatter_pages_layers)()
    torch.cuda.synchronize()
    want64 = pool.clone()
    want64.index_copy_(1, idx64_l, torch.cat(slabs64, dim=0))
    out["scatter_pages_layers"]["cases"] = {"onboard_64_pages_4_groups": {
        "max_abs_err": exact(d, want64, "64-page layer scatter"),
        "device_ms": graph_ms(onboard64(bc._launch_scatter)),
        "library_device_ms": graph_ms(lambda: [
            d[lo:hi].index_copy_(1, idx64_l, slab)
            for (lo, hi), slab in zip(groups, slabs64)]),
        "bound_ms": bound(2 * TIER_ONBOARD_PAGES * page_bytes, 0)[0],
        "bound_by": "bytes"}}
    del b, c, d, e, want64, slabs64, pool, pages
    torch.cuda.empty_cache()
    emit({"phase": "copy_kernels", "tol": 0.0,
          "shape": {"L": L, "NP": NP, "PS": PS, "Hk": Hk, "D": D, "n": COPY_N,
                    "dtype": "bfloat16"}, **out})
    return out


def tier_codec_phase(dev):
    """The device tier codec at engine_tiers' onboard: the 3B's 64 pages
    page-major, [64, 28, 16, 8, 128] bf16, vectors whose scales spread
    over six decades with a zero vector, against the plain codec on the
    CPU bit for bit (codes, scales, dequantized bytes); timed back to
    back and as graph replays, beside the plain codec on the card (there
    a division by a Python scalar is a product with its reciprocal, so it
    is timed, not held) and the byte bound."""
    L, _, PS, Hk, D = COPY_SHAPE
    shape = (TIER_ONBOARD_PAGES, L, PS, Hk, D)
    cgen = torch.Generator(device="cpu").manual_seed(21)
    spread = torch.pow(10.0, torch.rand(shape[:-1] + (1,), generator=cgen) * 6 - 3)
    x = (torch.randn(shape, generator=cgen) * spread).bfloat16()
    x[0, 0, 0] = 0
    xd = x.to(dev)
    q, sc = tc.tier_quantize(xd)
    back = tc.tier_dequantize(q, sc, torch.bfloat16)
    torch.cuda.synchronize()
    qr, sr = tc.tier_quantize_ref(x)
    backr = tc.tier_dequantize_ref(qr, sr, torch.bfloat16)
    check(torch.equal(q.cpu(), qr)
          and torch.equal(sc.cpu().view(torch.int32), sr.view(torch.int32)),
          "tier_quantize differs from the plain codec")
    check(torch.equal(back.cpu().view(torch.int16), backr.view(torch.int16)),
          "tier_dequantize differs from the plain codec")
    n = x.numel()
    rows = n // D
    moved = n * 2 + n + rows * 4  # bf16 vectors, int8 codes, f32 scales
    out = {
        "tier_quantize": {
            "shape": list(shape),
            "max_abs_err": max((q.cpu().float() - qr.float()).abs().max().item(),
                               (sc.cpu() - sr).abs().max().item()),
            "ms": cuda_ms(lambda: tc.tier_quantize(xd)),
            "device_ms": graph_ms(lambda: tc.tier_quantize(xd)),
            "plain_ms": cuda_ms(lambda: tc.tier_quantize_ref(xd)),
            "bound_ms": bound(moved, 0)[0], "bound_by": "bytes", "library_ms": None},
        "tier_dequantize": {
            "shape": list(shape),
            "max_abs_err": (back.cpu().float() - backr.float()).abs().max().item(),
            "ms": cuda_ms(lambda: tc.tier_dequantize(q, sc, torch.bfloat16)),
            "device_ms": graph_ms(lambda: tc.tier_dequantize(q, sc, torch.bfloat16)),
            "plain_ms": cuda_ms(lambda: tc.tier_dequantize_ref(q, sc, torch.bfloat16)),
            "bound_ms": bound(moved, 0)[0], "bound_by": "bytes", "library_ms": None},
    }
    del x, xd, q, sc, back
    torch.cuda.empty_cache()
    emit({"phase": "tier_codec_kernels", "tol": 0.0, **out})
    return out


# the MLA kernels at DeepSeek-V3's shapes
MLA_H, MLA_DC, MLA_DR, MLA_PS = 128, 512, 64, 16
MLA_DECODE_KV = [4096, 0, 1, 17, 1000, 2048, 3333, 513]
MLA_PACKED = [(256, 0), (130, 500), (0, 0), (77, 1500)]  # (q_len, prior)
# the timed prefill: S 512, q_len 450 over 700 prior tokens
MLA_TIMED_S, MLA_TIMED_SEG = 512, (450, 700)
# name: (PS, H, S, segments (q_len, prior[, kv_len past the chunk]))
MLA_PREFILL_CASES = {
    "packed": (MLA_PS, MLA_H, 256, MLA_PACKED),
    "PS8_H16": (8, 16, 200, [(200, 37), (1, 0), (0, 0)]),
    "PS32_H32": (32, 32, 200, [(64, 900), (33, 5)]),
    "S203": (MLA_PS, MLA_H, 203, [(203, 100), (150, 0)]),
    "short_chunk_long_prior": (MLA_PS, MLA_H, 8, [(5, 3000)]),
    "kv_past_chunk": (MLA_PS, MLA_H, 64, [(64, 300, 3), (40, 0, 3)]),
    "q_start_37": (MLA_PS, MLA_H, 128, [(128, 37), (100, 37)]),
}


def mla_rnd(gen, dev):
    return lambda *shape: torch.randn(*shape, generator=gen).bfloat16().to(dev)


def mla_decode_args(gen, dev, kv=MLA_DECODE_KV, PS=MLA_PS):
    """(q, lat, page_table, kv_lens): rows of kv tokens (MLA_DECODE_KV) at
    DeepSeek-V3's shapes, a 4096-token table a row."""
    rnd = mla_rnd(gen, dev)
    B, MP = len(kv), -(-4096 // PS)
    NP = B * MP + 1
    lat = rnd(NP, PS, 1, MLA_DC + MLA_DR)
    q = rnd(B, MLA_H, MLA_DC + MLA_DR)
    pt = random_pages(gen, B, MP, NP, dev)
    return q, lat, pt, torch.tensor(kv, dtype=torch.int32, device=dev)


def mla_prefill_args(gen, PS, H, S, segs, dev):
    """(q, lat, page_table, q_start, q_len, kv_lens) for segments (q_len,
    prior[, kv_len past the chunk]) over a shared pool, one table page past
    the longest row."""
    rnd = mla_rnd(gen, dev)
    B = len(segs)
    kv = [n + p + sum(x) for n, p, *x in segs]
    MP = max(-(-k // PS) for k in kv) + 1
    NP = B * MP + 1
    lat = rnd(NP, PS, 1, MLA_DC + MLA_DR)
    pt = random_pages(gen, B, MP, NP, dev)
    ints = [torch.tensor(x, dtype=torch.int32, device=dev)
            for x in ([p for _, p, *_ in segs], [n for n, *_ in segs], kv)]
    return (rnd(B, S, H, MLA_DC + MLA_DR), lat, pt, *ints)


def ulps_err(got, want, q_len):
    """A prefill output against a reference over the valid rows: (max abs
    err, max err in bf16 ulps of the reference's value, values under 1/8
    counted at 1/8's ulp)."""
    errs = []
    for b, n in enumerate(q_len):
        if n > 0:
            w = want[b, :n].float()
            ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=0.125))) - 7)
            d = (got[b, :n].float() - w).abs()
            errs.append((d.max().item(), (d / ulp).max().item()))
    return max(e for e, _ in errs), max(u for _, u in errs)


def mla_library(q, dense, mask, dc, scale):
    """One PyTorch call for the same function over the latent gathered
    dense beforehand: q [B, H, n, Dl], dense [B, C, Dl], mask [B, 1, n, C].
    SDPA with K = the latent (one head shared by all) and V = its first dc
    columns, on the first fused backend that takes it; where every one
    refuses (Dk != Dv, Dk 576), a matmul-softmax-matmul. Returns (fn,
    backend name)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    k = dense[:, None]
    v = dense[:, None, :, :dc]
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        def run(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)
        try:
            with warnings.catch_warnings():  # each refusal warns its reason
                warnings.simplefilter("ignore", UserWarning)
                run()
            torch.cuda.synchronize()
            return run, f"sdpa_{backend.name.lower()}"
        except (RuntimeError, TypeError):
            continue
    B, H, n, Dl = q.shape
    qf = q.reshape(B, H * n, Dl)
    maskf = mask.expand(B, H, n, -1).reshape(B, H * n, -1)
    lat_t = dense.transpose(1, 2)
    val = dense[..., :dc]

    def mm():
        s = torch.bmm(qf, lat_t).float() * scale
        p = torch.softmax(s.masked_fill(~maskf, float("-inf")), -1)
        return torch.bmm(p.to(q.dtype), val)
    return mm, "matmul_softmax_matmul"


def mla_kernel_phase(dev):
    """Both MLA kernels against their plain versions at DeepSeek-V3's
    shapes, timed with their bound and the library yardstick; a packed
    prefill batch with an all-padding row; other page sizes and head
    counts, untimed."""
    gen = torch.Generator(device="cpu").manual_seed(6)
    H, dc, dr, PS = MLA_H, MLA_DC, MLA_DR, MLA_PS
    Dl = dc + dr
    scale = attn_score_scale(MLA_CONFIG, MLA_CONFIG.qk_nope_head_dim + dr)
    results = {}

    rnd = mla_rnd(gen, dev)

    # decode: B 8, kv_len up to 4096, one empty row
    kv_list = MLA_DECODE_KV
    args = mla_decode_args(gen, dev)
    q, lat, pt, kvl = args
    B, MP = len(kv_list), pt.shape[1]
    out = decode_mla_attention(*args, dc=dc, scale=scale)
    torch.cuda.synchronize()
    ref = decode_mla_attention_ref(*args, dc=dc, scale=scale)
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), "MLA decode output not finite")
    check(out[1].float().abs().max().item() == 0.0, "MLA decode kv_len=0 row is not 0")
    check(err <= KERNEL_TOL, f"MLA decode max abs err {err} > {KERNEL_TOL}")
    # what the data needs: q read, out written, each visible latent row
    # once, the table entries of the visible pages, kv_lens; one score
    # (Dl wide) and one PV product (dc wide) per (head, context token)
    n_tok = sum(kv_list)
    n_bytes = (q.numel() * 2 + B * H * dc * 2 + n_tok * Dl * 2
               + sum(-(-k // PS) for k in kv_list) * 4 + B * 4)
    bound_ms, bound_by = bound(n_bytes, 2 * n_tok * H * (Dl + dc))
    dense = lat[pt.long()].reshape(B, MP * PS, Dl)
    mask = (torch.arange(MP * PS, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    lib_fn, lib_name = mla_library(q[:, :, None], dense, mask, dc, scale)
    results["decode_mla_attention"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: decode_mla_attention(*args, dc=dc, scale=scale)),
        "plain_ms": cuda_ms(lambda: decode_mla_attention_ref(*args, dc=dc, scale=scale)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cuda_ms(lib_fn), "library": lib_name,
        "device_ms": graph_ms(lambda: decode_mla_attention(*args, dc=dc, scale=scale)),
        "library_device_ms": graph_ms(lib_fn),
        "shape": {"B": B, "H": H, "dc": dc, "dr": dr, "PS": PS, "kv_lens": kv_list},
    }
    del lat, dense, args

    # prefill: S 512, q_len 450 over 700 prior tokens (padding rows after)
    S, (q_len, prior) = MLA_TIMED_S, MLA_TIMED_SEG
    kv = prior + q_len
    MP = -(-kv // PS) + 2  # table tail past kv_len: other pages
    lat = rnd(MP + 1, PS, 1, Dl)
    q = rnd(1, S, H, Dl)
    pt = random_pages(gen, 1, MP, MP + 1, dev)
    ints = [torch.tensor([x], dtype=torch.int32, device=dev) for x in (prior, q_len, kv)]
    args = (q, lat, pt, *ints)
    out = prefill_mla_attention(*args, dc=dc, scale=scale)
    torch.cuda.synchronize()
    ref = prefill_mla_attention_ref(*args, dc=dc, scale=scale)
    err = (out[:, :q_len].float() - ref[:, :q_len].float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), "MLA prefill output not finite")
    check(out[:, q_len:].float().abs().max().item() == 0.0,
          "MLA prefill padding rows are not 0")
    check(err <= KERNEL_TOL, f"MLA prefill max abs err {err} > {KERNEL_TOL}")
    want_t, _ = prefill_mla_tiles_ref(*args, dc=dc, scale=scale)
    err_t, ulps_t = ulps_err(out, want_t, [q_len])
    check(ulps_t <= TILES_ULPS, f"MLA prefill vs its tiles ref: {ulps_t} ulps > "
          f"{TILES_ULPS} (max abs err {err_t})")
    n_pairs = sum(min(prior + s + 1, kv) for s in range(q_len))
    n_bytes = (q_len * H * Dl * 2 + S * H * dc * 2 + kv * Dl * 2
               + (-(-kv // PS)) * 4 + 3 * 4)
    bound_ms, bound_by = bound(n_bytes, 2 * n_pairs * H * (Dl + dc))
    dense = lat[pt.long()].reshape(1, MP * PS, Dl)
    s_pos = prior + torch.arange(q_len, device=dev)
    c_pos = torch.arange(MP * PS, device=dev)
    mask = ((c_pos[None, :] <= s_pos[:, None]) & (c_pos[None, :] < kv))[None, None]
    q_heads = q[:, :q_len].permute(0, 2, 1, 3).contiguous()  # [1, H, n, Dl]
    lib_fn, lib_name = mla_library(q_heads, dense, mask, dc, scale)
    results["prefill_mla_attention"] = {
        "max_abs_err": err, "tiles_max_abs_err": err_t, "tiles_max_ulps": ulps_t,
        "plain_tiles_max_ulps": ulps_err(ref, want_t, [q_len])[1],
        "ms": cuda_ms(lambda: prefill_mla_attention(*args, dc=dc, scale=scale)),
        "plain_ms": cuda_ms(lambda: prefill_mla_attention_ref(*args, dc=dc, scale=scale),
                            iters=5),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cuda_ms(lib_fn), "library": lib_name,
        "device_ms": graph_ms(lambda: prefill_mla_attention(*args, dc=dc, scale=scale)),
        "library_device_ms": graph_ms(lib_fn),
        "shape": {"S": S, "q_len": q_len, "prior": prior, "H": H, "dc": dc,
                  "dr": dr, "PS": PS},
    }
    del lat, dense, args, q_heads, want_t

    # a packed [4, 256] prefill batch (the padded fallback's shape) with an
    # all-padding row, other page sizes and head counts, then the causal
    # edges at DeepSeek-V3's shapes: S not a multiple of the block's 4
    # tokens, a short chunk over a long prior (timed: few blocks, long
    # walks), kv_len past the chunk, q_start off the 32-token tile
    cases = {}
    for name, (PSx, Hx, Sx, segs) in MLA_PREFILL_CASES.items():
        Bx = len(segs)
        ql = [n for n, *_ in segs]
        kvx = [n + p + sum(x) for n, p, *x in segs]
        pargs = mla_prefill_args(gen, PSx, Hx, Sx, segs, dev)
        lat = pargs[1]
        got = prefill_mla_attention(*pargs, dc=dc, scale=scale)
        dargs = (rnd(Bx, Hx, Dl), lat, pargs[2], pargs[5])
        got_d = decode_mla_attention(*dargs, dc=dc, scale=scale)
        torch.cuda.synchronize()
        want = prefill_mla_attention_ref(*pargs, dc=dc, scale=scale)
        want_d = decode_mla_attention_ref(*dargs, dc=dc, scale=scale)
        check(torch.isfinite(got.float()).all().item(), f"MLA prefill not finite ({name})")
        pad_zero = all(got[b, n:].float().abs().max().item() == 0.0
                       for b, n in enumerate(ql) if n < Sx)
        check(pad_zero, f"MLA prefill padding rows are not 0 ({name})")
        e_p = max((got[b, :n].float() - want[b, :n].float()).abs().max().item()
                  for b, n in enumerate(ql) if n > 0)
        e_d = (got_d.float() - want_d.float()).abs().max().item()
        check(max(e_p, e_d) <= KERNEL_TOL,
              f"MLA kernels at {name}: prefill {e_p}, decode {e_d}")
        want_t, _ = prefill_mla_tiles_ref(*pargs, dc=dc, scale=scale)
        e_t, u_t = ulps_err(got, want_t, ql)
        check(u_t <= TILES_ULPS, f"MLA prefill vs its tiles ref at {name}: {u_t} ulps > "
              f"{TILES_ULPS} (max abs err {e_t})")
        cases[name] = {"segments": segs, "S": Sx, "PS": PSx, "H": Hx,
                       "prefill_max_abs_err": e_p, "prefill_tiles_max_abs_err": e_t, "prefill_tiles_max_ulps": u_t,
                       "plain_tiles_max_ulps": ulps_err(want, want_t, ql)[1],
                       "decode_max_abs_err": e_d}
        if name == "short_chunk_long_prior":
            n_pairs = sum(min(p + s + 1, k) for (n, p, *_), k in zip(segs, kvx)
                          for s in range(n))
            n_bytes = (sum(ql) * Hx * Dl * 2 + Bx * Sx * Hx * dc * 2 + sum(kvx) * Dl * 2
                       + sum(-(-k // PSx) for k in kvx) * 4 + 3 * Bx * 4)
            cases[name]["bound_ms"], cases[name]["bound_by"] = bound(
                n_bytes, 2 * n_pairs * Hx * (Dl + dc))
            cases[name]["device_ms"] = graph_ms(
                lambda: prefill_mla_attention(*pargs, dc=dc, scale=scale))
        del lat, pargs, dargs, want_t
    results["prefill_mla_attention"]["cases"] = cases
    torch.cuda.empty_cache()
    emit({"phase": "mla_kernels", "tol": KERNEL_TOL, "tiles_ulps": TILES_ULPS, **results})
    return results


async def _serve(engine, reqs, shared_idx, late_req):
    """Serve `reqs` concurrently; `late_req` (sharing a prefix with
    reqs[shared_idx]) is sent once that request has its first token, so
    its prefix pages are registered and it hits the prefix cache."""
    first_token = asyncio.Event()

    async def collect(i, req):
        toks, finish, phases = [], None, {}
        async for item in engine.generate(req, Context(request_id=f"r{i}")):
            toks.extend(item["token_ids"])
            if item["token_ids"] and i == shared_idx:
                first_token.set()
            if item.get("finish_reason"):
                finish = item["finish_reason"]
                phases = item.get("phases") or {}
                if finish == "error":
                    raise CheckFailed(f"request r{i} finished with error")
        return toks, finish, phases

    tasks = [asyncio.create_task(collect(i, r)) for i, r in enumerate(reqs)]
    await first_token.wait()
    tasks.append(asyncio.create_task(collect(len(reqs), late_req)))
    return await asyncio.gather(*tasks)


N_OUT = 32  # output tokens per request


def workload(vocab_size: int, seed: int, extra=()):
    """8 requests from a seed: prompts of 17 to 1500 tokens (the long ones
    run chunked prefill over prior context, chunk 512), mostly greedy, two
    sampled (temperature 0.8, top_p 0.9, seeded); the last request shares
    a 256-token prefix with the one before it. `extra` adds greedy
    requests with prompts of those lengths (drawn after the others, so the
    eight stay the same), before the one the last shares its prefix with.
    Returns (all but the last, last)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def prompt(n):
        return torch.randint(0, vocab_size, (n,), generator=gen).tolist()

    def req(p, i):
        samp = {"temperature": 0.0}
        if i in (2, 5):
            samp = {"temperature": 0.8, "top_p": 0.9, "seed": 1000 + i}
        return {"token_ids": p, "sampling": samp,
                "stop": {"max_tokens": N_OUT, "stop_ids": []}}

    shared = prompt(256)
    prompts = [prompt(n) for n in (17, 64, 300, 700, 1100, 1500)]
    prompts.append(shared + prompt(150))
    late = shared + prompt(400)
    prompts[-1:-1] = [prompt(n) for n in extra]
    return [req(p, i) for i, p in enumerate(prompts)], req(late, len(prompts))


def spec_workload(vocab_size: int, seed: int):
    """workload()'s shape (8 requests, the last sharing a 256-token prefix
    with the one before it), all greedy, with prompts that repeat n-grams:
    each is a 12 to 40-token motif repeated, so n-gram drafts find
    matches. Returns (first 7, last)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def prompt(n, motif):
        m = torch.randint(0, vocab_size, (motif,), generator=gen).tolist()
        return (m * (n // motif + 1))[:n]

    def req(p):
        return {"token_ids": p, "sampling": {"temperature": 0.0},
                "stop": {"max_tokens": N_OUT, "stop_ids": []}}

    shared = prompt(256, 32)
    prompts = [prompt(n, m) for n, m in ((17, 12), (64, 16), (300, 20),
                                          (700, 24), (1100, 28), (1500, 40))]
    prompts.append(shared + prompt(150, 30))
    late = shared + prompt(400, 36)
    return [req(p) for p in prompts], req(late)


def serve(engine, seed: int, spec: bool = False, extra=(), adapters=None):
    """Serve workload(seed, extra) (spec_workload with spec) to
    completion, at most 900 s; `adapters` names request i's LoRA adapter
    (None: the base model), the late request's last."""
    V = engine.runner.config.vocab_size
    reqs, late = spec_workload(V, seed) if spec else workload(V, seed, extra)
    for r, ad in zip(reqs + [late], adapters or ()):
        if ad:
            r["adapter"] = ad
    prompts = [r["token_ids"] for r in reqs + [late]]
    return prompts, asyncio.run(asyncio.wait_for(
        _serve(engine, reqs, len(reqs) - 1, late), 900))


def check_launches(phase: str, launches, stats, L: int, mla: bool = False,
                   int8: bool = False, moe_layers: int = 0,
                   copies: bool = False, quant_per_pass: int = 0,
                   draft_L: int = 0) -> None:
    """Each kernel launched once per layer of each forward pass of its
    kind, and nowhere else (an MLA model launches no GQA kernel and the
    other way round; an int8 latent's prefill gathers, as the reference's
    does, and launches no MLA prefill kernel); each grouped-GEMM entry
    once per MoE layer (runner.moe_layers) of every pass, and never for a
    dense model; the weight-only GEMM `quant_per_pass` times a pass (its
    quantized matrices: quant_launches_per_pass), never over bf16
    weights. A draft model (`draft_L` layers) adds its S = 1 steps to the
    decode kernel and its prefill chunks to the prefill kernel; the
    target's verify passes (S = gamma + 1) run the prefill kernel."""
    prefill = stats["prefill_chunks"] + stats["padded_prefill_dispatches"]
    ragged = stats["ragged_mixed_dispatches"] + stats["ragged_verify_dispatches"]
    verify = stats["spec_verify_passes"]
    if mla:
        want = {"prefill_mla_attention": 0 if int8 else prefill * L,
                "decode_mla_attention": stats["decode_steps"] * L}
        want.update({name: 0 for name in GQA_KERNELS})
        check(ragged == 0, f"{phase}: an MLA model ran ragged passes: {stats}")
    else:
        want = {"prefill_paged_attention": (prefill + verify) * L
                + stats["draft_prefill_chunks"] * draft_L,
                "decode_paged_attention": stats["decode_steps"] * L
                + stats["draft_steps"] * draft_L,
                "ragged_paged_attention": ragged * L}
        want.update({name: 0 for name in MLA_KERNELS})
    for name, n in want.items():
        check(launches[name] == n,
              f"{phase}: {name} launches {launches[name]} != {n} ({L} layers, draft "
              f"{draft_L}; {stats})")
    passes = prefill + stats["decode_steps"] + ragged + verify
    for name in MOE_KERNELS:
        check(launches[name] == passes * moe_layers,
              f"{phase}: {name} launches {launches[name]} != {passes} passes x "
              f"{moe_layers} MoE layers")
    check(launches["quant_gemm"] == passes * quant_per_pass,
          f"{phase}: quant_gemm launches {launches['quant_gemm']} != {passes} passes x "
          f"{quant_per_pass} quantized matrices")
    for name in COPY_KERNELS if not copies else ():  # no transfer, no host tier
        check(launches[name] == 0, f"{phase}: {name} launched {launches[name]}")


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0
    for name in GQA_KERNELS + ("decode_mla_attention",) + MOE_KERNELS + ("quant_gemm",):
        KERNELS[name].bodies = {}


def quant_launches_per_pass(runner):
    """The weight-only GEMM's launches a forward pass, by body: each
    quantized matrix of DEFAULT_QUANT_NAMES the pass multiplies by (q, k,
    v, o and, on a dense layer, the three FFN matrices, on a MoE layer the
    shared experts' three; the routed experts ride the grouped GEMM) and
    the head, over the tied embedding in the NK layout. {} without
    --quantize."""
    cfg, mode = runner.config, runner.quantize
    if not mode:
        return {}
    check(not cfg.is_mla, "quant_launches_per_pass: no MLA count")
    moe = runner.moe_layers
    kn = 4 * cfg.n_layers + 3 * (cfg.n_layers - moe) + (3 * moe if cfg.n_shared_experts
                                                          else 0)
    out = {f"kn_{mode}": kn + (0 if cfg.tie_embeddings else 1)}
    if cfg.tie_embeddings:
        out[f"nk_{mode}"] = 1
    return out


def engine_phase(runner, phase: str, fused: bool = None, spec: bool = False,
                 build_s: float = None, base_args=ENGINE_ARGS, extra=(),
                 engine_kw=None, probe=None, adapters=None):
    """Serve the workload on a fresh engine over `runner`, with every
    launch count and runner.stats set to 0 just before and read just
    after. fused=None keeps the engine's default (fused on a card);
    `extra` adds prompts to the workload; `engine_kw` sets engine
    arguments no flag carries; `probe(engine)` runs before the workload
    (a phase's instrumentation); `adapters` gives the requests' LoRA
    adapters (serve)."""
    args = base_args + (["--spec-ngram", "--spec-k", "4"] if spec else [])
    saved = os.environ.pop("DYN_FUSED_MIXED", None)
    if fused is not None:
        os.environ["DYN_FUSED_MIXED"] = "1" if fused else "0"
    try:
        engine = build_engine(parse_args(args), runner=runner, **(engine_kw or {}))
    finally:
        os.environ.pop("DYN_FUSED_MIXED", None)
        if saved is not None:
            os.environ["DYN_FUSED_MIXED"] = saved
    if probe is not None:
        probe(engine)
    V = runner.config.vocab_size
    L = runner.config.n_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    runner.reset_stats()
    t0 = time.monotonic()
    try:
        prompts, results = serve(engine, seed=1, spec=spec, extra=extra,
                                 adapters=adapters)
    finally:
        engine.stop()
    torch.cuda.synchronize()  # a fault during the run surfaces here
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    bodies = {name: dict(KERNELS[name].bodies)
              for name in GQA_KERNELS + ("decode_mla_attention",)}
    stats = dict(runner.stats)
    for i, (toks, finish, _) in enumerate(results):
        check(finish in ("length", "stop"), f"{phase}: r{i} finished {finish!r}")
        check(finish != "length" or len(toks) == N_OUT,
              f"{phase}: r{i} emitted {len(toks)} tokens, wanted {N_OUT}")
        check(all(0 <= t < V for t in toks),
              f"{phase}: r{i} emitted a token out of range")
    check(stats["prefill_chunks"] > 0
          and stats["decode_steps"] + stats["spec_verify_passes"] > 0,
          f"{phase}: engine ran no prefill or no decode: {stats}")
    per_pass = quant_launches_per_pass(runner)
    check_launches(phase, launches, stats, L, mla=runner.config.is_mla,
                   int8=runner.kv_quantize is not None,
                   moe_layers=runner.moe_layers,
                   quant_per_pass=sum(per_pass.values()),
                   draft_L=runner.draft_config.n_layers if runner.has_draft else 0)
    passes = (stats["prefill_chunks"] + stats["padded_prefill_dispatches"]
              + stats["decode_steps"] + stats["ragged_mixed_dispatches"]
              + stats["ragged_verify_dispatches"] + stats["spec_verify_passes"])
    quant_bodies = dict(qg.quant_matmul.bodies)
    check(quant_bodies == {b: passes * n for b, n in per_pass.items() if n},
          f"{phase}: quant_gemm bodies {quant_bodies}, {passes} passes x {per_pass}")
    reused = engine.scheduler.reused_prefix_tokens
    check(reused >= 256, f"{phase}: late request reused only {reused} prefix tokens")
    ttft = sorted(r[2].get("ttft_s", float("nan")) for r in results)
    decode_rates = sorted(
        (len(r[0]) - 1) / (r[2]["e2e_s"] - r[2]["ttft_s"]) for r in results)
    n_tokens = sum(len(r[0]) for r in results)
    rec = {
        "phase": f"engine_{phase}", "model": runner.config.name,
        "n_layers": L, "fused_mixed": engine.fused_mixed,
        "requests": len(results),
        "prompt_tokens": [len(p) for p in prompts],
        "output_tokens": [len(r[0]) for r in results],
        "finish": [r[1] for r in results],
        "stats": stats, "launches": launches, "bodies": bodies,
        "reused_prefix_tokens": reused,
        "ttft_s_min": ttft[0], "ttft_s_median": ttft[len(ttft) // 2],
        "ttft_s_max": ttft[-1],
        "decode_tok_s_per_request_median": decode_rates[len(decode_rates) // 2],
        "output_tok_s_overall": n_tokens / wall, "wall_s": wall,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "kv_quantize": runner.kv_quantize, "quantize": runner.quantize,
        "quant_gemm_bodies": quant_bodies,
        "moe_bodies": {name: dict(KERNELS[name].bodies) for name in MOE_KERNELS},
    }
    if adapters:
        rec["adapters"] = list(adapters)
    if build_s is not None:
        rec["build_s"] = build_s
    if spec or runner.has_draft:
        rec["spec_stats"] = dict(engine.spec_stats)
        rec["acceptance_rate"] = (engine.spec_stats["accepted"]
                                  / max(1, engine.spec_stats["drafted"]))
    return rec, launches, results


def served_turn(runner, phase, fused, args, expect, extra=(), build_s=None):
    """engine_phase with the checks every model's turn holds: fused plans
    on the ragged kernel (fused=None, the card's default) or no ragged
    launch (fused=False); every request `length` with N_OUT tokens; each
    GQA kernel's launches by body equal to expect(n) for its n launches.
    Returns (rec, launches)."""
    rec, launches, results = engine_phase(runner, phase, fused=fused, build_s=build_s,
                                          base_args=args, extra=extra)
    st = rec["stats"]
    if fused is None:
        check(rec["fused_mixed"], f"{phase}: the engine did not fuse on the card")
        check(all(launches[k] > 0 for k in GQA_KERNELS),
              f"{phase}: a GQA kernel never launched: {launches}")
        check(st["ragged_mixed_dispatches"] > 0 and st["padded_prefill_dispatches"] == 0,
              f"{phase}: mixed plans did not ride the ragged step: {st}")
    else:
        check(not rec["fused_mixed"], f"{phase}: DYN_FUSED_MIXED=0 did not hold")
        check(launches["ragged_paged_attention"] == 0, f"{phase}: the ragged kernel ran")
    for i, (toks, finish, _) in enumerate(results):
        check(finish == "length" and len(toks) == N_OUT,
              f"{phase}: r{i} finished {finish!r} with {len(toks)} tokens")
    for name in GQA_KERNELS:
        b, n = rec["bodies"][name], launches[name]
        check(b == expect(n), f"{phase}: {name} bodies {b} for {n} launches")
    return rec, launches


def one_body(body):
    """served_turn's `expect` for a model whose every launch is on `body`."""
    return lambda n: {body: n} if n else {}


def engine_phases(dev):
    """The fused (main path), unfused and spec phases on one runner."""
    t0 = time.monotonic()
    runner, _ = build_runner(parse_args(ENGINE_ARGS))
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0

    rec, launches, fused = engine_phase(runner, "fused", build_s=build_s)
    fused_bodies = rec["bodies"]
    fused_rec = rec
    st = rec["stats"]
    check(rec["fused_mixed"], "fused: the engine did not fuse on the card")
    check(all(launches[k] > 0 for k in GQA_KERNELS),
          f"fused: a kernel of the main path never launched: {launches}")
    # more chunks than fused dispatches: some plan packed two or more
    check(st["mixed_chunks"] > st["ragged_mixed_dispatches"] > 0,
          f"fused: no fused plan packed 2+ chunks: {st}")
    check(st["padded_prefill_dispatches"] == 0,
          f"fused: the padded fallback ran {st['padded_prefill_dispatches']} times")
    emit(rec)

    rec, _, unfused = engine_phase(runner, "unfused", fused=False)
    check(not rec["fused_mixed"], "unfused: DYN_FUSED_MIXED=0 did not hold")
    check(rec["launches"]["ragged_paged_attention"] == 0,
          "unfused: the ragged kernel ran")
    # information only: bf16 through other kernels may part on near-ties
    greedy = [i for i in range(len(fused)) if i not in (2, 5)]
    same = [fused[i][0] == unfused[i][0] for i in greedy]
    pos = [a == b for i in greedy for a, b in zip(fused[i][0], unfused[i][0])]
    rec["greedy_agreement_with_fused"] = {
        "streams_identical": sum(same), "streams": len(same),
        "token_agreement": sum(pos) / max(1, len(pos))}
    emit(rec)

    rec, _, spec = engine_phase(runner, "spec", spec=True)
    st = rec["stats"]
    check(rec["spec_stats"]["drafted"] > 0 and st["ragged_verify_dispatches"] > 0,
          f"spec: nothing was drafted or verified: {rec['spec_stats']}, {st}")
    check(st["draft_ring_steps"] == 0,
          f"spec: the default drafted from the device ring: {st}")
    emit(rec)
    return runner, launches, fused_bodies, fused_rec, {"fused": fused, "unfused": unfused,
                                                       "spec": spec}


def ring_probe(proposals):
    """engine_phase's probe of the device draft ring: inside the timed
    window it only records each proposal with its row's token list and
    length (check_ring compares them after the window)."""
    def install(engine):
        device_draft = engine._device_draft

        def recorded(seqs):
            out = device_draft(seqs)
            proposals.extend((out[s.request_id], s.tokens, len(s.tokens))
                             for s in seqs)
            return out

        engine._device_draft = recorded
    return install


def check_ring(proposals, k):
    """Each recorded ring proposal against ngram_propose over the history
    the ring held (the last DRAFT_RING_WINDOW tokens: they must be equal)
    and over the whole history (counted; they differ only where the
    window cuts)."""
    ring = {"rows": len(proposals), "window_mismatches": 0, "host_mismatches": 0}
    for draft, tokens, n in proposals:
        hist = tokens[:n]
        ring["window_mismatches"] += draft != ngram_propose(hist[-DRAFT_RING_WINDOW:], k)
        ring["host_mismatches"] += draft != ngram_propose(hist, k)
    return ring


def draft_ring_phase(runner, streams):
    """`engine_draft_ring`: the spec phase's workload with linear drafts
    from the device ring (spec_device_draft) against engine_spec's host
    scan: every ring proposal equals the host scan of the history the ring
    holds (compared after the timed window), and where they all do the two
    runs made the same dispatches, so their streams must be identical."""
    proposals = []
    rec, _, ring_streams = engine_phase(runner, "draft_ring", spec=True,
                                        engine_kw={"spec_device_draft": True},
                                        probe=ring_probe(proposals))
    st = rec["stats"]
    check(st["ragged_verify_dispatches"] > 0,
          f"draft_ring: nothing was verified: {st}")
    ring = check_ring(proposals, 4)
    check(st["draft_ring_steps"] > 0 and ring["rows"] > 0,
          f"draft_ring: the device ring proposed nothing: {ring}, {st}")
    check(ring["window_mismatches"] == 0,
          f"draft_ring: ring proposals differ from the host scan of their window: {ring}")
    rec["ring_proposals"] = ring
    same = [a[0] == b[0] for a, b in zip(ring_streams, streams["spec"])]
    rec["streams_identical_to_host_scan"] = sum(same)
    rec["streams"] = len(same)
    check(all(same), f"draft_ring: ring streams differ from the host scan's: {same}")
    emit(rec)


TREE_BRANCHES = 3


def tree_phase(runner):
    """`engine_tree`: --spec-ngram with spec_branches 3 on the fused engine
    (the spec workload; drafts from the host scan, each extra branch a
    verify row on a forked page table). Holds: branch rows verified on
    the ragged kernel, and every page back in the pool after the run (no
    table holds a page: no fork leaked)."""
    held = {}
    rec, _, _ = engine_phase(runner, "tree", spec=True,
                             engine_kw={"spec_branches": TREE_BRANCHES},
                             probe=lambda e: held.update(engine=e))
    st, sp = rec["stats"], rec["spec_stats"]
    pool = held["engine"].pool
    check(rec["fused_mixed"] and st["ragged_verify_dispatches"] > 0,
          f"tree: the verify did not ride the fused ragged step: {st}")
    check(sp["tree_rows"] > 0, f"tree: no branch row was verified: {sp}")
    check(not pool.ref and pool.n_free == runner.num_pages,
          f"tree: pages held after the run ({len(pool.ref)} referenced, "
          f"{pool.n_free} of {runner.num_pages} free)")
    rec.update(pool_free_after=pool.n_free, forks=pool.forks)
    emit(rec)


# draft-model speculation on the 3B: llama-3.2-1b drafts (the public pair:
# both Llama-3, the 128256-token vocabulary), gamma 4, decode plans of two
# rounds (the engine's default 4 steps would shrink gamma to 3)
DRAFT_MODEL = "llama-3.2-1b"
DRAFT_GAMMA = 4
DRAFT_ENGINE = {"decode_steps": 2 * (DRAFT_GAMMA + 1)}
# the verify pass's shape on the prefill kernel: the 3B's B 8 rows of
# gamma + 1 tokens over its traffic's contexts (the 8 prompts)
VERIFY_CONTEXTS = (17, 64, 300, 700, 1100, 1500, 406, 656)
# drafts a self-draft must have accepted: bf16 near-ties between the
# decode kernel (drafting) and the prefill kernel (verifying) reject a few
SELF_DRAFT_ACCEPT = 0.8


def _draft_turn(runner, phase, draft_args, draft_params, fused_rec):
    """engine_phase on a draft runner over the 3B's params, its draft
    given by `draft_args` (--draft-model PRESET, or --draft-checkpoint
    DIR) or `draft_params`: the launch identities (check_launches, and by
    body: the draft's steps and prefill chunks on its head dim's bodies),
    no fused plan, no ragged launch, a draft prefill per target chunk;
    acceptance, tokens a target pass and the decode rate beside
    engine_fused's reported."""
    args = ENGINE_ARGS + list(draft_args) + ["--spec-gamma", str(DRAFT_GAMMA)]
    t0 = time.monotonic()
    drunner, _ = build_runner(parse_args(args), params=runner.params,
                              draft_params=draft_params)
    torch.cuda.synchronize()
    rec, launches, results = engine_phase(drunner, phase, base_args=args,
                                          build_s=time.monotonic() - t0,
                                          engine_kw=DRAFT_ENGINE)
    st, sp = rec["stats"], rec["spec_stats"]
    L, dL = drunner.config.n_layers, drunner.draft_config.n_layers
    dD, D = f"D{drunner.draft_config.head_dim}", f"D{drunner.config.head_dim}"
    check(not rec["fused_mixed"], f"{phase}: a draft runner's engine fused")
    check(launches["ragged_paged_attention"] == 0, f"{phase}: the ragged kernel ran")
    check(st["spec_verify_passes"] > 0 and st["draft_steps"] > 0,
          f"{phase}: no speculative round ran: {st}")
    check(st["draft_prefill_chunks"] == st["prefill_chunks"],
          f"{phase}: draft prefill chunks != target chunks: {st}")
    want = {}
    for body, n in ((D, st["decode_steps"] * L), (dD, st["draft_steps"] * dL)):
        if n:
            want[body] = want.get(body, 0) + n
    check(rec["bodies"]["decode_paged_attention"] == want,
          f"{phase}: decode bodies {rec['bodies']['decode_paged_attention']} != {want}")
    want = {}
    for body, n in ((D, (st["prefill_chunks"] + st["spec_verify_passes"]) * L),
                    (dD, st["draft_prefill_chunks"] * dL)):
        if n:
            want[body] = want.get(body, 0) + n
    check(rec["bodies"]["prefill_paged_attention"] == want,
          f"{phase}: prefill bodies {rec['bodies']['prefill_paged_attention']} != {want}")
    rec["draft_model"] = drunner.draft_config.name
    rec["gamma"] = DRAFT_GAMMA
    rec["tokens_per_target_pass"] = sp["spec_emitted"] / max(1, sp["verify_rows"])
    rec["decode_tok_s_per_request_median_fused"] = fused_rec[
        "decode_tok_s_per_request_median"]
    return drunner, rec, results


def draft_phases(runner, streams, fused_rec):
    """`engine_draft` (a llama-3.2-1b draft, random weights from seed 1:
    acceptance reported) and `engine_draft_self` (the 3B drafting for
    itself: acceptance gated at SELF_DRAFT_ACCEPT, greedy agreement with
    engine_unfused reported); in engine_draft a sampled request served
    alone twice must stream the same tokens. Each draft runner is freed
    after its phase. Returns engine_draft_self's record."""
    drunner, rec, _ = _draft_turn(runner, "draft", ["--draft-model", DRAFT_MODEL], None,
                                  fused_rec)
    reqs, _ = workload(runner.config.vocab_size, seed=1)
    runs = []
    for turn in range(2):
        engine = build_engine(parse_args(ENGINE_ARGS), runner=drunner, **DRAFT_ENGINE)
        try:
            items = asyncio.run(asyncio.wait_for(
                _items(engine, reqs[2], f"draft_sampled{turn}"), 300))
        finally:
            engine.stop()
        runs.append([t for it in items for t in it["token_ids"]])
    check(runs[0] == runs[1] and len(runs[0]) == N_OUT,
          f"draft: a sampled request streamed differently twice: {runs}")
    rec["sampled_twice_equal"] = True
    emit(rec)
    free(drunner)
    del drunner
    drunner, rec, results = _draft_turn(runner, "draft_self", ["--draft-model", MODEL],
                                        runner.params, fused_rec)
    check(rec["acceptance_rate"] >= SELF_DRAFT_ACCEPT,
          f"draft_self: acceptance {rec['acceptance_rate']} < {SELF_DRAFT_ACCEPT}")
    greedy = [i for i in range(len(results)) if i not in (2, 5)]
    unfused = streams["unfused"]
    pos = [a == b for i in greedy for a, b in zip(results[i][0], unfused[i][0])]
    rec["greedy_agreement_with_unfused"] = {
        "streams_identical": sum(results[i][0] == unfused[i][0] for i in greedy),
        "streams": len(greedy), "token_agreement": sum(pos) / max(1, len(pos))}
    emit(rec)
    drunner.params = None  # the 3B's: not this runner's to free
    drunner.draft_params = None
    free(drunner)
    return rec


# -- checkpoints, fast restart and weight reloads ----------------------------

# Llama-3.2-3B's published config.json fields (meta-llama/Llama-3.2-3B on
# the HF hub) that config_from_hf reads: the derived config must be the
# llama-3.2-3b preset
LLAMA32_3B_HF_CONFIG = {
    "model_type": "llama", "architectures": ["LlamaForCausalLM"],
    "hidden_size": 3072, "num_hidden_layers": 28, "num_attention_heads": 24,
    "num_key_value_heads": 8, "intermediate_size": 8192, "vocab_size": 128256,
    "max_position_embeddings": 131072, "rope_theta": 500000.0,
    "rope_scaling": {"factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    "rms_norm_eps": 1e-05, "tie_word_embeddings": True, "torch_dtype": "bfloat16",
}
# what a reload may add to the device's peak beyond the largest leaf: the
# in-flight request's decode steps (activations, the split scratch)
# between the peak reset and the reload
RELOAD_SLACK_BYTES = 512 << 20
# what a quantized cold load may add to the device beyond its int8 tree:
# one row range in bf16 (a layer's w_gate, 8192 embedding rows: 50 MB)
# and its f32 quantize temporaries (the int8 reload peaks at 478 MB)
QUANT_LOAD_SLACK_BYTES = 1 << 30
RELOAD_ERROR = "weights updated mid-flight; retry"


def _tree_diff(got, want):
    """Flattened keys whose tensors are not bit for bit equal (or absent)."""
    a, b = dict(weights.flatten(got)), dict(weights.flatten(want))
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or not torch.equal(a[k], b[k]))


def write_hf_checkpoint(params, cfg, path: Path):
    """`params` as an HF directory at `path`: config.json (the published
    fields) and two safetensors shards written by the port's writer, the
    matrices transposed back to [out, in] on the card. Returns seconds
    and bytes."""
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(LLAMA32_3B_HF_CONFIG))
    t0 = time.monotonic()
    sd = weights.hf_state_dict(params, cfg)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    names = list(sd)
    bounce = st_io.HostBounce(params["embed"].device)
    for k, part in enumerate((names[:len(names) // 2], names[len(names) // 2:])):
        st_io.save_file({n: sd[n] for n in part},
                        path / f"model-{k + 1:05d}-of-00002.safetensors", bounce=bounce)
        for n in part:
            del sd[n]
    st = bounce.stats
    return {"seconds": time.monotonic() - t0, "transpose_s": t1 - t0,
            "d2h_s": st["d2h_s"], "write_s": st["write_s"], "bytes": st["bytes"],
            "shards": 2}


def checkpoint_phase(runner, fused, fused_rec, draft_self, root: Path, smi):
    """`engine_checkpoint`: the 3B's params (seed 0) written as an HF
    directory, config_from_hf equal to the preset, build_runner(
    --checkpoint DIR) bit for bit equal to them, the 3B's traffic on the
    fused engine over the loaded runner (launch identities; greedy
    streams beside engine_fused's, reported: near-ties may part), the
    cold load's seconds split into file reads, host-to-device copies and
    device transposes; then a self-draft from --draft-checkpoint DIR
    (acceptance gated as engine_draft_self's, reported beside it); then
    the checkpoint loaded under int8 quantization (`--quantize int8`'s
    load): the tree bit for bit quantize_params of the written params,
    the device's peak growing by at most the int8 tree +
    QUANT_LOAD_SLACK_BYTES (the bf16 tree is never whole on the card).
    Returns the checkpoint's path."""
    cfg = runner.config
    ckpt = root / "ckpt"
    write = write_hf_checkpoint(runner.params, cfg, ckpt)
    derived = weights.config_from_hf(str(ckpt), name=cfg.name)
    check(derived == cfg, f"checkpoint: config_from_hf gave {derived}, the preset is {cfg}")
    argv = ENGINE_ARGS + ["--checkpoint", str(ckpt)]
    args = parse_args(argv)
    t0 = time.monotonic()
    crunner, ccfg = build_runner(args)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    check(args._weights_source == "checkpoint" and ccfg == cfg,
          f"checkpoint: weights from {args._weights_source}, config {ccfg}")
    diff = _tree_diff(crunner.params, runner.params)
    check(not diff, f"checkpoint: leaves differ from the written params: {diff}")
    load = dict(args._load_stats)
    load["gb_per_s"] = load["bytes"] / load["seconds"] / 1e9
    load["read_gb_per_s"] = load["bytes"] / max(load["read_s"], 1e-9) / 1e9
    load["h2d_gb_per_s"] = load["bytes"] / max(load["h2d_s"], 1e-9) / 1e9
    rec, launches, results = engine_phase(crunner, "checkpoint", build_s=build_s,
                                          base_args=argv)
    check(rec["fused_mixed"] and all(launches[k] > 0 for k in GQA_KERNELS),
          f"checkpoint: the fused path did not run every kernel: {launches}")
    greedy = [i for i in range(len(results)) if i not in (2, 5)]
    pos = [a == b for i in greedy for a, b in zip(results[i][0], fused[i][0])]
    rec.update({
        "checkpoint_write": write, "cold_load": load, "params_bit_equal": True,
        "config_from_hf_equals_preset": True,
        "greedy_agreement_with_fused": {
            "streams_identical": sum(results[i][0] == fused[i][0] for i in greedy),
            "streams": len(greedy), "token_agreement": sum(pos) / max(1, len(pos))}})
    emit(rec)
    drunner, drec, _ = _draft_turn(crunner, "checkpoint_draft_self",
                                   ["--checkpoint", str(ckpt), "--draft-checkpoint",
                                    str(ckpt)], None, fused_rec)
    check(drunner.draft_config.name == "draft"
          and drunner.draft_config.with_(name=cfg.name) == cfg,
          f"checkpoint_draft_self: draft config {drunner.draft_config}")
    check(drec["acceptance_rate"] >= SELF_DRAFT_ACCEPT,
          f"checkpoint_draft_self: acceptance {drec['acceptance_rate']} < "
          f"{SELF_DRAFT_ACCEPT}")
    drec["engine_draft_self"] = {k: draft_self[k] for k in (
        "acceptance_rate", "tokens_per_target_pass", "decode_tok_s_per_request_median")}
    emit(drec)
    drunner.params = None  # crunner's: freed below
    free(drunner, crunner)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    qstats = {}
    qparams = weights.load_hf_checkpoint(str(ckpt), cfg, runner.device, quantize="int8",
                                         stats=qstats)
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    int8_bytes = weights.param_bytes(cfg, quantize="int8")
    diff = _tree_diff(qparams, quantize_params(runner.params, "int8"))
    check(not diff, f"checkpoint int8: leaves differ from quantize_params: {diff}")
    check(growth <= int8_bytes + QUANT_LOAD_SLACK_BYTES,
          f"checkpoint int8: the peak grew {growth} bytes, the int8 tree is {int8_bytes}")
    emit({"phase": "engine_checkpoint_int8", "model": MODEL, "nvidia_smi": smi,
          "seconds": qstats["seconds"], "read_s": qstats["read_s"],
          "h2d_s": qstats["h2d_s"], "device_s": qstats["device_s"],
          "bytes": qstats["bytes"], "peak_growth_bytes": growth,
          "int8_tree_bytes": int8_bytes, "bf16_tree_bytes": weights.param_bytes(cfg),
          "slack_bytes": QUANT_LOAD_SLACK_BYTES, "params_bit_equal": True})
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    return ckpt


# the worker's log lines that time each step of its start: the weights'
# load by tier, the stage's publish, the snapshot's write, the runner
RESTART_LOG_SECONDS = (
    ("checkpoint_load_s", r"loaded HF checkpoint .* in ([0-9.]+)s"),
    ("stage_copy_s", r"copied the stage to \S+ in ([0-9.]+)s"),
    ("snapshot_load_s", r"loaded the params snapshot in ([0-9.]+)s"),
    ("stage_publish_s", r"staged \d+ arrays .* in ([0-9.]+)s"),
    ("snapshot_write_s", r"wrote the params snapshot in ([0-9.]+)s"),
    ("runner_ready_s", r"runner ready: .* placed in ([0-9.]+)s"),
)


def _log_seconds(log: str, pattern: str):
    """The seconds a worker's log line gives, or None without the line."""
    m = re.search(pattern, log)
    return float(m.group(1)) if m else None


async def _restart_turn(argv, root: Path, tier: str, req):
    """One worker process from spawn to its "worker serving" line, one
    greedy request through a client, SIGTERM: (tokens, seconds to
    serving, exit code, its log)."""
    droot = root / f"discovery_{tier}"
    droot.mkdir()
    log_path = root / f"worker_{tier}.log"
    t0 = time.monotonic()
    proc, _ = await _spawn(["dynamo_tpu_torch.worker", *argv], str(droot), "worker serving",
                           str(log_path))
    serving_s = time.monotonic() - t0
    rt = DistributedRuntime(discovery=FileDiscovery(str(droot), poll_interval=0.05))
    try:
        client = rt.client("dyn/tpu-worker/generate")
        await client.wait_ready(timeout=60)
        out = await _collect_timed(client, req, f"restart_{tier}")
        await client.close()
        proc.send_signal(signal.SIGTERM)
        rc = await asyncio.wait_for(proc.wait(), SERVE_TIMEOUT_S)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
        await rt.shutdown(drain_timeout=1)
    return out, serving_s, rc, log_path.read_text()


def restart_phase(ckpt: Path, root: Path, smi):
    """`engine_restart`: `python -m dynamo_tpu_torch.worker --checkpoint
    DIR --orbax-cache SNAP --shm-weights NAME` three times, one after
    another: cold (reads the checkpoint, publishes the stage, writes the
    snapshot), warm from the shm stage (neither the checkpoint nor the
    snapshot read), and warm from the snapshot after the stage is
    unlinked. Each serves one greedy request, its tokens equal to the
    cold worker's; seconds from spawn to "worker serving" by tier. The
    stage and the snapshot are removed after."""
    name = f"chip{os.getpid()}"
    snap = root / "snapshot"
    argv = ENGINE_ARGS + ["--checkpoint", str(ckpt), "--orbax-cache", str(snap),
                          "--shm-weights", name]
    V = get_config(MODEL).vocab_size
    reqs, _ = workload(V, seed=1)
    req = reqs[3]  # 700 prompt tokens, greedy
    turns = {}
    try:
        for tier in ("checkpoint", "shm", "snapshot"):
            if tier == "snapshot":
                shm_weights.unlink(name)
            out, serving_s, rc, log = asyncio.run(_restart_turn(argv, root, tier, req))
            check(rc == 0, f"restart {tier}: the worker exited {rc}")
            check(out["finish"] == "length" and len(out["tokens"]) == N_OUT,
                  f"restart {tier}: {out['finish']} with {len(out['tokens'])} tokens")
            cold = "loading HF checkpoint" in log
            attached = "fast restart: attached" in log
            from_snap = "fast restart: loading params snapshot" in log
            want = {"checkpoint": (True, False, False), "shm": (False, True, False),
                    "snapshot": (False, False, True)}[tier]
            check((cold, attached, from_snap) == want,
                  f"restart {tier}: log says cold {cold}, attached {attached}, "
                  f"snapshot {from_snap}:\n{log[-3000:]}")
            if tier == "checkpoint":
                check("writing params snapshot" in log and snap.is_dir(),
                      f"restart: the cold worker wrote no snapshot:\n{log[-3000:]}")
                stage = shm_weights.attach(name)
                check(stage is not None, "restart: the cold worker published no stage")
                stage_bytes = stage.nbytes
                stage.close()
            turns[tier] = {"spawn_to_serving_s": serving_s, "ttft_s": out["ttft_s"],
                           "e2e_s": out["e2e_s"], "tokens": out["tokens"],
                           **{k: _log_seconds(log, pat) for k, pat in RESTART_LOG_SECONDS}}
        for tier in ("shm", "snapshot"):
            check(turns[tier]["tokens"] == turns["checkpoint"]["tokens"],
                  f"restart {tier}: tokens differ from the cold worker's")
    finally:
        shm_weights.unlink(name)
        shutil.rmtree(snap, ignore_errors=True)
    emit({"phase": "engine_restart", "model": MODEL, "nvidia_smi": smi,
          "prompt_tokens": len(req["token_ids"]), "stage_bytes": stage_bytes,
          **{f"{t}_{k}": v for t, r in turns.items() for k, v in r.items()
             if k != "tokens" and v is not None},
          "tokens_equal": True})


async def _reload_drive(engine, args, snap1, a, fillers):
    """The reload's traffic on a served engine: A and two fillers (their
    evictions offloaded to G2), a request in flight, then over the
    request plane rl pause, update_weights, resume."""
    rt_w, rt_c = _runtime("reload", "tcp"), _runtime("reload", "tcp")
    w = await serve_args(rt_w, engine, args)
    try:
        rl = rt_c.client("dyn/tpu-worker/rl")
        await rl.wait_ready(timeout=60)

        async def call(req):
            return [item async for item in rl.generate(req, Context())][0]

        for i, p in enumerate([a] + fillers):
            await _collect_timed(engine, _tier_req(p), f"fill{i}")
        torch.cuda.synchronize()
        gathers = KERNELS["gather_pages"].launches
        host_blocks = len(engine.host_pool.host)
        cached = len(engine.pool.by_hash)
        items, first = [], asyncio.Event()

        async def inflight():
            req = dict(_tier_req(a[:300]), stop={"max_tokens": 1024, "stop_ids": []})
            async for item in engine.generate(req, Context(request_id="inflight")):
                items.append(item)
                if item["token_ids"]:
                    first.set()

        task = asyncio.create_task(inflight())
        await first.wait()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        paused = await call({"op": "pause"})
        t1 = time.monotonic()
        reply = await call({"op": "update_weights", "orbax": str(snap1)})
        t2 = time.monotonic()
        resumed = await call({"op": "resume"})
        t3 = time.monotonic()
        await asyncio.wait_for(task, 60)
        peak = torch.cuda.max_memory_allocated() - base
        describe = await call({})
        left = (len(engine.pool.by_hash), len(engine.host_pool.host))
        # a prompt served before the reload: nothing of it is reused
        reused = engine.scheduler.reused_prefix_tokens
        again = await _collect_timed(engine, _tier_req(a), "again")
        reused = engine.scheduler.reused_prefix_tokens - reused
    finally:
        await rt_c.shutdown(drain_timeout=1)
        await rt_w.shutdown(drain_timeout=1)
        await w.stop()
    return {"gathers": gathers, "host_blocks": host_blocks, "cached_blocks": cached,
            "items": items, "paused": paused, "reply": reply, "resumed": resumed,
            "describe": describe, "reload_s": t2 - t1, "paused_window_s": t3 - t0,
            "peak_growth_bytes": peak, "left_after": left, "again": again,
            "reused_after": reused}


def reload_phase(root: Path, smi):
    """`engine_reload`: seed-1 params as a snapshot; a 3B engine with a
    G2 tier (TIER_ARGS, 512 host blocks) on seed-0 weights, offloads to
    G2 counted by gather_pages launches, a request in flight, then rl
    pause / update_weights / resume over the request plane. Gates: the
    in-flight request ends with the reference's error item,
    weights_version 1, the params bit for bit the seed-1 tree, the
    prefix cache and the host tier empty, a repeated prompt reusing 0
    prefix tokens, the device's peak during the reload at most the
    largest leaf + RELOAD_SLACK_BYTES over what was allocated. Then a
    --quantize int8 runner reloads the same snapshot: codes and scales
    bit for bit quantize_params of the seed-1 tree."""
    from dynamo_tpu_torch.models import llama

    cfg = get_config(MODEL)
    dev = torch.device("cuda", 0)
    p1 = llama.init_params(cfg, 1, torch.bfloat16, dev)
    largest = max(t.numel() * t.element_size() for _, t in weights.flatten(p1))
    snap1 = root / "seed1"
    t0 = time.monotonic()
    weights.save_snapshot(p1, str(snap1), cfg)
    snapshot_write_s = time.monotonic() - t0
    args = parse_args(TIER_ARGS + TIER_HOST)
    runner, _ = build_runner(args)
    engine = build_engine(args, runner=runner)
    a, fillers, _, _ = _tier_prompts(cfg.vocab_size)
    reset_launches()
    runner.reset_stats()
    try:
        d = _run(_reload_drive(engine, args, snap1, a, fillers))
        check(d["gathers"] > 0 and d["host_blocks"] > 0,
              f"reload: nothing was offloaded to G2 before the reload: {d['gathers']} "
              f"gathers, {d['host_blocks']} host blocks")
        last = d["items"][-1]
        check(last.get("finish_reason") == "error" and last.get("error") == RELOAD_ERROR
              and last.get("token_ids") == [],
              f"reload: the in-flight request ended with {last}")
        check(d["reply"].get("weights_version") == 1 and d["describe"]["weights_version"] == 1
              and d["paused"]["paused"] and not d["resumed"]["paused"],
              f"reload: rl replies {d['paused']}, {d['reply']}, {d['resumed']}")
        diff = _tree_diff(runner.params, p1)
        check(not diff, f"reload: leaves differ from the seed-1 tree: {diff}")
        check(d["left_after"] == (0, 0),
              f"reload: (cached blocks, host blocks) {d['left_after']} after the flush")
        check(d["peak_growth_bytes"] <= largest + RELOAD_SLACK_BYTES,
              f"reload: the peak grew {d['peak_growth_bytes']} bytes, the largest leaf "
              f"is {largest}")
        again = d["again"]
        check(d["reused_after"] == 0 and again["finish"] == "length"
              and len(again["tokens"]) == N_OUT,
              f"reload: a repeated prompt reused {d['reused_after']} prefix tokens, "
              f"finished {again['finish']}")
    finally:
        engine.stop()
    rec = {"phase": "engine_reload", "model": MODEL, "nvidia_smi": smi,
           "snapshot_write_s": snapshot_write_s, "snapshot_bytes": weights.param_bytes(cfg),
           "largest_leaf_bytes": largest, "slack_bytes": RELOAD_SLACK_BYTES,
           **{k: d[k] for k in ("gathers", "host_blocks", "cached_blocks", "reload_s",
                                "paused_window_s", "peak_growth_bytes")},
           "weights_version": d["reply"]["weights_version"],
           "inflight_tokens_before_error": sum(len(it["token_ids"]) for it in d["items"])}
    free(runner)
    del runner, engine
    # the same snapshot into an int8 runner: requantized in place
    qrunner, _ = build_runner(parse_args(TIER_ARGS + ["--quantize", "int8"]))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    qrunner.reload_params(str(snap1))
    rec["int8_reload_s"] = time.monotonic() - t0
    rec["int8_peak_growth_bytes"] = torch.cuda.max_memory_allocated() - base
    diff = _tree_diff(qrunner.params, quantize_params(p1, "int8"))
    check(not diff, f"reload int8: leaves differ from quantize_params: {diff}")
    check(rec["int8_peak_growth_bytes"] <= largest + RELOAD_SLACK_BYTES,
          f"reload int8: the peak grew {rec['int8_peak_growth_bytes']} bytes")
    free(qrunner)
    del p1
    gc.collect()
    torch.cuda.empty_cache()
    emit(rec)


def checkpoint_phases(runner, fused, fused_rec, draft_self, smi):
    """engine_checkpoint, engine_restart and engine_reload, in a temporary
    directory removed after."""
    root = Path(tempfile.mkdtemp(prefix="chip_ckpt_"))
    try:
        ckpt = checkpoint_phase(runner, fused, fused_rec, draft_self, root, smi)
        restart_phase(ckpt, root, smi)
        shutil.rmtree(ckpt)
        reload_phase(root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def verify_shape_phase(dev):
    """prefill_paged_attention at the draft path's verify shape: B 8 rows of
    S = gamma + 1 = 5 query tokens over the 3B traffic's contexts (Hk 8,
    G 3, D 128, PS 16, bf16), against its plain version (KERNEL_TOL, and
    in f32 row by row within ROW_REL_TOL), timed back to back and as graph
    replays beside its bound, the plain version and SDPA over K/V gathered
    dense beforehand."""
    gen = torch.Generator(device="cpu").manual_seed(20)
    Hk, G, D, PS = 8, 3, 128, 16
    H, B, S = Hk * G, len(VERIFY_CONTEXTS), DRAFT_GAMMA + 1
    kv_list = [c + S for c in VERIFY_CONTEXTS]
    MP = -(-max(kv_list) // PS) + 1
    NP = B * MP + 1

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).bfloat16().to(dev)

    k_pool, v_pool, q = rnd(NP, PS, Hk, D), rnd(NP, PS, Hk, D), rnd(B, S, Hk, G, D)
    pt = random_pages(gen, B, MP, NP, dev)
    ints = [torch.tensor(x, dtype=torch.int32, device=dev)
            for x in (list(VERIFY_CONTEXTS), [S] * B, kv_list)]
    args = (q, k_pool, v_pool, pt, *ints)
    out = prefill_paged_attention(*args)
    torch.cuda.synchronize()
    ref = prefill_paged_attention_ref(*args)
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), "verify shape: output not finite")
    check(err <= KERNEL_TOL, f"verify shape: prefill max abs err {err} > {KERNEL_TOL}")
    e_rel = row_rel_err(out, prefill_paged_attention_ref(*plain32(args[:3]), *args[3:]))
    check(e_rel <= ROW_REL_TOL, f"verify shape: prefill row error {e_rel} > {ROW_REL_TOL}")
    kq, vq = dense_kv(k_pool, pt, Hk, G), dense_kv(v_pool, pt, Hk, G)
    qd = q.reshape(B, S, H, D).transpose(1, 2)
    s_pos = ints[0][:, None] + torch.arange(S, device=dev)[None, :]  # [B, S]
    c_pos = torch.arange(MP * PS, device=dev)
    mask = (c_pos[None, None, :] <= s_pos[:, :, None])[:, None]
    n_pairs = sum(c + s + 1 for c in VERIFY_CONTEXTS for s in range(S))
    n_bytes = (2 * q.numel() * 2 + sum(kv_list) * Hk * D * 2 * 2
               + sum(-(-k // PS) for k in kv_list) * 4 + 3 * B * 4)
    bound_ms, bound_by = bound(n_bytes, 4 * n_pairs * H * D)

    def kernel():
        return prefill_paged_attention(*args)

    def library():
        return F.scaled_dot_product_attention(qd, kq, vq, attn_mask=mask,
                                              scale=D ** -0.5)

    rec = {"B": B, "S": S, "Hk": Hk, "G": G, "D": D, "PS": PS, "kv_lens": kv_list,
           "q_block": 64 // G, "max_abs_err": err, "row_rel_err": e_rel,
           "ms": cuda_ms(kernel), "device_ms": graph_ms(kernel),
           "plain_ms": cuda_ms(lambda: prefill_paged_attention_ref(*args)),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": cuda_ms(library), "library_device_ms": graph_ms(library)}
    emit({"phase": "verify_shape", **rec})
    del k_pool, v_pool, kq, vq
    torch.cuda.empty_cache()
    return rec


DISAGG_ARGS = ["--model", "llama-3.2-3b", "--num-pages", "1024",
               "--page-size", "16", "--max-seq-len", "4096", "--max-batch", "8",
               "--chunk-size", "512"]
DISAGG_CHUNK_PAGES = 16
PAGE_SIZE = 16


def _reset(*runners):
    reset_launches()
    for r in runners:
        r.reset_stats()


async def _collect_timed(engine, req, rid, on_first=None):
    """One request through `engine` (the router, or an engine), timed on
    the client's clock: TTFT at the first item with tokens."""
    t0 = time.monotonic()
    toks, finish, phases, t_first = [], None, {}, None
    async for item in engine.generate(req, Context(request_id=rid)):
        if item["token_ids"] and t_first is None:
            t_first = time.monotonic()
            if on_first is not None:
                on_first.set()
        toks.extend(item["token_ids"])
        if item.get("finish_reason"):
            finish = item["finish_reason"]
            phases = item.get("phases") or {}
    t_end = time.monotonic()
    check(finish != "error", f"request {rid} finished with error")
    return {"tokens": toks, "finish": finish, "phases": phases,
            "ttft_s": (t_first or t_end) - t0, "e2e_s": t_end - t0,
            "t_first": t_first, "t_end": t_end}


def _spy_calls(runner, names):
    """Record the page count of every call of runner.<name>."""
    calls = {n: [] for n in names}
    for n in names:
        orig = getattr(runner, n)

        def spy(pages, *a, _orig=orig, _n=n, **kw):
            calls[_n].append(len(pages))
            return _orig(pages, *a, **kw)

        setattr(runner, n, spy)
    return calls


def _check_finished(phase, results, V):
    for i, r in enumerate(results):
        check(r["finish"] == "length" and len(r["tokens"]) == N_OUT,
              f"{phase}: r{i} finished {r['finish']!r} with {len(r['tokens'])} tokens")
        check(all(0 <= t < V for t in r["tokens"]), f"{phase}: r{i} token out of range")


def _runtime(realm: str, plane: str, events: str = "inproc"):
    """A runtime of chip_smoke's process on in-process discovery."""
    return DistributedRuntime(discovery=MemDiscovery(realm=realm),
                              event_transport=events, request_plane=plane)


async def _disagg_fleet(prefill, decode, p_args, d_args):
    """Serve the prefill and the decode engine with serve_worker, each on
    its own runtime over the in-process plane, and put a PrefillRouter
    over them on a third: its prefill pool and its downstream decode
    client come from discovery. The prefill engine is served twice, as a
    colocated instance (pulled on the device) and as one pulled
    host-staged through kv_fetch; the router alternates between them.
    Returns (router, prefill instances, decode worker, close)."""
    realm = "inproc-disagg"
    rts = [_runtime(realm, "inproc", "tcp") for _ in range(3)] + [_runtime(realm, "inproc")]
    p_ws = [await serve_args(rts[0], prefill, p_args),
            await serve_args(rts[3], prefill, p_args, colocated=False,
                             publish_kv_events=False, publish_fpm=False)]
    d_w = await serve_args(rts[1], decode, d_args)
    front = rts[2]
    downstream = front.client(f"dyn/{d_args.component}/generate")
    pool = front.client(f"dyn/{p_args.component}/generate")
    await downstream.wait_ready(timeout=60)
    await pool.wait_ready(timeout=60)
    while len(pool.instances) < len(p_ws):
        await asyncio.sleep(0.01)
    router = PrefillRouter(downstream, DisaggPolicy(min_prefill_tokens=16))
    router.activate(pool, f"dyn/{p_args.component}/kv_fetch")

    async def close():
        await downstream.close()
        await pool.close()
        for rt in rts:
            await rt.shutdown(drain_timeout=10)
        for w in [d_w] + p_ws:
            await w.stop()

    return router, p_ws, d_w, close


async def _frontend_disagg_fleet(prefill, decode, p_args, d_args):
    """Serve the prefill and the decode engine with serve_worker over TCP,
    each on its own runtime, neither colocated, and put a `kv` ModelWatcher
    over them on a third runtime, as the frontend does: its model entry's
    chain (migration, backend, PrefillRouter, KvPushRouter) sends prompts
    of 16 tokens or more through the prefill worker, chosen by a KvRouter
    over the prefill pool. Returns (entry, prefill worker, decode worker,
    close)."""
    realm = "tcp-frontend"
    rts = [_runtime(realm, "tcp", "tcp") for _ in range(3)]
    p_w = await serve_args(rts[0], prefill, p_args, colocated=False)
    d_w = await serve_args(rts[1], decode, d_args, colocated=False)
    manager = ModelManager()
    watcher = ModelWatcher(rts[2], manager, router_mode="kv", disagg_min_prefill_tokens=16)
    await watcher.wait_for_model(timeout=60)
    entry = manager.get(d_w.instance.metadata["model_card"]["name"])
    while not (entry.prefill_router.active and entry.prefill_kv_router.workers()):
        await asyncio.sleep(0.01)  # bounded by the caller's wait_for
    await entry.chain.sink.router.start()

    async def close():
        await watcher.stop()
        for rt in rts:
            await rt.shutdown(drain_timeout=10)
        for w in (d_w, p_w):
            await w.stop()

    return entry, p_w, d_w, close


def _spy_routes(kv_router):
    """Record (request id, worker, overlap) of every request `kv_router`
    charges."""
    routes = []
    add = kv_router.add_request

    def spy(rid, worker, hashes, overlap):
        routes.append((rid, worker, overlap))
        return add(rid, worker, hashes, overlap)

    kv_router.add_request = spy
    return routes


async def _serve_disagg(router, reqs, late):
    """reqs concurrently through the router, then `late` once r6 (whose
    256-token prefix it shares) has its first token."""
    shared = asyncio.Event()
    tasks = [asyncio.create_task(_collect_timed(
        router, r, f"r{i}", shared if i == len(reqs) - 1 else None))
        for i, r in enumerate(reqs)]
    await shared.wait()
    tasks.append(asyncio.create_task(_collect_timed(router, late, f"r{len(reqs)}")))
    return await asyncio.gather(*tasks)


def _disagg_engines(params, chunk_pages=DISAGG_CHUNK_PAGES):
    p_args = parse_args(DISAGG_ARGS + ["--disagg-role", "prefill", "--component", "prefill"])
    d_args = parse_args(DISAGG_ARGS + ["--disagg-role", "decode", "--component", "decode",
                                       "--disagg-chunk-pages", str(chunk_pages)])
    prefill = build_engine(p_args, runner=build_runner(p_args, params=params)[0])
    decode = build_engine(d_args, runner=build_runner(d_args, params=params)[0])
    return prefill, decode, p_args, d_args


def _transfer(n_pages, results, page_bytes):
    """The pulls' wall on the decode side (the fetch, queueing on the
    prefill engine's step thread included, then the import on the decode
    engine's step thread), from the final items' phases."""
    rows = [(n, r["phases"]["kv_fetch_s"], r["phases"]["kv_import_s"])
            for n, r in zip(n_pages, results)]
    pages = sum(n for n, _, _ in rows)
    secs = sum(f + i for _, f, i in rows)
    return {
        "requests": len(rows), "pages": pages, "bytes": pages * page_bytes,
        "ms_per_request": [(f + i) * 1e3 for _, f, i in rows],
        "fetch_ms": [f * 1e3 for _, f, _ in rows],
        "import_ms": [i * 1e3 for _, _, i in rows],
        "prompt_pages": [n for n, _, _ in rows],
        "gb_per_s": pages * page_bytes / secs / 1e9,
    }


def disagg_phase(params):
    """The PrefillRouter → prefill worker (park) → KV pull (device for the
    colocated instance, host-staged chunks of 16 pages through kv_fetch for
    the other) → decode worker (admit with KV, decode), every hop over the
    in-process request plane."""
    prefill, decode, p_args, d_args = _disagg_engines(params)
    paths = {}
    imports = _spy_calls(decode.runner, ("import_pages_device", "import_pages"))
    V, L = prefill.runner.config.vocab_size, prefill.runner.config.n_layers
    reqs, late = workload(V, seed=1)
    prompts = [r["token_ids"] for r in reqs + [late]]

    async def serve():
        router, p_ws, d_w, close = await _disagg_fleet(prefill, decode, p_args, d_args)
        fetch = d_w.handler._fetch
        iid_dev = p_ws[0].instance.instance_id

        async def fetch_by_path(src):
            paths[src["request_id"]] = "device" if src["instance_id"] == iid_dev else "host"
            return await fetch(src)

        d_w.handler._fetch = fetch_by_path
        torch.cuda.synchronize()
        _reset(prefill.runner, decode.runner)
        t0 = time.monotonic()
        try:
            return await _serve_disagg(router, reqs, late), t0, d_w
        finally:
            await close()

    results, t0, d_w = asyncio.run(asyncio.wait_for(serve(), 300))
    check(d_w.handler.fallbacks == 0,
          f"disagg: {d_w.handler.fallbacks} pulls fell back to recompute")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    pst, dst = dict(prefill.runner.stats), dict(decode.runner.stats)
    _check_finished("disagg", results, V)
    path_of = [paths.get(f"r{i}:prefill") for i in range(len(prompts))]
    check(sorted(path_of) == ["device"] * 4 + ["host"] * 4,
          f"disagg: transfer paths {path_of}")
    # the decode engine admitted every prompt with its KV: no prefill
    check(dst["prefill_chunks"] == dst["mixed_chunks"] == 0
          and dst["padded_prefill_dispatches"] == 0,
          f"disagg: the decode engine prefilled: {dst}")
    check(pst["decode_steps"] == 0, f"disagg: the prefill engine decoded: {pst}")
    n_pages = [-(-len(p) // PAGE_SIZE) for p in prompts]
    check(pst["kv_pages_exported"] == sum(n_pages),
          f"disagg: exported {pst['kv_pages_exported']} pages, want {sum(n_pages)}")
    # one gather per pool per export: a device pull gathers once, a host
    # pull once per chunk of 16 pages
    exports = sum(1 if path == "device" else -(-n // DISAGG_CHUNK_PAGES)
                  for path, n in zip(path_of, n_pages))
    check(launches["gather_pages"] == 2 * exports,
          f"disagg: gather launches {launches['gather_pages']} != {exports} x 2")
    n_imports = len(imports["import_pages_device"]) + len(imports["import_pages"])
    check(len(imports["import_pages_device"]) == 4,
          f"disagg: device imports {imports['import_pages_device']}")
    check(launches["scatter_pages"] == 2 * n_imports,
          f"disagg: scatter launches {launches['scatter_pages']} != {n_imports} x 2")
    shared_pages = decode.scheduler.reused_prefix_tokens // PAGE_SIZE
    imported = sum(imports["import_pages_device"]) + sum(imports["import_pages"])
    check(dst["kv_pages_imported"] == imported == sum(n_pages) - shared_pages,
          f"disagg: imported {dst['kv_pages_imported']} pages, want "
          f"{sum(n_pages)} - {shared_pages} shared")
    check(launches["scatter_pages_layers"] == 0, "disagg: layer scatter ran")
    check(not prefill._parked and not prefill.pool.ref,
          "disagg: parked pages were not all released")
    # bytes: the decode engine's imported pages equal the prefill engine's,
    # read with plain indexing, for the longest request of each path
    compared = {}
    for path in ("device", "host"):
        i = max((j for j, p in enumerate(path_of) if p == path),
                key=lambda j: len(prompts[j]))
        hashes = block_hashes(prompts[i], PAGE_SIZE)
        p_pages = [prefill.pool.by_hash[h] for h in hashes]
        d_pages = [decode.pool.by_hash[h] for h in hashes]
        for pp, dp in ((prefill.runner.k_pool, decode.runner.k_pool),
                       (prefill.runner.v_pool, decode.runner.v_pool)):
            check(torch.equal(pp[:, p_pages], dp[:, d_pages]),
                  f"disagg: r{i}'s imported pages differ from the prefill engine's")
        compared[f"r{i}"] = {"path": path, "pages": len(hashes)}
    page_bytes = L * PAGE_SIZE * prefill.runner.config.n_kv_heads \
        * prefill.runner.config.head_dim * 2 * 2  # both pools, bf16
    # the pull's wall on the decode side (queueing on the prefill
    # engine's step thread included), then the import on the decode
    # engine's step thread
    transfer = {}
    for path in ("device", "host"):
        picked = [j for j, p in enumerate(path_of) if p == path]
        transfer[path] = _transfer([n_pages[j] for j in picked],
                                   [results[j] for j in picked], page_bytes)
    ttft = sorted(r["ttft_s"] for r in results)
    rates = sorted((len(r["tokens"]) - 1) / (r["t_end"] - r["t_first"]) for r in results)
    rec = {
        "phase": "engine_disagg", "model": prefill.runner.config.name,
        "n_layers": L, "requests": len(results),
        "prompt_tokens": [len(p) for p in prompts], "paths": path_of,
        "output_tokens": [len(r["tokens"]) for r in results],
        "prefill_stats": pst, "decode_stats": dst, "launches": launches,
        "export_calls": exports, "import_calls": n_imports,
        "decode_reused_prefix_tokens": decode.scheduler.reused_prefix_tokens,
        "bytes_equal": compared, "transfer": transfer,
        "ttft_s_min": ttft[0], "ttft_s_median": ttft[len(ttft) // 2],
        "ttft_s_max": ttft[-1],
        "decode_tok_s_per_request_median": rates[len(rates) // 2],
        "output_tok_s_overall": sum(len(r["tokens"]) for r in results) / wall,
        "wall_s": wall,
    }
    emit(rec)
    for name in ("gather_pages", "scatter_pages"):
        check(launches[name] > 0, f"disagg: {name} never launched")
    return launches, rec


ROOT = Path(__file__).resolve().parent
SERVE_TIMEOUT_S = 300  # the worker's start (weights drawn on the card) and drain


async def _one_then_all(engine, reqs):
    """`reqs` one at a time, then all at once, through `engine` (an
    engine or a client): (one-at-a-time results, all-at-once results,
    the all-at-once wall)."""
    alone = [await _collect_timed(engine, r, f"r{i}") for i, r in enumerate(reqs)]
    t0 = time.monotonic()
    together = await asyncio.gather(*[_collect_timed(engine, r, f"c{i}")
                                      for i, r in enumerate(reqs)])
    return alone, together, time.monotonic() - t0


def alone_phase(runner):
    """workload(seed 1)'s 8 requests served by a fresh engine over
    `runner` in this process, one at a time, then all at once (the second
    pass hits the first's prefix cache, as the served worker's does): the
    streams engine_served holds the served worker's against, and the
    in-process TTFT and e2e beside the wire's."""
    engine = build_engine(parse_args(ENGINE_ARGS), runner=runner)
    reqs, late = workload(runner.config.vocab_size, seed=1)
    try:
        return asyncio.run(asyncio.wait_for(_one_then_all(engine, reqs + [late]), 300))
    finally:
        engine.stop()


def _latency(results):
    ttft = sorted(r["ttft_s"] for r in results)
    e2e = sorted(r["e2e_s"] for r in results)
    return {"ttft_s": [r["ttft_s"] for r in results], "e2e_s": [r["e2e_s"] for r in results],
            "ttft_s_median": ttft[len(ttft) // 2], "e2e_s_median": e2e[len(e2e) // 2]}


async def _read_serving_line(proc, log_path):
    while True:
        line = (await proc.stdout.readline()).decode()
        if not line:
            tail = Path(log_path).read_text()[-3000:]
            raise CheckFailed(f"served: the worker exited ({await proc.wait()}) "
                              f"before serving:\n{tail}")
        if line.startswith("worker serving"):
            return line.strip()


def served_phase(in_process, fused_rec, V):
    """`python -m dynamo_tpu_torch.worker` serving llama-3.2-3b as a
    process on the card (the engine_fused flags, file discovery on a
    temporary root), and a client runtime in this process that discovers
    it. The worker first serves workload(seed 2) one request at a time
    (its first run of each shape, which this process's runner is past),
    then workload(seed 1) as alone_phase does: one at a time, each greedy
    stream equal to the in-process engine's, then all 8 at once, each
    finishing with its N_OUT tokens. Then SIGTERM, after which the worker
    must exit 0."""
    alone, together_in, together_in_wall = in_process
    reqs, late = workload(V, seed=1)
    reqs = reqs + [late]
    warm, warm_late = workload(V, seed=2)
    greedy = [i for i in range(len(reqs)) if i not in (2, 5)]

    async def run(root):
        log_path = os.path.join(root, "worker.log")
        with open(log_path, "w") as log_file:
            t0 = time.monotonic()
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "dynamo_tpu_torch.worker", *ENGINE_ARGS,
                "--discovery-backend", "file", "--discovery-root", root,
                cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                stdout=asyncio.subprocess.PIPE, stderr=log_file)
        rt = DistributedRuntime(discovery=FileDiscovery(root, poll_interval=0.05))
        try:
            line = await asyncio.wait_for(_read_serving_line(proc, log_path), SERVE_TIMEOUT_S)
            start_s = time.monotonic() - t0
            client = rt.client("dyn/tpu-worker/generate")
            await client.wait_ready(timeout=60)  # raises when nothing registered
            instances = len(client.instances)
            first = [await _collect_timed(client, r, f"w{i}")
                     for i, r in enumerate(warm + [warm_late])]
            alone_wire, together, together_wall = await _one_then_all(client, reqs)
            await client.close()
            t2 = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            rc = await asyncio.wait_for(proc.wait(), SERVE_TIMEOUT_S)
            exit_s = time.monotonic() - t2
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
            await rt.shutdown(drain_timeout=1)
        return (line, start_s, instances, first, alone_wire, together, together_wall,
                rc, exit_s)

    with tempfile.TemporaryDirectory() as root:
        (line, start_s, instances, first, alone_wire, together, together_wall, rc,
         exit_s) = asyncio.run(run(root))
    check(instances == 1, f"served: {instances} instances registered")
    check(rc == 0, f"served: the worker exited {rc} after SIGTERM")
    _check_finished("served_first", first, V)
    _check_finished("served_alone", alone_wire, V)
    _check_finished("served_together", together, V)
    same = [alone_wire[i]["tokens"] == alone[i]["tokens"] for i in range(len(reqs))]
    check(all(same[i] for i in greedy),
          f"served: greedy streams differ from the in-process engine's: {same}")
    rec = {
        "phase": "engine_served", "model": ENGINE_ARGS[1], "worker": line,
        "worker_start_s": start_s, "worker_exit_code": rc, "worker_exit_s": exit_s,
        "requests": len(reqs), "prompt_tokens": [len(r["token_ids"]) for r in reqs],
        "greedy_streams_equal": sum(same[i] for i in greedy), "greedy_streams": len(greedy),
        "sampled_streams_equal": [same[i] for i in range(len(reqs)) if i not in greedy],
        "first_shapes_wire": _latency(first),
        "one_at_a_time": {"wire": _latency(alone_wire), "in_process": _latency(alone)},
        "all_at_once": {
            "wire": {**_latency(together), "wall_s": together_wall,
                     "output_tok_s_overall": sum(len(r["tokens"]) for r in together)
                     / together_wall},
            "in_process": {**_latency(together_in), "wall_s": together_in_wall,
                           "output_tok_s_overall": sum(len(r["tokens"]) for r in together_in)
                           / together_in_wall}},
        "in_process_engine_fused": {
            k: fused_rec[k] for k in ("ttft_s_min", "ttft_s_median", "ttft_s_max",
                                      "decode_tok_s_per_request_median",
                                      "output_tok_s_overall", "wall_s")},
    }
    emit(rec)
    return rec


MODEL = ENGINE_ARGS[1]
FRONTEND_MIGRATE_TOKENS = 256  # the migrated stream's length
FRONTEND_KILL_AFTER = 16  # its worker is SIGKILLed after this many tokens


class _ChainTap:
    """A model entry's chain, recording each request's tokens and the
    times of its first and last token as they leave the chain, by request
    id (a stream's X-Request-Id): the text of a random-weight 3B's stream
    is mostly empty (ids >= 256 decode to nothing), so its tokens are read
    here."""

    def __init__(self, chain):
        self.chain = chain
        self.tokens, self.times = {}, {}  # request id -> token ids, item times

    def t_first(self, rid):
        return self.times[rid][0] if self.times.get(rid) else None

    def get(self, name):
        return self.chain.get(name)

    @property
    def sink(self):
        return self.chain.sink

    async def teardown(self):
        await self.chain.teardown()

    async def generate(self, request, context):
        toks = self.tokens.setdefault(context.id, [])
        times = self.times.setdefault(context.id, [])
        async for item in self.chain.generate(request, context):
            if item.get("token_ids"):
                times.append(time.monotonic())
                toks.extend(item["token_ids"])
            yield item


def _http_body(req, stream=False):
    """A workload request as an OpenAI completions body: token-id prompt,
    its sampling, N_OUT tokens, EOS ignored."""
    s = req["sampling"]
    body = {"model": MODEL, "prompt": req["token_ids"], "stream": stream,
            "max_tokens": req["stop"]["max_tokens"], "ignore_eos": True,
            **{k: s[k] for k in ("temperature", "top_p", "seed") if k in s}}
    if stream:
        body["stream_options"] = {"include_usage": True}
    return body


def _http(port, method, path, body=None, headers=None):
    """One request over http.client: (status, headers, body bytes)."""
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=SERVE_TIMEOUT_S)
    try:
        c.request(method, path, json.dumps(body) if body is not None else None,
                  {"Content-Type": "application/json", **(headers or {})})
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


def _sse(data: bytes):
    return [e[len("data: "):] for e in data.decode().split("\n\n") if e.startswith("data: ")]


async def _http_timed(port, body, tap):
    """A streamed completion over HTTP on the client's clock: TTFT to its
    first token leaving the frontend's chain (the SSE chunk carrying it
    may wait for text), e2e to `data: [DONE]`."""
    t0 = time.monotonic()
    status, headers, data = await asyncio.to_thread(_http, port, "POST", "/v1/completions",
                                                    body)
    t_end = time.monotonic()
    rid = headers.get("X-Request-Id")
    events = _sse(data)
    check(status == 200 and events[-1:] == ["[DONE]"],
          f"frontend: stream {rid} answered {status}, ends {events[-1:]}")
    chunks = [json.loads(e) for e in events[:-1]]
    check(not any("error" in c for c in chunks), f"frontend: stream {rid} errored: {chunks}")
    return {"rid": rid, "chunks": chunks, "tokens": tap.tokens.get(rid, []),
            "text": "".join(ch["text"] for c in chunks for ch in c["choices"]),
            "usage": chunks[-1].get("usage"),
            "ttft_s": (tap.t_first(rid) or t_end) - t0, "e2e_s": t_end - t0}


async def _open_stream(port, body):
    """Send a streamed completion on a raw connection and read its head:
    (reader, writer, request id)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode()
    writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: chip-smoke\r\n"
                 b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n%s"
                 % (len(data), data))
    await writer.drain()
    head = (await reader.readuntil(b"\r\n\r\n")).decode()
    check(head.startswith("HTTP/1.1 200"), f"frontend: stream refused: {head}")
    rid = re.search(r"X-Request-Id: (\S+)", head).group(1)
    return reader, writer, rid


async def _read_chunked(reader) -> bytes:
    """The rest of a chunked body, de-chunked."""
    out = b""
    while True:
        n = int((await reader.readline()).split(b";")[0], 16)
        if n == 0:
            await reader.readline()
            return out
        out += await reader.readexactly(n)
        await reader.readline()


async def _until(cond, what, bound):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > bound:
            raise CheckFailed(f"frontend: timed out waiting for {what}")
        await asyncio.sleep(0.01)


async def _spawn(args, root, marker, log_path, env=None):
    """`python -m <args>` on the discovery root, with `env` added to the
    environment; returns (process, the line starting with `marker`) once
    it prints it."""
    with open(log_path, "w") as log_file:
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", *args, "--discovery-backend", "file",
            "--discovery-root", root, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT), **(env or {})),
            stdout=asyncio.subprocess.PIPE, stderr=log_file)
    while True:
        line = (await asyncio.wait_for(proc.stdout.readline(), SERVE_TIMEOUT_S)).decode()
        if not line:
            tail = Path(log_path).read_text()[-3000:]
            raise CheckFailed(f"frontend: {args[0]} exited ({await proc.wait()}) "
                              f"before serving:\n{tail}")
        if line.startswith(marker):
            return proc, line.strip()


async def _frontend_extras(port, prompt):
    """A chat with response_format json_schema (FRONTEND_SCHEMA): a `stop`
    content parses with the schema's required keys, a `length` one is a
    prefix the schema's DFA accepts; a completion with logprobs 3 in the
    reference's shape (tokens, token_logprobs, top_logprobs, text_offset,
    one entry a token, each <= 0, the greedy token's the best); and
    /v1/embeddings over three token-id inputs: each norm 1 +- 1e-3, an
    input sent alone twice gives the same vector bit for bit, the batched
    vectors within 2e-2 of the one-at-a-time ones (bf16)."""
    from dynamo_tpu_torch.guided import schema_to_regex

    async def post(path, body):
        status, _, data = await asyncio.to_thread(_http, port, "POST", path, body)
        check(status == 200, f"frontend: {path} answered {status}: {data[:300]}")
        return json.loads(data)

    out = {}
    chat = await post("/v1/chat/completions", {
        "model": MODEL, "messages": [{"role": "user", "content": "give me a record"}],
        "max_tokens": 48, "temperature": 0,
        "response_format": {"type": "json_schema",
                            "json_schema": {"name": "r", "schema": FRONTEND_SCHEMA}}})
    choice = chat["choices"][0]
    content = choice["message"]["content"] or ""
    if choice["finish_reason"] == "stop":
        parsed = json.loads(content)
        check(set(FRONTEND_SCHEMA["required"]) <= set(parsed),
              f"frontend: the json_schema answer lacks a required key: {content!r}")
    else:
        check(_in_language(schema_to_regex(FRONTEND_SCHEMA), list(content.encode()),
                           "length"), f"frontend: {content!r} breaks the schema")
    out["json_schema"] = {"content": content, "finish": choice["finish_reason"]}
    comp = await post("/v1/completions", {"model": MODEL, "prompt": prompt(64),
                                          "max_tokens": 8, "temperature": 0,
                                          "ignore_eos": True, "logprobs": 3})
    lp = comp["choices"][0]["logprobs"]
    n = comp["usage"]["completion_tokens"]
    check(set(lp) == {"tokens", "token_logprobs", "top_logprobs", "text_offset"}
          and all(len(lp[k]) == n == 8 for k in lp),
          f"frontend: the logprobs body is not the reference's shape: {lp}")
    check(all(v <= 0 and 1 <= len(top) <= 3 and v == max(top.values())
              for v, top in zip(lp["token_logprobs"], lp["top_logprobs"])),
          f"frontend: logprob entries out of order: {lp}")
    out["logprobs"] = {"token_logprobs": lp["token_logprobs"]}
    inputs = [prompt(n) for n in (40, 77, 128)]
    batched = await post("/v1/embeddings", {"model": MODEL, "input": inputs})
    alone = [(await post("/v1/embeddings", {"model": MODEL, "input": [x]}))["data"][0]
             ["embedding"] for x in inputs]
    again = (await post("/v1/embeddings", {"model": MODEL, "input": [inputs[0]]}))[
        "data"][0]["embedding"]
    vecs = torch.tensor([d["embedding"] for d in batched["data"]], dtype=torch.float64)
    single = torch.tensor(alone, dtype=torch.float64)
    norms = vecs.norm(dim=-1)
    check(batched["usage"]["prompt_tokens"] == sum(len(x) for x in inputs)
          and bool(((norms - 1).abs() <= 1e-3).all()),
          f"frontend: embedding norms {norms.tolist()}")
    check(again == alone[0], "frontend: one input embedded twice differs")
    err = float((vecs - single).abs().max())
    check(err <= 2e-2, f"frontend: batched embeddings {err} from one at a time")
    out["embeddings"] = {"dim": vecs.shape[1], "norms": norms.tolist(),
                         "batched_vs_alone_max_abs": err}
    return out


# observability_served: the flags and environment frontend_phase's
# workers and frontends run with
OBS_WORKER_ARGS = ["--sanitize", "--digest-period", "0.5"]
OBS_ENV = {"DYN_TRACE_RING": "4096"}
OBS_DIGEST_WINDOW_S = 900.0  # the whole phase
OBS_SERIES = ("dynamo_request_phase_seconds_count{", "dynamo_compile_variants{",
              "dynamo_compile_seconds_total{", "dynamo_flight_recorder_anomalies_total{",
              "dynamo_tracing_dropped_spans{")
# each hook's failure count on a worker's /metrics (all 0 on a clean run)
OBS_FAILURE_SERIES = ("dynamo_digest_publish_failures_total{",
                      "dynamo_digest_probe_failures_total{",
                      "dynamo_flight_recorder_failures_total{")
OBS_FRONTEND_SERIES = ("dynamo_frontend_requests_total{", "dynamo_frontend_ttft_seconds_count{",
                       "dynamo_tracing_dropped_spans{")
OBS_SPANS = {"frontend.request", "route.kv", "rpc", "worker.request", "worker.queue",
             "worker.prefill", "worker.stream"}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _obs_get(port, path):
    status, _, data = await asyncio.to_thread(_http, port, "GET", path)
    check(status == 200, f"observability: GET {path} on :{port} answered {status}: "
          f"{data[:200]}")
    return json.loads(data) if not path.startswith("/metrics") else data.decode()


def _trace_of(spans, rid):
    """The trace id of request `rid`'s frontend.request root."""
    ids = {s["trace_id"] for s in spans if s["name"] == "frontend.request"
           and s["attributes"].get("request.id") == rid}
    check(len(ids) == 1, f"observability: request {rid} has roots in traces {ids}")
    return ids.pop()


def _joined(spans, tid, what):
    """One trace's spans reach one frontend.request root through their
    parents, and hold every hop's span."""
    by_id = {s["span_id"]: s for s in spans}
    names = {s["name"].split(" ")[0] for s in spans}
    check(OBS_SPANS <= names and {s["trace_id"] for s in spans} == {tid},
          f"observability: {what}'s trace {tid} holds {sorted(names)}")
    for s in spans:
        while s["parent_span_id"] in by_id:
            s = by_id[s["parent_span_id"]]
        check(s["name"] == "frontend.request",
              f"observability: {what}'s span {s['name']} is not under the root")


async def _observability_served(fe_status, ring, workers, rids, model):
    """`observability_served`, on frontend_phase's two workers (`workers`:
    instance -> status port) and its in-process frontend (status port
    `fe_status`, span ring `ring`) after the 3B's traffic. Every worker's
    sanitizer reports no violation over a non-zero count of guarded
    dispatches; its timeline holds one record per dispatched iteration,
    their ragged, chunk and step sums equal to the runner's counters;
    each streamed request (`rids`) has the frontend root, routing span,
    server hop and engine spans under one trace id, across the frontend's
    ring and its worker's; /debug/routing?rid= names the worker whose ring
    holds the trace; /debug/fleet shows both workers, each with TTFT
    counts equal to the requests the KV router sent it; and /metrics on
    every status port serves the reference's series names."""
    t0 = time.monotonic()
    rec = {"workers": {}}
    # the routing audit's count a worker, then the digests catching up
    dec = (await _obs_get(fe_status, "/debug/routing?last_n=100000"))["decisions"]
    sent = {iid: sum(1 for d in dec if d["router"] == f"{model}/kv"
                     and d["chosen"][0] == iid) for iid in workers}
    check(sum(sent.values()) > 0, f"observability: no KV routing recorded: {dec[-3:]}")

    async def fleet_rows():
        view = await _obs_get(fe_status, "/debug/fleet")
        return {r["worker"][0]: r for r in view["workers"].values()}

    deadline = time.monotonic() + 30
    while True:
        rows = await fleet_rows()
        ttft = {iid: rows.get(iid, {}).get("phases", {}).get("ttft", {}).get("n", 0)
                for iid in workers}
        if ttft == sent or time.monotonic() > deadline:
            break
        await asyncio.sleep(0.25)
    check(set(rows) == set(workers) and ttft == sent
          and all(rows[i]["counters"]["requests"] == sent[i] for i in workers),
          f"observability: fleet TTFT counts {ttft}, requests "
          f"{ {i: r['counters']['requests'] for i, r in rows.items()} }, routed {sent}")
    rec["routed"] = {f"{i:x}": n for i, n in sent.items()}
    view = await _obs_get(fe_status, "/debug/fleet")
    check(view["dropped_malformed"] == 0,
          f"observability: the frontend dropped malformed digests: {view['dropped_malformed']}")
    rec["digests_received"] = view["received"]
    for iid, port in workers.items():
        san = await _obs_get(port, "/debug/sanitizer")
        eng = await _obs_get(port, "/debug/engine")
        tl = await _obs_get(port, "/debug/timeline")
        text = await _obs_get(port, "/metrics")
        check(san["ok"] and not san["violations"] and san["warm"]
              and san["counters"]["guarded_dispatches"] > 0,
              f"observability: worker {iid:x}'s sanitizer: {san}")
        recs = [e["args"] for e in tl["traceEvents"] if e["ph"] == "X"]
        st = eng["stats"]
        ragged = sum(r["ragged"] for r in recs)
        sums = {"records": len(recs), "ragged": ragged,
                "fused_chunks": sum(r["n_chunks"] for r in recs if r["fused"]),
                "unfused_chunks": sum(r["n_chunks"] for r in recs if not r["fused"]),
                "decode_steps_less_ragged": sum(r["decode_steps"] for r in recs) - ragged}
        want = {"records": eng["iterations"],
                "ragged": st["ragged_mixed_dispatches"] + st["ragged_verify_dispatches"],
                "fused_chunks": st["mixed_chunks"], "unfused_chunks": st["prefill_chunks"],
                "decode_steps_less_ragged": st["decode_steps"]}
        check(eng["instance"] == iid and sums == want
              and eng["recorder"]["appended"] == eng["iterations"],
              f"observability: worker {iid:x}'s timeline sums {sums} != counters {want}")
        missing = [n for n in OBS_SERIES if n not in text]
        check(not missing, f"observability: worker {iid:x}'s /metrics lacks {missing}")
        # no hook failed: recorder dumps, hooks and profile windows, the
        # step profiler, the digest publisher and its engine probes
        fails = eng["hook_failures"]
        series = {n: [ln for ln in text.splitlines() if ln.startswith(n)]
                  for n in OBS_FAILURE_SERIES}
        check(len(fails) == 6 and not any(fails.values())
              and eng["digest"]["published"] > 0
              and all(v and all(ln.endswith(" 0.0") for ln in v) for v in series.values()),
              f"observability: worker {iid:x}'s hook failures {fails}, digest "
              f"{eng['digest']}, /metrics {series}")
        rec["workers"][f"{iid:x}"] = {"sanitizer": san["counters"], "timeline": sums,
                                      "recorder": eng["recorder"], "hook_failures": fails,
                                      "digests_published": eng["digest"]["published"]}
    spans = [span_to_dict(s) for s in ring.snapshot()]
    for rid in rids:
        tid = _trace_of(spans, rid)
        holders = {}
        for iid, port in workers.items():
            got = (await _obs_get(port, f"/debug/traces?trace_id={tid}"))["spans"]
            if got:
                holders[iid] = got
        check(len(holders) == 1, f"observability: {rid}'s trace on workers {list(holders)}")
        (iid, wspans), = holders.items()
        _joined([s for s in spans if s["trace_id"] == tid] + wspans, tid, rid)
        routed = (await _obs_get(fe_status, f"/debug/routing?rid={rid}"))["decisions"]
        check([d["chosen"][0] for d in routed if d["router"] == f"{model}/kv"] == [iid],
              f"observability: {rid} routed {routed}, served by {iid:x}")
    rec["traced_requests"] = len(rids)
    text = await _obs_get(fe_status, "/metrics")
    missing = [n for n in OBS_FRONTEND_SERIES if n not in text]
    check(not missing, f"observability: the frontend's /metrics lacks {missing}")
    rec["seconds"] = time.monotonic() - t0
    return rec



def frontend_phase(in_process, V, served_rec, smi):
    """`engine_frontend`: two `python -m dynamo_tpu_torch.worker`
    processes (engine_served's flags) on one file-discovery root, behind
    an HttpService in this process in `kv` mode (its KV router read here,
    its chain tapped for token ids). The HTTP client is the standard
    library's. Passes, one request at a time unless said:
      - workload(seed 2) over HTTP unary (the workers' first run of each
        shape): usage 32 each;
      - workload(seed 1) through the entry's chain: each greedy stream
        equal to alone_phase's in-process stream;
      - the same 8 over HTTP streamed and unary: usage 32, the streamed
        text equal to ByteTokenizer.decode of the stream's tokens, ends in
        `data: [DONE]`; one chat completion stream ends in it too;
      - the sampling extras (_frontend_extras): a chat with a
        response_format json_schema, a completion with logprobs 3, and
        /v1/embeddings over three inputs;
      - workload(seed 3) streamed (cold prompts): TTFT and e2e over HTTP
        beside engine_served's;
      - a 1024-token prompt, then three prompts sharing it: each selects
        and is routed to the worker that holds it with >= 63 blocks of
        overlap; their TTFT beside three cold prompts of the same length;
        8 distinct prompts at once use both workers;
      - a 256-token stream whose worker is SIGKILLed after 16 tokens
        finishes with 256 tokens and no error, one migration counted;
      - a stream on the survivor dropped by its client: the survivor's
        forward-pass metrics (FPM) show no page of it held;
      - `python -m dynamo_tpu_torch.frontend --router-mode kv` in front of
        the survivor lists the model and streams a completion; after
        SIGTERM it exits 0, then the worker does."""
    alone = in_process[0]
    reqs, late = workload(V, seed=1)
    reqs = reqs + [late]
    warm, warm_late = workload(V, seed=2)
    cold, cold_late = workload(V, seed=3)
    greedy = [i for i in range(len(reqs)) if i not in (2, 5)]
    gen = torch.Generator(device="cpu").manual_seed(23)

    def prompt(n):
        return torch.randint(0, V, (n,), generator=gen).tolist()

    def req(p, n_out=8):
        return {"model": MODEL, "prompt": p, "max_tokens": n_out, "temperature": 0,
                "ignore_eos": True}

    async def run(root):
        from dynamo_tpu_torch.frontend.http import HttpService
        from dynamo_tpu_torch.frontend.tokenizer import ByteTokenizer
        from dynamo_tpu_torch.router.protocols import FPM_SUBJECT

        from dynamo_tpu_torch.frontend.__main__ import start_fleet_status

        rec = {"phase": "engine_frontend", "model": MODEL, "nvidia_smi": smi}
        t_phase = time.monotonic()
        procs = {}
        # observability_served: this process's frontend keeps a span ring
        # and serves the fleet and routing views on a status port, as the
        # frontend's main does with --status-port and DYN_TRACE_RING
        ring = SpanRing(4096)
        set_exporter(ring)
        rt = DistributedRuntime(discovery=FileDiscovery(root, poll_interval=0.05))
        manager = ModelManager()
        svc = HttpService(rt, manager, ModelWatcher(rt, manager, router_mode="kv"),
                          host="127.0.0.1", port=0)
        sub = rt.event_subscriber([FPM_SUBJECT])
        fpm = []
        listener = None
        fleet = None
        try:
            t0 = time.monotonic()
            w_status = [_free_port(), _free_port()]
            started = await asyncio.gather(*[_spawn(
                ["dynamo_tpu_torch.worker", *ENGINE_ARGS, *OBS_WORKER_ARGS,
                 "--status-port", str(w_status[i]),
                 "--anomaly-dump-dir", os.path.join(root, f"anomaly{i}")], root,
                "worker serving", os.path.join(root, f"worker{i}.log"), env=OBS_ENV)
                for i in range(2)])
            rec["worker_start_s"] = time.monotonic() - t0
            for proc, line in started:
                procs[line.rsplit("(", 1)[1].rstrip(")")] = proc
            rec["workers"] = [line for _, line in started]
            fe_status = _free_port()
            fleet = await start_fleet_status(rt, manager, svc.watcher, fe_status,
                                             OBS_DIGEST_WINDOW_S)
            await svc.start()
            port = svc.port
            await svc.watcher.wait_for_model(timeout=60)
            entry = manager.get(MODEL)
            await _until(lambda: len(entry.client.instances) == 2, "both workers", 60)
            # every digest of the traffic reaches the observer
            await _until(lambda: len(fleet[1].workers()) == 2, "both workers' digests", 60)
            status_of = {}
            for sp in w_status:
                status_of[(await _obs_get(sp, "/debug/engine"))["instance"]] = sp
            check(set(status_of) == set(entry.client.instances),
                  f"frontend: status ports {status_of} for {list(entry.client.instances)}")
            tap = entry.chain = _ChainTap(entry.chain)
            kv = entry.chain.sink.router
            await kv.start()
            routes = _spy_routes(kv)

            def proc_of(iid):
                return procs[entry.client.instances[iid].address]

            async def unary(body):
                status, _, data = await asyncio.to_thread(_http, port, "POST",
                                                          "/v1/completions", body)
                check(status == 200, f"frontend: unary answered {status}: {data[:300]}")
                return json.loads(data)

            # 1. the workers' first run of each shape, unary
            for r in warm + [warm_late]:
                usage = (await unary(_http_body(r)))["usage"]
                check(usage["completion_tokens"] == N_OUT, f"frontend: warm usage {usage}")
            # 2. through the chain: greedy streams equal in process
            chain = []
            for i, r in enumerate(reqs):
                pre = entry.preprocessor.preprocess_completions(_http_body(r))
                chain.append(await _collect_timed(entry.chain, pre, f"chain{i}"))
            _check_finished("frontend_chain", chain, V)
            same = [chain[i]["tokens"] == alone[i]["tokens"] for i in range(len(reqs))]
            check(all(same[i] for i in greedy),
                  f"frontend: greedy chain streams differ from in process: {same}")
            rec["chain_greedy_streams_equal"] = sum(same[i] for i in greedy)
            rec["chain_greedy_streams"] = len(greedy)
            rec["sampled_streams_equal"] = [same[i] for i in range(len(reqs)) if i not in greedy]
            rec["one_at_a_time_chain"] = _latency(chain)
            # 3. the same 8 over HTTP, streamed then unary
            byte_tok = ByteTokenizer()
            streamed = [await _http_timed(port, _http_body(r, stream=True), tap) for r in reqs]
            for s in streamed:
                check(s["usage"]["completion_tokens"] == N_OUT == len(s["tokens"]),
                      f"frontend: stream {s['rid']}: usage {s['usage']}, "
                      f"{len(s['tokens'])} tokens")
                # the backend holds back a trailing partial UTF-8 sequence,
                # and a max_tokens finish does not flush it (the reference's
                # backend.py does the same)
                full = byte_tok.decode(s["tokens"])
                check(full.startswith(s["text"]) and not full[len(s["text"]):].strip("\ufffd"),
                      f"frontend: stream {s['rid']}'s text is not its tokens' bytes")
            for r in reqs:
                usage = (await unary(_http_body(r)))["usage"]
                check(usage["completion_tokens"] == N_OUT, f"frontend: unary usage {usage}")
            status, _, data = await asyncio.to_thread(_http, port, "POST",
                                                      "/v1/chat/completions", {
                "model": MODEL, "messages": [{"role": "user", "content": "hello"}],
                "max_tokens": 8, "temperature": 0, "ignore_eos": True, "stream": True})
            check(status == 200 and _sse(data)[-1:] == ["[DONE]"],
                  f"frontend: chat stream answered {status}, ends {_sse(data)[-1:]}")
            # 3b. the sampling extras: response_format, logprobs, embeddings
            rec["extras"] = await _frontend_extras(port, prompt)
            # 4. cold prompts streamed: TTFT and e2e over HTTP
            cold_http = [await _http_timed(port, _http_body(r, stream=True), tap)
                         for r in cold + [cold_late]]
            rec["one_at_a_time_http"] = _latency(cold_http)
            rec["engine_served_one_at_a_time"] = served_rec["one_at_a_time"]
            # 5. KV routing: a 1024-token prefix and three prompts sharing it
            prefix = prompt(1024)
            await unary(req(prefix + prompt(64), 4))
            seeded = routes[-1][1]
            held = block_hashes(prefix, PAGE_SIZE)
            await _until(lambda: kv.indexer.index.find_matches(held).scores.get(seeded, 0)
                         >= 63, "the indexer to hold the prefix", 30)
            hits, picks = [], []
            for _ in range(3):
                p = prefix + prompt(64)
                w, overlap, _ = kv.find_best_match(p)
                picks.append((w, overlap))
                hits.append(await _http_timed(port, dict(req(p), stream=True), tap))
                check(routes[-1][1:] == (w, overlap),
                      f"frontend: routed {routes[-1]} but selected {(w, overlap)}")
            check(all(w == seeded and o >= 63 for w, o in picks),
                  f"frontend: prefix follow-ups picked {picks}, seeded {seeded}")
            colds = [await _http_timed(port, dict(req(prompt(1088)), stream=True), tap)
                     for _ in range(3)]
            rec["kv_routing"] = {
                "seeded": list(seeded), "overlaps": [o for _, o in picks],
                "prefix_hit_ttft_s": [h["ttft_s"] for h in hits],
                "cold_ttft_s": [c["ttft_s"] for c in colds]}
            n_before = len(routes)
            await asyncio.gather(*[unary(req(prompt(300))) for _ in range(8)])
            spread = {w for _, w, _ in routes[n_before:]}
            check(len(spread) == 2, f"frontend: 8 distinct prompts used {spread}")
            rec["distinct_prompts_workers"] = len(spread)
            # observability_served: both workers up, all their traffic done
            obs = await _observability_served(
                fe_status, ring, status_of,
                [r["rid"] for r in streamed + cold_http + hits + colds], MODEL)
            emit({"phase": "observability_served", "model": MODEL, "nvidia_smi": smi, **obs})
            rec["observability_served_s"] = obs["seconds"]
            # 6. migration: SIGKILL the worker of a stream after 16 tokens
            body = dict(req(prompt(512), FRONTEND_MIGRATE_TOKENS), stream=True,
                        stream_options={"include_usage": True})
            t_send = time.monotonic()
            reader, writer, rid = await _open_stream(port, body)
            await _until(lambda: len(tap.tokens.get(rid, [])) >= FRONTEND_KILL_AFTER,
                         "the stream's first tokens", 120)
            victim_iid = routes[-1][1][0]
            victim = proc_of(victim_iid)
            n_at_kill = len(tap.tokens[rid])
            victim.kill()
            events = _sse(await asyncio.wait_for(_read_chunked(reader), 120))
            writer.close()
            t_end = time.monotonic()
            await victim.wait()
            chunks = [json.loads(e) for e in events[:-1]]
            toks = tap.tokens[rid]
            check(events[-1:] == ["[DONE]"] and not any("error" in c for c in chunks),
                  f"frontend: the migrated stream ended {events[-2:]}")
            check(chunks[-1]["usage"]["completion_tokens"] == FRONTEND_MIGRATE_TOKENS
                  == len(toks), f"frontend: the migrated stream gave {len(toks)} tokens")
            migrations = entry.chain.get("migration").migrations
            check(migrations == 1, f"frontend: {migrations} migrations counted")
            check(routes[-1][1][0] != victim_iid, "frontend: the retry went to the victim")
            gaps = sorted(b - a for a, b in zip(tap.times[rid], tap.times[rid][1:]))
            rec["migration"] = {
                "tokens": len(toks), "tokens_at_kill": n_at_kill, "migrations": migrations,
                "e2e_s": t_end - t_send,
                # the stall the kill caused (detection, backoff, the replay's
                # prefill on the survivor) beside an ordinary gap
                "longest_gap_s": gaps[-1], "median_gap_s": gaps[len(gaps) // 2]}
            survivor_iid = routes[-1][1][0]
            survivor = proc_of(survivor_iid)
            # 7. a dropped client: the survivor's FPM shows no page held
            meta = entry.client.instances[survivor_iid].metadata
            num_pages = int(ENGINE_ARGS[ENGINE_ARGS.index("--num-pages") + 1])
            sub.connect(meta["fpm_publisher"])

            async def listen():
                async for _, payload in sub.events():
                    if payload["worker"][0] == survivor_iid:
                        fpm.append((time.monotonic(), payload))

            listener = asyncio.create_task(listen())
            reader, writer, rid = await _open_stream(port, dict(
                req(prompt(1024), 2048), stream=True))
            await _until(lambda: len(tap.tokens.get(rid, [])) >= FRONTEND_KILL_AFTER,
                         "the dropped stream's first tokens", 120)
            await _until(lambda: fpm and fpm[-1][1]["kv_usage"] * num_pages >= 64,
                         "an FPM of the stream", 30)
            held_pages = fpm[-1][1]["kv_usage"] * num_pages
            writer.transport.abort()
            t_drop = time.monotonic()
            # probes: the first FPM whose plan holds only a probe's pages
            probe_fpm = None
            while probe_fpm is None:
                check(time.monotonic() - t_drop < 30, "frontend: the dropped stream's "
                      f"pages are still held: {fpm[-3:]}")
                t_probe = time.monotonic()
                await unary(req(prompt(16), 2))
                probe_fpm = next((m for t, m in fpm if t > t_probe and m["n_running"] <= 1
                                  and m["n_waiting"] == 0
                                  and round(m["kv_usage"] * num_pages) <= 4), None)
            rec["dropped_client"] = {
                "pages_held_while_streaming": held_pages, "tokens_before_drop":
                len(tap.tokens[rid]), "probe_fpm": probe_fpm,
                "freed_within_s": time.monotonic() - t_drop}
            check(svc._in_flight.get(MODEL) == 0, "frontend: requests still in flight")
            # 8. the frontend's main in front of the survivor
            main_status = _free_port()
            fe, line = await _spawn(["dynamo_tpu_torch.frontend", "--router-mode", "kv",
                                     "--http-host", "127.0.0.1", "--http-port", "0",
                                     "--status-port", str(main_status), "--digest-window",
                                     str(OBS_DIGEST_WINDOW_S)], root,
                                    "frontend serving at", os.path.join(root, "frontend.log"),
                                    env=OBS_ENV)
            procs["frontend"] = fe
            fe_port = int(line.rsplit(":", 1)[1])

            def listed():
                status, _, data = _http(fe_port, "GET", "/v1/models")
                return [m["id"] for m in json.loads(data)["data"]] if status == 200 else []

            t0 = time.monotonic()
            while not (models := await asyncio.to_thread(listed)):
                check(time.monotonic() - t0 < 60, "frontend: the main lists no model")
                await asyncio.sleep(0.1)
            check(models == [MODEL], f"frontend: the main lists {models}")

            async def main_sees_survivor():
                while not (await _obs_get(main_status, "/debug/fleet"))["workers"]:
                    await asyncio.sleep(0.1)

            await asyncio.wait_for(main_sees_survivor(), 60)
            status, heads, data = await asyncio.to_thread(
                _http, fe_port, "POST", "/v1/completions",
                dict(req(prompt(64), 16), stream=True, stream_options={"include_usage": True}))
            events = _sse(data)
            check(status == 200 and events[-1:] == ["[DONE]"]
                  and json.loads(events[-2])["usage"]["completion_tokens"] == 16,
                  f"frontend: the main's stream answered {status}, ends {events[-2:]}")
            # the main's status port: its routing names the survivor, its
            # fleet row counts the request, its ring and the survivor's
            # join the request's trace
            main_rid = heads["X-Request-Id"]
            routed = (await _obs_get(main_status, f"/debug/routing?rid={main_rid}"))["decisions"]
            check([d["chosen"][0] for d in routed] == [survivor_iid],
                  f"frontend: the main routed {routed}, survivor {survivor_iid:x}")
            fe_spans = (await _obs_get(main_status, "/debug/traces"))["spans"]
            tid = _trace_of(fe_spans, main_rid)
            w_spans = (await _obs_get(status_of[survivor_iid],
                                      f"/debug/traces?trace_id={tid}"))["spans"]
            _joined([s for s in fe_spans if s["trace_id"] == tid] + w_spans, tid, main_rid)

            async def main_counts_it():
                while True:
                    rows = (await _obs_get(main_status, "/debug/fleet"))["workers"]
                    n = [r["phases"].get("ttft", {}).get("n", 0) for r in rows.values()
                         if r["worker"][0] == survivor_iid]
                    if n == [1]:
                        return
                    await asyncio.sleep(0.2)

            await asyncio.wait_for(main_counts_it(), 30)
            text = await _obs_get(main_status, "/metrics")
            check(all(n in text for n in OBS_FRONTEND_SERIES),
                  f"frontend: the main's /metrics lacks series: {text[:300]}")
            rc = {}
            for name, proc in (("frontend", fe), ("worker", survivor)):
                t0 = time.monotonic()
                proc.send_signal(signal.SIGTERM)
                rc[name] = await asyncio.wait_for(proc.wait(), SERVE_TIMEOUT_S)
                rec[f"{name}_exit_s"] = time.monotonic() - t0
            check(rc == {"frontend": 0, "worker": 0},
                  f"frontend: exit codes after SIGTERM {rc}")
            rec["main"] = {"serving": line, "models": models, "exit_codes": rc}
            rec["seconds"] = time.monotonic() - t_phase
            return rec
        finally:
            if listener is not None:
                listener.cancel()
            await sub.close()
            for proc in procs.values():
                if proc.returncode is None:
                    proc.kill()
                    await proc.wait()
            if fleet is not None:
                status_srv, observer, task = fleet
                task.cancel()
                await observer.stop()
                await status_srv.stop()
            await svc.stop(drain_timeout=1)
            await rt.shutdown(drain_timeout=1)
            set_exporter(None)

    with tempfile.TemporaryDirectory() as root:
        rec = asyncio.run(asyncio.wait_for(run(root), 900))
    emit(rec)
    return rec



def served_disagg_phase(params, disagg_rec):
    """A prefill and a decode worker served by serve_worker over the TCP
    request plane on loopback, in this process (so the launch counts can
    be read), neither registered colocated: every pull goes host-staged
    through the prefill worker's kv_fetch in chunks of 16 pages. The
    traffic goes through the chain of a `kv` ModelWatcher's model entry
    (the frontend's: migration, backend, PrefillRouter, KvPushRouter),
    whose prefill pool and decode workers come from discovery, and a
    subscriber on the prefill worker's event publisher collects its KV
    events. After the 8 requests, one that repeats the first 1024 tokens
    of the 1500-token prompt must hop to the prefill instance with its
    64 blocks of overlap, once the prefill KvRouter's index holds them."""
    prefill, decode, p_args, d_args = _disagg_engines(params)
    imports = _spy_calls(decode.runner, ("import_pages_device", "import_pages"))
    V, L = prefill.runner.config.vocab_size, prefill.runner.config.n_layers
    reqs, late = workload(V, seed=1)
    prompts = [r["token_ids"] for r in reqs + [late]]
    gen = torch.Generator(device="cpu").manual_seed(17)
    repeat = dict(reqs[5], token_ids=prompts[5][:1024]
                  + torch.randint(0, V, (64,), generator=gen).tolist())
    stored = set()

    async def serve():
        entry, p_w, d_w, close = await _frontend_disagg_fleet(prefill, decode, p_args, d_args)
        pkv = entry.prefill_kv_router
        hops = _spy_routes(pkv)
        addresses = {"prefill": p_w.instance.address, "decode": d_w.instance.address}
        sub = p_w.runtime.event_subscriber([KV_EVENT_SUBJECT])
        sub.connect(p_w.instance.metadata["kv_publisher"])
        pub = p_w.runtime.event_publisher()
        while not pub._subs:
            await asyncio.sleep(0.01)

        async def listen():
            async for _, payload in sub.events():
                stored.update(h for e in payload["events"] if e["kind"] == "store"
                              and e["tier"] == "device" for h in e["block_hashes"])

        listener = asyncio.create_task(listen())
        torch.cuda.synchronize()
        _reset(prefill.runner, decode.runner)
        t0 = time.monotonic()
        try:
            results = await _serve_disagg(entry.chain, reqs, late)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = {name: fn.launches for name, fn in KERNELS.items()}
            stats = dict(prefill.runner.stats), dict(decode.runner.stats)
            n_imports = len(imports["import_pages"])
            want = set(h for p in prompts for h in block_hashes(p, PAGE_SIZE))
            while not want <= stored:  # bounded by the caller's wait_for
                await asyncio.sleep(0.01)
            # the repeated prefix, once the prefill pool's index holds it
            worker = (p_w.instance.instance_id, 0)
            held = block_hashes(repeat["token_ids"][:1024], PAGE_SIZE)
            while pkv.indexer.index.find_matches(held).scores.get(worker, 0) < len(held):
                await asyncio.sleep(0.01)
            rep = await _collect_timed(entry.chain, repeat, "repeat")
            while prefill._parked:
                await asyncio.sleep(0.01)
            return (results, wall, launches, stats, n_imports, d_w, addresses, hops, rep,
                    worker)
        finally:
            listener.cancel()
            await sub.close()
            await close()

    (results, wall, launches, (pst, dst), n_imports, d_w, addresses, hops, rep,
     worker) = asyncio.run(asyncio.wait_for(serve(), 300))
    check(len(hops) == len(results) + 1 and hops[-1][1] == worker and hops[-1][2] >= 63,
          f"served_disagg: the repeated prefix hopped {hops[-1:]}, want {worker} with "
          f">= 63 blocks of overlap")
    check(rep["finish"] == "length" and len(rep["tokens"]) == N_OUT,
          f"served_disagg: the repeated prefix finished {rep['finish']!r}")
    _check_finished("served_disagg", results, V)
    check(d_w.handler.fallbacks == 0,
          f"served_disagg: {d_w.handler.fallbacks} pulls fell back to recompute")
    check(not imports["import_pages_device"],
          f"served_disagg: a pull took the device path: {imports['import_pages_device']}")
    check(dst["prefill_chunks"] == dst["mixed_chunks"] == 0
          and dst["padded_prefill_dispatches"] == 0,
          f"served_disagg: the decode worker prefilled: {dst}")
    n_pages = [-(-len(p) // PAGE_SIZE) for p in prompts]
    chunks = sum(-(-n // DISAGG_CHUNK_PAGES) for n in n_pages)
    check(pst["kv_pages_exported"] == sum(n_pages),
          f"served_disagg: exported {pst['kv_pages_exported']} pages, want {sum(n_pages)}")
    check(launches["gather_pages"] == 2 * chunks,
          f"served_disagg: gather launches {launches['gather_pages']} != {chunks} x 2")
    check(launches["scatter_pages"] == 2 * n_imports,
          f"served_disagg: scatter launches {launches['scatter_pages']} != {n_imports} x 2")
    check(launches["scatter_pages_layers"] == 0, "served_disagg: layer scatter ran")
    both = {k: pst[k] + dst[k] for k in pst}
    check_launches("served_disagg", launches, both, L, copies=True)
    check(not prefill._parked and not prefill.pool.ref,
          "served_disagg: parked pages were not all released")
    page_bytes = L * PAGE_SIZE * prefill.runner.config.n_kv_heads \
        * prefill.runner.config.head_dim * 2 * 2  # both pools, bf16
    ttft = sorted(r["ttft_s"] for r in results)
    rec = {
        "phase": "engine_served_disagg", "model": prefill.runner.config.name,
        "n_layers": L, "requests": len(results), "addresses": addresses,
        "prompt_tokens": [len(p) for p in prompts],
        "output_tokens": [len(r["tokens"]) for r in results],
        "prefill_stats": pst, "decode_stats": dst, "launches": launches,
        "chunks_pulled": chunks, "import_calls": n_imports,
        "fallbacks": d_w.handler.fallbacks, "stored_blocks": len(stored),
        "transfer_tcp": _transfer(n_pages, results, page_bytes),
        "transfer_in_process_host": disagg_rec["transfer"]["host"],
        "ttft_s_min": ttft[0], "ttft_s_median": ttft[len(ttft) // 2],
        "ttft_s_max": ttft[-1], "wall_s": wall,
        "output_tok_s_overall": sum(len(r["tokens"]) for r in results) / wall,
        "prefill_hop_overlap_blocks": [h[2] for h in hops],
        "repeat_ttft_s": rep["ttft_s"],
    }
    emit(rec)
    return rec


TIER_ARGS = ["--model", "llama-3.2-3b", "--num-pages", "160", "--page-size", "16",
             "--max-seq-len", "4096", "--max-batch", "8", "--chunk-size", "512"]
TIER_HOST = ["--host-kv-blocks", "512", "--onboard-layer-groups", "4"]
G2_PAIRS = 1  # the G2 onboard against the cold prefill, in this many pairs
# the lower tiers' cases: a host tier of 16 blocks, fewer than A's
# 64-block shared chain, so A's pages spill past it ("{root}": a
# temporary directory of the case)
TIER_SMALL_HOST = ["--host-kv-blocks", "16", "--onboard-layer-groups", "4"]
TIER_CASES = {
    # name: (worker flags, the label of the onboard's deepest tier)
    "g3": (TIER_SMALL_HOST + ["--disk-kv-blocks", "512", "--disk-kv-root", "{root}/g3"],
           "G3"),
    "g4": (TIER_SMALL_HOST + ["--obj-kv-root", "{root}/g4"], "G4"),
    "quant": (TIER_HOST + ["--kv-tier-quantize"], "G2"),
}


def _tier_prompts(V, seed=5):
    """A (1100 tokens), two 1500-token fillers that evict A's pages from
    the 160-page pool, and A2: A's first 1024 tokens + 100 new ones, with
    the hashes of its 64 blocks shared with A."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def prompt(n):
        return torch.randint(0, V, (n,), generator=gen).tolist()

    a = prompt(1100)
    fillers = [prompt(1500), prompt(1500)]
    a2 = a[:1024] + prompt(100)
    shared = block_hashes(a2, PAGE_SIZE)[:1024 // PAGE_SIZE]
    return a, fillers, a2, shared


def _tier_req(p):
    return {"token_ids": p, "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": N_OUT, "stop_ids": []}}


async def _tier_serve(engine, prompts, tag):
    return [await _collect_timed(engine, _tier_req(p), f"{tag}{i}")
            for i, p in enumerate(prompts)]


def _run(coro, bound=300):
    return asyncio.run(asyncio.wait_for(coro, bound))


def _onboard_labels(engine):
    """Record each onboard's onboard_tier (the deepest tier it read)."""
    labels = []
    orig = engine.scheduler.host_onboard

    def spy(pages, hashes, seq=None):
        ok = orig(pages, hashes, seq)
        labels.append(seq.onboard_tier if seq is not None else None)
        return ok

    engine.scheduler.host_onboard = spy
    return labels


def _reset_offloads(*engines):
    for e in engines:
        e.offload_stats.update(offloads=0, batches=0, seconds=0.0)


def _tier_identities(name, launches, runners, engines, onboards=None, promoted=0,
                     dequantized=0):
    """The copy kernels' launches against the transfer counts: an
    offload batch (one alloc's evicted pages) gathers once a pool part,
    a grouped onboard scatters each group once a pool part, a prefetch
    promotion scatters its page once a pool part; every offloaded page
    was exported. A quantizing tier's offload batch quantizes once a
    pool on the device, and each of its `dequantized` onboards (codes
    into dense pools) dequantizes each group once a pool."""
    parts = 2 if runners[0].kv_quantize else 1
    groups = len(layer_group_bounds(runners[0].config.n_layers,
                                    engines[0].onboard_layer_groups))
    exported = sum(r.stats["kv_pages_exported"] for r in runners)
    scatters = sum(r.stats["kv_layer_group_scatters"] for r in runners)
    batches = sum(e.offload_stats["batches"] for e in engines)
    offloads = sum(e.offload_stats["offloads"] for e in engines)
    check(exported == offloads,
          f"{name}: {exported} pages exported for {offloads} offloaded")
    check(launches["gather_pages"] == 2 * parts * batches,
          f"{name}: gathers {launches['gather_pages']} for {batches} offload "
          f"batches x {parts} parts")
    if onboards is not None:
        check(scatters == onboards * groups,
              f"{name}: {scatters} layer-group scatters for {onboards} onboards")
    check(launches["scatter_pages_layers"] == 2 * parts * scatters,
          f"{name}: layer scatters {launches['scatter_pages_layers']} != "
          f"{scatters} groups x 2 pools x {parts} parts")
    check(launches["scatter_pages"] == 2 * parts * promoted,
          f"{name}: whole-pool scatters {launches['scatter_pages']} for "
          f"{promoted} promotions")
    quantizing = sum(e.offload_stats["batches"] for e in engines if e.kv_tier_quantize)
    check(launches["tier_quantize"] == 2 * quantizing,
          f"{name}: tier quantizes {launches['tier_quantize']} for {quantizing} "
          "quantized offload batches")
    check(launches["tier_dequantize"] == 2 * groups * dequantized,
          f"{name}: tier dequantizes {launches['tier_dequantize']} for "
          f"{dequantized} onboards of codes into dense pools")


def _pages_hold(name, runner, engine, shared, native=False):
    """The device pages of `shared` hold the tiers' blocks: their dense
    bytes (dequantized by the tier codec when the tier quantizes), or,
    native, the tier's codes and scales."""
    pages = [engine.pool.by_hash[h] for h in shared]
    if native:
        raw = [engine.host_pool.host.get_block_raw(h) for h in shared]
        for pool, j in ((runner.k_pool, 0), (runner.v_pool, 1)):
            q = torch.stack([b[j]["q"] for b in raw], dim=1)
            sc = torch.stack([b[j]["s"] for b in raw], dim=1)
            check(torch.equal(pool["q"][:, pages].cpu(), q)
                  and torch.equal(pool["s"][:, pages].cpu(), sc),
                  f"{name}: onboarded codes/scales differ from the tier's")
        return
    hk, hv = engine.host_pool.get(shared)
    check(torch.equal(runner.k_pool[:, pages].cpu(), hk)
          and torch.equal(runner.v_pool[:, pages].cpu(), hv),
          f"{name}: onboarded pages differ from the tiers' bytes")


def _common_prefix(x, y) -> int:
    n = 0
    for a, b in zip(x, y):
        if a != b:
            break
        n += 1
    return n


def _tier_case(runner, name, extra, prompts, cold, deepest, native=False):
    """One engine over `runner` with the tier flags `extra`: serve A and
    the fillers, flush the lower tiers, then A2, whose 64 shared blocks
    onboard from the tiers in 4 layer groups. Held: the stream equals the
    cold engine's (a quantized tier's is reported), the onboard's label is
    the deepest tier's, nothing is recomputed, the copy kernels' launch
    identities, and the pages hold the tiers' blocks."""
    a, fillers, a2, shared = prompts
    V = runner.config.vocab_size
    lossy = "--kv-tier-quantize" in extra
    root = tempfile.mkdtemp(prefix="chip_smoke_tiers_")
    eng = build_engine(parse_args(TIER_ARGS + [x.replace("{root}", root)
                                                for x in extra]), runner=runner)
    labels = _onboard_labels(eng)
    torch.cuda.synchronize()
    _reset(runner)
    t0 = time.monotonic()
    try:
        warm = _run(_tier_serve(eng, [a] + fillers, f"{name}_"))
        for t in (eng.host_pool.disk, eng.host_pool.obj):
            if t is not None:
                t.flush()
        where = eng.host_pool.residency(shared)
        before = eng.scheduler.reused_prefix_tokens
        hit = _run(_tier_serve(eng, [a2], f"{name}_hit"))
        reused = eng.scheduler.reused_prefix_tokens - before
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {n: fn.launches for n, fn in KERNELS.items()}
        st = dict(runner.stats)
        _check_finished(f"tiers_{name}", warm + hit, V)
        # a quantized tier onboards other bytes than the cold prefill
        # wrote (one int8 rounding), so its greedy stream may part from
        # the cold one on a near-tie: reported, and held to the JAX
        # engine's with the same tier on the CPU (test_torch_kv_tiers)
        same = _common_prefix(hit[0]["tokens"], cold["tokens"])
        check(same == N_OUT or lossy,
              f"tiers_{name}: the onboarded stream differs from the cold prefill's")
        check(reused == 1024 and eng.onboard_stats["blocks"] == len(shared),
              f"tiers_{name}: A2 reused {reused} tokens, "
              f"{eng.onboard_stats['blocks']} blocks onboarded")
        tier = {"G2": "host", "G3": "disk", "G4": "obj"}[deepest]
        check(where.count(tier) == len(shared),
              f"tiers_{name}: only {where.count(tier)} of A's {len(shared)} shared "
              f"pages reached the {tier} tier")
        check(labels == [deepest], f"tiers_{name}: onboard labels {labels}")
        check(eng.tier_stats["onboard_misses"] == 0,
              f"tiers_{name}: {eng.tier_stats['onboard_misses']} recomputes")
        # codes onboard into dense pools from an all-G2 chain of a
        # quantizing tier
        dequantized = int(lossy and deepest == "G2" and not runner.kv_quantize)
        _tier_identities(f"tiers_{name}", launches, [runner], [eng], onboards=1,
                         dequantized=dequantized)
        _pages_hold(f"tiers_{name}", runner, eng, shared, native)
        # the lower tier's reads of the 64 blocks again, alone
        # (pools define __len__: an empty tier is falsy, so test for None)
        lower = eng.host_pool.disk if eng.host_pool.disk is not None else eng.host_pool.obj
        reads_s = None
        if lower is not None and deepest != "G2":
            t_read = time.perf_counter()
            for h in shared:
                lower.get_block(h)
            reads_s = time.perf_counter() - t_read
        rec = {
            "phase": f"engine_tiers_{name}", "flags": extra,
            "residency_before_A2": {t: where.count(t) for t in sorted(set(where))},
            "onboard_labels": labels, "stats": st, "launches": launches,
            "tiers": dict(eng.host_pool.stats), "onboard": dict(eng.onboard_stats),
            "offload": dict(eng.offload_stats), "tier_stats": dict(eng.tier_stats),
            "kv_onboard_ewma": eng.kv_onboard_ewma, "reused_prefix_tokens_A2": reused,
            "kv_onboard_s": hit[0]["phases"].get("kv_onboard_s"),
            "ttft_s_A2_onboarded": hit[0]["ttft_s"], "ttft_s_A2_cold": cold["ttft_s"],
            "phases": {k: v for k, v in hit[0]["phases"].items() if k != "itl_s"},
            "tokens_equal_cold": same, "lower_reads_again_s": reads_s, "wall_s": wall,
        }
    finally:
        eng.stop()
        shutil.rmtree(root, ignore_errors=True)
    emit(rec)
    return rec, eng


def _onboard_device_time(runner, engine, shared, groups, reps=3):
    """The 64-block onboard through the runner alone, on the device
    clock's terms: the blocks' copies to the card and the layer
    scatters, ending in a synchronize (host clock around it)."""
    blocks = engine.host_pool.host.get_blocks(shared)
    pages = [engine.pool.by_hash[h] for h in shared]
    ks, vs = [b[0] for b in blocks], [b[1] for b in blocks]
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.import_page_tensors(pages, ks, vs, layer_groups=groups)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)


def _cold_a2(runner, a2, seed):
    """A2 on a cold engine, after an unrelated prompt of A2's length
    (the engine warm, nothing of A2 cached)."""
    cold = build_engine(parse_args(TIER_ARGS), runner=runner)
    warm_up = _tier_prompts(runner.config.vocab_size, seed=seed)[2]
    try:
        return _run(_tier_serve(cold, [warm_up, a2], f"cold{seed}_"))[1]
    finally:
        cold.stop()


def g2_pairs(runner, prompts, n_pairs):
    """The G2 case and the cold prefill of A2 in `n_pairs` pairs, the
    side that runs first alternating (host clocks move between calls and
    machines); each onboarded stream is held to the first cold one.
    Returns the pairs' TTFTs, the G2 cases' records, the cold outputs and
    the first G2 case's engine."""
    pairs, colds, cases, first_eng = [], [], [], None
    for i in range(n_pairs):
        cold_first = i % 2 == 0
        if cold_first:
            colds.append(_cold_a2(runner, prompts[2], 6 + i))
        case, eng = _tier_case(runner, "g2" if i == 0 else f"g2_{i + 1}",
                               TIER_HOST, prompts, colds[0], "G2")
        if not cold_first:
            colds.append(_cold_a2(runner, prompts[2], 6 + i))
        cases.append(case)
        if i == 0:
            first_eng = eng
        pairs.append({"first": "cold" if cold_first else "onboarded",
                      "ttft_s_A2_onboarded": case["ttft_s_A2_onboarded"],
                      "ttft_s_A2_cold": colds[-1]["ttft_s"]})
    return pairs, cases, colds, first_eng


def tiers_phase(params):
    """The KV tiers of the 3B, each case an engine over one runner.
    `engine_tiers` (G2): a 512-block host tier; A, two fillers that evict
    A's pages to the host, then A2 onboarded from the host in 4 layer
    groups, against a cold engine over the same runner that serves A2,
    in G2_PAIRS pairs (g2_pairs); with the offload's cost a page, the
    onboard's rate and A2's TTFT onboarded and cold. Then the G3 disk and G4 object tiers under a
    16-block host tier, the quantized tier on bf16 pools (the pages equal
    the codec's dequantization of the offloaded ones) and on int8 pools
    (codes and scales passed through), a remote-G2 pull between two
    workers over TCP through the KV router's hint, and a prefetch hint
    that promotes A2's blocks before A2 arrives. Returns the G2 case's
    launches, with the device codec's from the quantized case."""
    runner, _ = build_runner(parse_args(TIER_ARGS), params=params)
    prompts = _tier_prompts(runner.config.vocab_size)
    a, fillers, a2, shared = prompts
    L = runner.config.n_layers
    pairs, cases, colds, eng = g2_pairs(runner, prompts, G2_PAIRS)
    rec, cold_out = cases[0], colds[0]
    check(rec["offload"]["offloads"] == rec["tiers"]["offloaded"]
          == rec["stats"]["kv_pages_exported"],
          f"tiers: offloads {rec['offload']} against the host tier's {rec['tiers']}")
    launches = dict(rec["launches"])
    # (a) the G2 timings: the offload a page, the onboard's rate (the
    # engine's host clock, and the runner alone ending in a synchronize)
    onboard_bytes = len(shared) * 2 * L * PAGE_SIZE * runner.config.n_kv_heads \
        * runner.config.head_dim * 2
    device_s = _onboard_device_time(runner, eng, shared, eng.onboard_layer_groups)
    onboard = rec["onboard"]
    emit({"phase": "engine_tiers", "model": runner.config.name, "n_layers": L,
          "num_pages": runner.num_pages, "host_kv_blocks": eng.host_pool.host.capacity,
          "onboard_layer_groups": eng.onboard_layer_groups,
          "prompt_tokens": {"A": len(a), "fillers": [len(f) for f in fillers],
                            "A2": len(a2), "A2_shared_with_A": 1024},
          "launches": launches, "onboard": onboard, "offload": rec["offload"],
          "offload_ms_per_page": rec["offload"]["seconds"]
          / max(1, rec["offload"]["offloads"]) * 1e3,
          "offload_ms_per_batch": rec["offload"]["seconds"]
          / max(1, rec["offload"]["batches"]) * 1e3,
          "onboard_bytes": onboard_bytes,
          "onboard_gb_per_s": onboard_bytes / onboard["seconds"] / 1e9,
          "onboard_synced_s": device_s,
          "onboard_synced_gb_per_s": onboard_bytes / device_s[0] / 1e9,
          "kv_onboard_s": rec["kv_onboard_s"],
          "g2_pairs": pairs,
          "ttft_s_A2_onboarded": [c["ttft_s_A2_onboarded"] for c in cases],
          "ttft_s_A2_cold": [c["ttft_s"] for c in colds],
          "phases_A2_onboarded": [c["phases"] for c in cases],
          "phases_A2_cold": [{k: v for k, v in c["phases"].items() if k != "itl_s"}
                             for c in colds],
          "wall_s": rec["wall_s"]})
    check(launches["gather_pages"] > 0 and launches["scatter_pages_layers"] > 0,
          f"tiers: a copy kernel never launched: {launches}")
    emit({"phase": "tier_cost_feed", **tier_cost_feed(eng)})
    del eng
    # (b) G3, (c) G4, (d) the quantized tier on bf16 pools
    for name, (extra, deepest) in TIER_CASES.items():
        case, _ = _tier_case(runner, name, extra, prompts, cold_out, deepest)
        if name == "quant":
            for k in ("tier_quantize", "tier_dequantize"):
                launches[k] = case["launches"][k]
    # (d) the quantized tier on int8 pools: codes and scales pass through
    r8, _ = build_runner(parse_args(TIER_ARGS + ["--kv-quantize", "int8"]), params=params)
    cold8 = build_engine(parse_args(TIER_ARGS + ["--kv-quantize", "int8"]), runner=r8)
    warm_up = _tier_prompts(runner.config.vocab_size, seed=6)[2]
    try:
        cold8_out = _run(_tier_serve(cold8, [warm_up, a2], "cold8_"))[1]
    finally:
        cold8.stop()
    _tier_case(r8, "quant_int8", TIER_HOST + ["--kv-quantize", "int8", "--kv-tier-quantize"],
               prompts, cold8_out, "G2", native=True)
    free(r8)
    # (e) remote G2 and (f) prefetch, over TCP
    _run(_tier_fleet(params, runner, prompts, cold_out), 600)
    free(runner)
    return launches


async def _tier_fleet(params, runner, prompts, cold):
    """(e) Worker A (the runner, `--prefetch`) and worker B (a second
    runner on the same params) served over TCP; a KvRouter on a third
    runtime hears their KV events. A serves A and the fillers, so A's
    shared blocks sit in A's host tier; A2 routed to B carries the
    router's `kv_remote_host` hint, and B pulls A's blocks through A's
    kv_host_fetch: no recompute, B's pages hold A's bytes. (f) The
    router's `kv_prefetch` hint for A2 on A promotes the 64 blocks before
    A2 reaches A, which then claims them (hits) with no onboard."""
    a, fillers, a2, shared = prompts
    V = runner.config.vocab_size
    rb, _ = build_runner(parse_args(TIER_ARGS), params=params)
    args_a = parse_args(TIER_ARGS + TIER_HOST + ["--prefetch"])
    args_b = parse_args(TIER_ARGS + TIER_HOST)
    eng_a = build_engine(args_a, runner=runner)
    eng_b = build_engine(args_b, runner=rb)
    realm = "tcp-tiers"
    rts = [_runtime(realm, "tcp", "tcp") for _ in range(3)]
    wa = await serve_args(rts[0], eng_a, args_a, colocated=False)
    wb = await serve_args(rts[1], eng_b, args_b, colocated=False)
    a_id, b_id = wa.instance.instance_id, wb.instance.instance_id
    client = rts[2].client("dyn/tpu-worker/generate")
    kv = KvRouter(rts[2], client, block_size=PAGE_SIZE)
    push = KvPushRouter(kv)
    try:
        await client.wait_ready(timeout=60)
        while len(client.instances) < 2:
            await asyncio.sleep(0.01)
        await kv.start()
        warm = []
        for i, p in enumerate([a] + fillers):
            warm.append(await _collect_timed(_Direct(client, a_id), _tier_req(p), f"fa{i}"))
        host = kv.indexer.host_index
        hashes = block_hashes(a2, PAGE_SIZE)
        while host.find_matches(hashes).scores.get((a_id, 0), 0) < len(shared):
            await asyncio.sleep(0.01)
        # (e): A2 on B, pulled from A's host tier
        torch.cuda.synchronize()
        _reset(runner, rb)
        _reset_offloads(eng_a, eng_b)
        before = eng_b.scheduler.reused_prefix_tokens
        ctx_meta = {"target_instance": b_id}
        hit_b = await _collect_timed(_Pinned(push, ctx_meta), _tier_req(a2), "remote")
        torch.cuda.synchronize()
        launches_e = {n: fn.launches for n, fn in KERNELS.items()}
        reused_b = eng_b.scheduler.reused_prefix_tokens - before
        _check_finished("tiers_remote", warm + [hit_b], V)
        check(hit_b["tokens"] == cold["tokens"],
              "tiers_remote: B's stream differs from the cold prefill's")
        ts = dict(eng_b.tier_stats)
        check(ts["remote_pulls"] == 1 and ts["remote_blocks"] == len(shared)
              and ts["remote_failures"] == 0 and ts["onboard_misses"] == 0
              and reused_b == 1024,
              f"tiers_remote: B pulled {ts}, reused {reused_b} tokens")
        _tier_identities("tiers_remote", launches_e, [runner, rb], [eng_a, eng_b],
                         onboards=1)
        pages_b = [eng_b.pool.by_hash[h] for h in shared]
        hk, hv = eng_a.host_pool.get(shared)
        check(torch.equal(rb.k_pool[:, pages_b].cpu(), hk)
              and torch.equal(rb.v_pool[:, pages_b].cpu(), hv),
              "tiers_remote: B's pages differ from A's host blocks")
        emit({"phase": "engine_tiers_remote", "launches": launches_e,
              "tier_stats_B": ts, "onboard_B": dict(eng_b.onboard_stats),
              "kv_onboard_ewma_B": eng_b.kv_onboard_ewma,
              "pull_bytes": len(shared) * 2 * hk[:, 0].numel() * 2,
              "reused_prefix_tokens_A2": reused_b, "ttft_s_A2_remote": hit_b["ttft_s"],
              "ttft_s_A2_cold": cold["ttft_s"], "phases": hit_b["phases"]})
        # (f): the router's prefetch hint for A2 on A, then A2 on A
        torch.cuda.synchronize()
        _reset(runner, rb)
        _reset_offloads(eng_a, eng_b)
        overlap = kv.indexer.index.find_matches(hashes).scores.get((a_id, 0), 0)
        hint = kv.prefetch_hint(hashes, (a_id, 0), overlap, None)
        check(hint is not None and hint["hashes"] == shared[overlap:],
              f"tiers_prefetch: the router's hint {hint and len(hint['hashes'])}")
        t_hint = time.monotonic()
        kv.emit_prefetch(a_id, hint)
        pf = eng_a.prefetch
        while (pf.stats["promoted"] + pf.stats["lost"] + pf.stats["no_space"]
               + pf.stats["dup"] < len(hint["hashes"])):
            check(time.monotonic() - t_hint < 60, f"tiers_prefetch: {pf.stats}")
            await asyncio.sleep(0.005)
        promote_s = time.monotonic() - t_hint
        before = eng_a.scheduler.reused_prefix_tokens
        onboards = eng_a.onboard_stats["onboards"]
        hit_a = await _collect_timed(_Direct(client, a_id), _tier_req(a2), "prefetched")
        torch.cuda.synchronize()
        launches_f = {n: fn.launches for n, fn in KERNELS.items()}
        reused_a = eng_a.scheduler.reused_prefix_tokens - before
        pst = dict(pf.stats)
        check(hit_a["tokens"] == cold["tokens"],
              "tiers_prefetch: the prefetched stream differs from the cold prefill's")
        check(pst["promoted"] == len(hint["hashes"]) and pst["hits"] == pst["promoted"] > 0
              and eng_a.onboard_stats["onboards"] == onboards and reused_a == 1024
              and eng_a.tier_stats["onboard_misses"] == 0,
              f"tiers_prefetch: {pst}, reused {reused_a}")
        _tier_identities("tiers_prefetch", launches_f, [runner, rb], [eng_a, eng_b],
                         onboards=0, promoted=pst["promoted"])
        emit({"phase": "engine_tiers_prefetch", "launches": launches_f,
              "prefetch": pst, "promote_s": promote_s, "reused_prefix_tokens_A2": reused_a,
              "ttft_s_A2_prefetched": hit_a["ttft_s"], "ttft_s_A2_cold": cold["ttft_s"]})
    finally:
        await kv.stop()
        await client.close()
        for rt in rts:
            await rt.shutdown(drain_timeout=10)
        for w in (wa, wb):
            await w.stop()
        free(rb)


class _Direct:
    """generate() straight to one instance through a client."""

    def __init__(self, client, instance_id):
        self.client, self.instance_id = client, instance_id

    def generate(self, req, ctx):
        return self.client.direct(req, self.instance_id, ctx)


class _Pinned:
    """generate() through a KvPushRouter with metadata set on the context
    (target_instance)."""

    def __init__(self, push, meta):
        self.push, self.meta = push, meta

    def generate(self, req, ctx):
        ctx.metadata.update(self.meta)
        return self.push.generate(req, ctx)


# -- the sampling extras, guided decoding, branches and embeddings ----------
EXTRAS_OUT = 16  # output tokens of the sampling-extras requests
# within the device table budget at V 128256 (53 DFA states of the 65 that
# DEVICE_TABLE_MAX_ELEMS admits): the guided rows' masks come from the
# device tables
GUIDED_PATTERN = r"(yes|no) sir, the (red|green|blue) one is (first|second|third)!"
# over it (165 states): the host mask callback
GUIDED_SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "maxLength": 12}, "age": {"type": "integer"},
    "tags": {"type": "array", "items": {"enum": ["a", "b"]}, "maxItems": 3}},
    "required": ["name", "age", "tags"], "additionalProperties": False}
# the frontend's response_format schema (33 states)
FRONTEND_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "n": {"enum": [1, 2, 3]}},
    "required": ["ok", "n"], "additionalProperties": False}
EXTRAS_B = 8  # the decode batch of the extras' step costs
EMBED_SHAPE = (3, 128)  # the embed pass timed: 3 prompts of 128 tokens


def _in_language(pattern: str, toks, finish) -> bool:
    """A guided output is accepted by its byte DFA: every token extends
    the constraint, and a `stop` ended in an accepting state (a `length`
    finish may stop on a prefix)."""
    from dynamo_tpu_torch.guided import compile_regex

    dfa = compile_regex(pattern)
    s = dfa.start
    for t in toks:
        if not 0 <= t < 256 or dfa.trans[s, t] < 0:
            return False
        s = int(dfa.trans[s, t])
    return finish != "stop" or bool(dfa.accept[s])


async def _items(engine, req, rid):
    """Every item of one request through an engine."""
    out = []
    async for item in engine.generate(req, Context(request_id=rid)):
        check(item.get("finish_reason") != "error", f"request {rid}: {item}")
        out.append(item)
    return out


def _tokens(items):
    return [t for it in items for t in it["token_ids"]]


def _repeats(prompt, toks) -> bool:
    """Whether a stream emits a token already in its prompt or output."""
    seen = set(prompt)
    for t in toks:
        if t in seen:
            return True
        seen.add(t)
    return False


def _extras_engine(runner):
    engine = build_engine(parse_args(ENGINE_ARGS), runner=runner)
    torch.cuda.synchronize()
    _reset(runner)
    return engine


def _extras_record(phase, runner, engine, smi, t0):
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    stats = dict(runner.stats)
    check_launches(phase, launches, stats, runner.config.n_layers)
    return {"phase": f"engine_{phase}", "model": runner.config.name, "nvidia_smi": smi,
            "fused_mixed": engine.fused_mixed, "stats": stats, "launches": launches,
            "wall_s": time.monotonic() - t0}


def sampling_ext_phase(runner, smi):
    """`engine_sampling_ext` on the 3B: a request with logprobs (top 5), one
    with repetition and frequency penalties, one with logit_bias (-100 on
    its greedy first token, +100 on another), served together; the
    penalty prompt is the first of a few whose unpenalised greedy stream
    repeats a token. Holds: a greedy row's chosen token is its report's
    top entry (logprob and id), reports <= 0 and sorted; the banned token
    never appears and the forced one always; the penalised stream differs
    from the unpenalised one; and the launch identities, with no ragged
    launch: every mixed plan holds the logprob row, so each ran the
    two-dispatch path (decode kernel, then the prefill kernel)."""
    V = runner.config.vocab_size
    gen = torch.Generator(device="cpu").manual_seed(31)

    def prompt(n, motif=None):
        if motif is None:
            return torch.randint(0, V, (n,), generator=gen).tolist()
        m = torch.randint(0, V, (motif,), generator=gen).tolist()
        return (m * (n // motif + 1))[:n]

    def req(p, n_out=EXTRAS_OUT, sampling=None, **extra):
        return {"token_ids": p, "sampling": {"temperature": 0.0, **(sampling or {})},
                "stop": {"max_tokens": n_out, "stop_ids": []}, **extra}

    async def run(engine):
        rec = {}
        # the penalty prompt: the first whose unpenalised greedy stream
        # repeats a token
        plain = None
        for i in range(6):
            p = prompt(200, motif=8 if i % 2 else None)
            toks = _tokens(await _items(engine, req(p), f"plain{i}"))
            if _repeats(p, toks):
                pen_prompt, plain = p, toks
                break
        check(plain is not None, "sampling_ext: no unpenalised greedy stream of six "
              "prompts repeats a token")
        bias_prompt = prompt(150)
        first = _tokens(await _items(engine, req(bias_prompt, 1), "bias_probe"))[0]
        forced = (first + 1 + int(torch.randint(0, V - 1, (1,), generator=gen))) % V
        _reset(runner)
        t0 = time.monotonic()
        lp_req = req(prompt(180), sampling={"logprobs": 5})
        pen_req = req(pen_prompt, sampling={"repetition_penalty": 2.0,
                                             "frequency_penalty": 0.5})
        bias_req = req(bias_prompt, logit_bias=[[first, -100.0], [forced, 100.0]])
        lp, pen, bias = await asyncio.gather(
            _items(engine, lp_req, "logprobs"), _items(engine, pen_req, "penalties"),
            _items(engine, bias_req, "bias"))
        rec.update(_extras_record("sampling_ext", runner, engine, smi, t0))
        entries = [e for it in lp for e in it.get("logprobs") or []]
        toks = _tokens(lp)
        check(len(entries) == len(toks) == EXTRAS_OUT,
              f"sampling_ext: {len(entries)} logprob entries for {len(toks)} tokens")
        for t, e in zip(toks, entries):
            # the top id, or one tied with it (bf16 logits do tie)
            top = e["top_logprobs"]
            check(len(e["top_ids"]) == 5 and e["logprob"] == top[0]
                  and t in e["top_ids"] and top[e["top_ids"].index(t)] == top[0],
                  f"sampling_ext: greedy token {t} is not its report's top: {e}")
            tops = e["top_logprobs"]
            check(all(v <= 0 for v in tops) and tops == sorted(tops, reverse=True),
                  f"sampling_ext: the report is not <= 0 and sorted: {tops}")
        pen_toks = _tokens(pen)
        check(len(pen_toks) == EXTRAS_OUT and pen_toks != plain,
              f"sampling_ext: the penalised stream equals the unpenalised {plain}")
        bias_toks = _tokens(bias)
        check(bias_toks == [forced] * EXTRAS_OUT and first not in bias_toks,
              f"sampling_ext: bias -100 on {first}, +100 on {forced} gave {bias_toks}")
        st = rec["stats"]
        check(st["decode_steps"] > 0 and st["ragged_mixed_dispatches"] == 0,
              f"sampling_ext: the logprob and penalty rows left the two-dispatch path: {st}")
        rec.update(logprob_entries=len(entries), first_entry=entries[0],
                   penalty_prompt_repeats=True, plain_stream=plain,
                   penalised_stream=pen_toks, banned=first, forced=forced)
        return rec

    engine = _extras_engine(runner)
    try:
        rec = asyncio.run(asyncio.wait_for(run(engine), 300))
    finally:
        engine.stop()
    emit(rec)


def guided_phase(runner, smi):
    """`engine_guided` on the 3B: a regex request within the device table
    budget (GUIDED_PATTERN), with a 1500-token prompt sent once its first
    token is out, so its fused plans ride the ragged kernel: held to
    ragged launches > 0, device-table dispatches > 0 and no host mask
    build; then a JSON-schema request over the budget (GUIDED_SCHEMA) on
    the host fallback (its dispatches and mask builds > 0). Every output
    is accepted by its DFA."""
    from dynamo_tpu_torch.guided import schema_to_regex

    V = runner.config.vocab_size
    gen = torch.Generator(device="cpu").manual_seed(37)
    schema_pattern = schema_to_regex(GUIDED_SCHEMA)

    def req(n, n_out, pattern=None):
        r = {"token_ids": torch.randint(0, V, (n,), generator=gen).tolist(),
             "sampling": {"temperature": 0.0},
             "stop": {"max_tokens": n_out, "stop_ids": [257]}}
        if pattern is not None:
            r["guided"] = {"kind": "regex", "pattern": pattern}
        return r

    async def run(engine):
        first = asyncio.Event()
        t0 = time.monotonic()
        dev = asyncio.ensure_future(_collect_timed(
            engine, req(64, 96, GUIDED_PATTERN), "guided_device", on_first=first))
        await first.wait()
        plain = await _collect_timed(engine, req(1500, 8), "beside_guided")
        dev = await dev
        rec = _extras_record("guided", runner, engine, smi, t0)
        st = rec["stats"]
        check(_in_language(GUIDED_PATTERN, dev["tokens"], dev["finish"]),
              f"guided: {bytes(dev['tokens'])!r} ({dev['finish']}) is not in the language")
        check(rec["launches"]["ragged_paged_attention"] > 0
              and st["ragged_mixed_dispatches"] > 0,
              f"guided: the bounded request's plans did not ride the ragged kernel: {st}")
        check(st["guided_device_dispatches"] > 0 and st["guided_host_dispatches"] == 0
              and st["guided_host_masks"] == 0,
              f"guided: the bounded request built masks on the host: {st}")
        rec["device"] = {"text": bytes(dev["tokens"]).decode(errors="replace"),
                         "finish": dev["finish"], "beside": plain["finish"]}
        _reset(runner)
        t1 = time.monotonic()
        host = await _collect_timed(engine, req(48, 64, schema_pattern), "guided_host")
        hrec = _extras_record("guided_host", runner, engine, smi, t1)
        hst = hrec["stats"]
        check(_in_language(schema_pattern, host["tokens"], host["finish"]),
              f"guided: {bytes(host['tokens'])!r} ({host['finish']}) breaks the schema")
        check(hst["guided_host_dispatches"] > 0 and hst["guided_host_masks"] > 0
              and hst["guided_device_dispatches"] == 0,
              f"guided: the schema over the budget left the host fallback: {hst}")
        rec["host"] = {"text": bytes(host["tokens"]).decode(errors="replace"),
                       "finish": host["finish"], "stats": hst,
                       "launches": hrec["launches"]}
        return rec

    engine = _extras_engine(runner)
    try:
        rec = asyncio.run(asyncio.wait_for(run(engine), 300))
    finally:
        engine.stop()
    emit(rec)


def branches_phase(runner, smi):
    """`engine_branches` on the 3B: an n = 4 seeded request (temperature
    0.8) on a 300-token prompt, twice on fresh engines. Holds: four
    finishes, one per choice; one prefill pass (the prefill kernel's
    launches one request's); pool.forks 3 (one fork_table a branch past
    the parent) and copy_pages called; four distinct streams, equal on
    the second run."""
    V = runner.config.vocab_size
    gen = torch.Generator(device="cpu").manual_seed(41)
    req = {"token_ids": torch.randint(0, V, (300,), generator=gen).tolist(),
           "sampling": {"temperature": 0.8, "seed": 77, "n": 4},
           "stop": {"max_tokens": EXTRAS_OUT, "stop_ids": []}}
    runs, rec = [], None
    for turn in range(2):
        engine = _extras_engine(runner)
        t0 = time.monotonic()
        try:
            items = asyncio.run(asyncio.wait_for(_items(engine, req, f"branch{turn}"), 300))
        finally:
            engine.stop()
        streams = {}
        finishes = []
        for it in items:
            streams.setdefault(it["index"], []).extend(it["token_ids"])
            if it["finish_reason"]:
                finishes.append(it["index"])
        runs.append(streams)
        if turn == 0:
            rec = _extras_record("branches", runner, engine, smi, t0)
            st = rec["stats"]
            check(sorted(finishes) == [0, 1, 2, 3], f"branches: finishes {finishes}")
            check(st["prefill_chunks"] == 1 and st["padded_prefill_dispatches"] == 0,
                  f"branches: not one prefill pass: {st}")
            check(engine.pool.forks == 3 and st["page_copies"] >= 1,
                  f"branches: forks {engine.pool.forks}, page copies {st['page_copies']}")
            check(len({tuple(s) for s in streams.values()}) == 4
                  and all(len(s) == EXTRAS_OUT for s in streams.values()),
                  f"branches: streams not four distinct of {EXTRAS_OUT}: {streams}")
            rec.update(forks=engine.pool.forks, streams=streams)
    check(runs[0] == runs[1], "branches: the seeded streams changed on a second run")
    rec["second_run_equal"] = True
    emit(rec)


def extras_variants(runner):
    """The decode loops `extras_costs` times, by name: a 4-step loop at B
    8, 1000 tokens of context a row, with no extras, with penalties
    (1000-token histories), with the top-5 logprob report, with the device
    guided tables (GUIDED_PATTERN) and with the host mask callback
    (GUIDED_SCHEMA). Returns (variants, steps a loop, the device table)."""
    from dynamo_tpu_torch.engine.engine import GuidedMaskContext
    from dynamo_tpu_torch.guided import schema_to_regex
    from dynamo_tpu_torch.guided.device_table import build_device_table

    V = runner.config.vocab_size
    PS = runner.page_size
    T, ctx = 4, 1000
    gen = torch.Generator(device="cpu").manual_seed(43)
    engine = build_engine(parse_args(ENGINE_ARGS), runner=runner)
    try:
        bounded = engine._compile_guided({"kind": "regex", "pattern": GUIDED_PATTERN})
        over = engine._compile_guided({"kind": "regex",
                                       "pattern": schema_to_regex(GUIDED_SCHEMA)})
    finally:
        engine.stop()
    table = build_device_table(bounded)
    check(table is not None and build_device_table(over) is None,
          "extras_costs: the device table budget did not split the two constraints")
    n_pages = -(-(ctx + T) // PS)
    tables = [list(range(i * n_pages, (i + 1) * n_pages)) for i in range(EXTRAS_B)]
    tokens = torch.randint(0, V, (EXTRAS_B,), generator=gen).tolist()
    hist = [torch.randint(0, V, (ctx,), generator=gen).tolist() for _ in range(EXTRAS_B)]
    samp = {"temperature": [0.0] * EXTRAS_B, "top_k": [0] * EXTRAS_B,
            "top_p": [1.0] * EXTRAS_B, "seeds": list(range(EXTRAS_B)),
            "rep": [1.3] * EXTRAS_B, "freq": [0.2] * EXTRAS_B, "presence": [0.0] * EXTRAS_B}
    args = (T, tokens, [ctx] * EXTRAS_B, tables, samp, 1)
    variants = {
        "plain": lambda: runner.decode_multi(*args),
        "penalties": lambda: runner.decode_multi_ex(
            *args, histories=hist, prompt_lens=[ctx] * EXTRAS_B),
        "logprobs": lambda: runner.decode_multi_ex(*args, n_logprobs=5),
        "guided_device": lambda: runner.decode_multi(*args, guided_dev=(
            [table], [(0, bounded.start)] * EXTRAS_B, False)),
        "guided_host": lambda: runner.decode_multi(*args, mask_fn=GuidedMaskContext(
            EXTRAS_B, V, [(i, over, over.start) for i in range(EXTRAS_B)])),
    }
    return variants, T, table


def extras_costs_phase(runner, smi):
    """`extras_costs` on the 3B: one decode step's ms of each of
    extras_variants (a loop with its readback, CUDA-synchronized, over its
    steps; two turns, the second in reverse order), and the embed pass's
    ms for 3 x 128 tokens."""
    variants, T, table = extras_variants(runner)
    V = runner.config.vocab_size
    gen = torch.Generator(device="cpu").manual_seed(47)
    for fn in variants.values():
        fn()  # warm: the guided tables staged, the plane shapes seen
    # two turns, the second in reverse order: the spread beside the means
    step_ms = {name: [] for name in variants}
    for order in (list(variants), list(variants)[::-1]):
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                variants[name]()
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t0) * 1e3 / (5 * T))
    embed_in = [torch.randint(0, V, (EMBED_SHAPE[1],), generator=gen).tolist()
                for _ in range(EMBED_SHAPE[0])]
    vecs = runner.embed(embed_in)
    check(vecs.shape == (EMBED_SHAPE[0], runner.config.dim)
          and abs(float((vecs ** 2).sum(-1).max()) - 1.0) < 1e-3,
          f"extras_costs: embed gave {vecs.shape}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        runner.embed(embed_in)
    torch.cuda.synchronize()
    emit({"phase": "extras_costs", "model": runner.config.name, "nvidia_smi": smi,
          "batch": EXTRAS_B, "context": 1000, "steps_per_loop": T,
          "decode_step_ms": step_ms,
          "embed_ms": (time.perf_counter() - t0) * 1e3 / 5,
          "embed_shape": list(EMBED_SHAPE),
          "device_table_bytes": table.nbytes(), "device_table_states": table.n_states})


def extras_phases(runner, smi):
    """The A.4 phases on the 3B runner: sampling extras, guided decoding,
    branches and the extras' costs."""
    sampling_ext_phase(runner, smi)
    guided_phase(runner, smi)
    branches_phase(runner, smi)
    extras_costs_phase(runner, smi)


# multi-LoRA on the 3B (`engine_lora`): ad-one (rank 8, the default
# targets, zero-padded to the tree's rank) and ad-mlp (rank 16, all seven
# targets) in slots 1 and 2, slot 3 free for a runtime load; the 3B's 8
# requests split over base and the two adapters (the late request shares
# r6's prefix, so it takes r6's adapter)
LORA_ALL_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
LORA_RANK = 16
LORA_TRAFFIC = (None, "ad-one", "ad-mlp", None, "ad-one", "ad-mlp", "ad-one", "ad-one")
LORA_ROWS = (0, 1, 2, 0)  # the forward checks' rows' slots
LORA_STEP_ROWS = (0, 1, 2, 0, 1, 2, 0, 1)  # decode_step_ms's rows' slots


# the adapters' scale (random_adapter's B factor): a delta about a
# quarter of a projection's size, where the bf16 forward stays as close
# to the f32 one on adapter rows as on base rows (0.017-0.019 against
# 0.015-0.016). At 2.0 the random 3B's bf16 forward, plain path and
# kernel path alike, lands 0.29-0.41 relative L2 from its f32 forward on
# adapter rows: PERF.md §6, multi-LoRA
LORA_SCALE = 0.25
# (c) against f32: an adapter row's kernel-path logits within this
# relative L2 of the f32 plain path's (f32 params, factors and pools):
# about 1.5x the base rows' reading there (0.0155-0.0165, PERF.md §6)
LORA_F32_REL_TOL = 0.025


def lora_factors(cfg, name):
    """The phase's adapters, scale LORA_SCALE, at the tree's rank."""
    from dynamo_tpu_torch.models import lora
    from dynamo_tpu_torch.worker import pad_rank

    rank, targets, seed = {"ad-one": (8, lora.DEFAULT_TARGETS, 1),
                           "ad-mlp": (16, LORA_ALL_TARGETS, 2),
                           "ad-late": (16, LORA_ALL_TARGETS, 3)}[name]
    f = lora.random_adapter(cfg, rank, targets, seed=seed, scale=LORA_SCALE)
    return {k: pad_rank(k, a, LORA_RANK) for k, a in f.items()}


def lora_forward_checks(lr, dev):
    """(b) and (c) on one prefill dispatch (4 rows of 64 tokens, slots
    LORA_ROWS) and the decode step after it, each path on scratch pools.
    (b): the LoRA runner's kernel path against the same params without
    adapters on the same kernel path (the LoRA-less runner's forward,
    padded as the LoRA runner's): its base-slot rows bit for bit equal,
    its adapter rows not. (c): the kernel path against the plain path
    (attn_impl "ref") in bf16, every row within FORWARD_REL_TOL as the
    parity phases hold; and its adapter rows against the plain path in
    f32 (params, factors and pools upcast) within LORA_F32_REL_TOL, so an
    error in the delta on the card fails (the base rows' reading there is
    printed beside it). The prefill rows go once more as one flat ragged
    row with a slot a token (the ragged kernel, as a LoRA runner's n-gram
    verify runs them), held to the same two limits. The decode step is
    fed the kernel path's greedy tokens."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.toolkit import make_kv_pool

    def f32(tree):
        return ({k: f32(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.float())

    cfg, params = lr.config, lr.params
    PS, S, B = 16, 64, len(LORA_ROWS)
    per = S // PS + 1
    pages = torch.arange(B * per, dtype=torch.int32, device=dev).view(B, per)
    idx = torch.tensor(LORA_ROWS, dtype=torch.int32, device=dev)
    params32 = f32(params)
    paths = {
        "lora": {"lora": lr.lora, "adapter_idx": idx},
        "base": {},
        "ref": {"lora": lr.lora, "adapter_idx": idx, "attn_impl": "ref"},
        "ref32": {"lora": f32(lr.lora), "adapter_idx": idx, "attn_impl": "ref"},
    }
    pools = {name: make_kv_pool(cfg, B * per + 1, PS,
                                torch.float32 if name == "ref32" else lr.dtype, dev)
             for name in paths}
    gen = torch.Generator(device="cpu").manual_seed(31)
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                        dtype=torch.int32).to(dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S).contiguous()
    steps = []
    base_rows = [i for i, a in enumerate(LORA_ROWS) if a == 0]
    ad_rows = [i for i, a in enumerate(LORA_ROWS) if a != 0]
    for kind in ("prefill", "decode"):
        if kind == "prefill":
            args = (tok, pos, pages, torch.full((B,), S, dtype=torch.int32, device=dev),
                    torch.full((B,), S - 1, dtype=torch.int32, device=dev))
        else:
            args = (nxt[:, None], torch.full((B, 1), S, dtype=torch.int32, device=dev),
                    pages, torch.full((B,), S + 1, dtype=torch.int32, device=dev), None)
        out = {name: llama.forward(cfg, params32 if name == "ref32" else params, args[0],
                                   args[1], *pools[name], *args[2:], **kw)[:, -1]
               for name, kw in paths.items()}
        a, b, r32, r16 = out["lora"], out["base"], out["ref32"], out["ref"]
        check(torch.isfinite(a).all().item(), f"engine_lora: {kind} logits not finite")
        same = [torch.equal(a[i], b[i]) for i in base_rows]
        differ = [not torch.equal(a[i], b[i]) for i in ad_rows]

        def rel_rows(x, y):
            return [round(v, 5) for v in ((x - y).norm(dim=-1) / y.norm(dim=-1)).tolist()]

        vs_ref, vs_f32, vs_base = rel_rows(a, r16), rel_rows(a, r32), rel_rows(a, b)
        steps.append({"step": kind, "base_rows_equal": same, "adapter_rows_differ": differ,
                      "rel_l2_vs_ref": vs_ref,
                      "greedy_agreement_vs_ref": (a.argmax(-1) == r16.argmax(-1))
                      .float().mean().item(),
                      "rel_l2_vs_ref_f32_adapter_rows": [vs_f32[i] for i in ad_rows],
                      "rel_l2_vs_ref_f32_base_rows": [vs_f32[i] for i in base_rows],
                      # what a delta lost on the card would read
                      "rel_l2_adapter_rows_vs_base": [vs_base[i] for i in ad_rows],
                      "ref_bf16_vs_ref_f32": rel_rows(r16, r32)})
        check(all(same), f"engine_lora: {kind}: base-slot rows differ from the "
                         f"LoRA-less forward's: {same}")
        check(all(differ), f"engine_lora: {kind}: an adapter row equals the base's")
        if kind == "prefill":
            # the same rows as one flat ragged row with a slot a token, as
            # a LoRA runner's n-gram verify feeds the ragged kernel
            rag = build_ragged_metadata([S] * B, [0] * B, [S] * B, pages.tolist(), B * S,
                                        max_pages=per)
            ops = [torch.from_numpy(rag[k]).to(dev)
                   for k in ("seg_page_table", "seg_kv_lens", "meta", "last_index")]
            g = llama.forward(cfg, params, tok.view(1, B * S),
                              torch.from_numpy(rag["tok_positions"][None]).to(dev),
                              *make_kv_pool(cfg, B * per + 1, PS, lr.dtype, dev),
                              last_index=ops[3][:B], ragged=tuple(ops[:3]), lora=lr.lora,
                              adapter_idx=idx.repeat_interleave(S))[0]
            g_ref, g_f32 = rel_rows(g, r16), rel_rows(g, r32)
            steps[-1]["ragged"] = {"rel_l2_vs_ref": g_ref,
                                   "rel_l2_vs_ref_f32_adapter_rows": [g_f32[i] for i in ad_rows]}
            vs_ref = vs_ref + g_ref
            vs_f32 = [max(x, y) for x, y in zip(vs_f32, g_f32)]
        check(max(vs_ref) <= FORWARD_REL_TOL,
              f"engine_lora: {kind}: kernel vs ref with adapters: relative L2 "
              f"{max(vs_ref)} > {FORWARD_REL_TOL}: {steps[-1]}")
        worst = max(vs_f32[i] for i in ad_rows)
        check(worst <= LORA_F32_REL_TOL,
              f"engine_lora: {kind}: adapter rows vs the f32 plain path: relative L2 "
              f"{worst} > {LORA_F32_REL_TOL}: {steps[-1]}")
        nxt = a.argmax(-1).to(torch.int32)
    del pools, params32
    return steps


async def _lora_streams(engine, lr, V):
    """(d), (e), (f) on one engine over the LoRA runner: one 80-token
    prompt under base, ad-one, ad-mlp and ad-one again, then ad-late
    registered at run time into the free slot (on the step thread) and
    served. Returns (streams by adapter, prefix tokens each reused)."""
    gen = torch.Generator(device="cpu").manual_seed(41)
    prompt = torch.randint(0, V, (80,), generator=gen).tolist()
    sch = engine.scheduler
    streams, reused = {}, {}

    async def one(ad, key):
        req = {"token_ids": prompt, "sampling": {"temperature": 0.0},
               "stop": {"max_tokens": 16, "stop_ids": []}}
        if ad:
            req["adapter"] = ad
        before = sch.reused_prefix_tokens
        r = await _collect_timed(engine, req, f"lora-{key}")
        check(r["finish"] == "length" and len(r["tokens"]) == 16,
              f"engine_lora: {key} finished {r['finish']} with {len(r['tokens'])} tokens")
        streams[key], reused[key] = r["tokens"], sch.reused_prefix_tokens - before

    for ad, key in ((None, "base"), ("ad-one", "ad-one"), ("ad-mlp", "ad-mlp"),
                    ("ad-one", "ad-one_again")):
        await one(ad, key)
    slot = await engine.call_on_step_thread(lr.register_adapter, "ad-late",
                                            lora_factors(lr.config, "ad-late"))
    check(slot == 3, f"engine_lora: the runtime load took slot {slot}")
    await one("ad-late", "ad-late")
    return streams, reused


def lora_phases(runner, dev, smi):
    """`engine_lora`: a LoRA runner over the 3B's params (full width and
    depth, lora_slots 3, rank 16, all seven targets) with ad-one and
    ad-mlp, serving the 3B's traffic split over base and the two
    adapters, every batch mixing slots, with the counts set to 0 just
    before and read just after: (a) every launch on the decode and
    prefill kernels (passes x 28), the ragged kernel not at all (the
    padded path: mixed plans on the padded fallback); a second turn with
    n-gram speculation (`lora_spec`, counted the same way), whose verify
    runs on the ragged kernel (verify passes x 28) with each token's
    adapter, its mixed plans still padded; then, outside the
    counted window, (b) and (c) (lora_forward_checks), (d) each adapter's
    greedy stream differs from the base's, (e) the same prompt under
    another adapter reuses no cached token, (f) an adapter registered at
    run time into the free slot is served. Recorded beside the LoRA-less
    runner's turn on the same padded path (`lora_base_padded`, the same
    requests without adapters): the decode rate a request, and a decode
    step's device time with and without adapters."""
    from dynamo_tpu_torch.models import lora

    t0 = time.monotonic()
    cfg = runner.config
    args = parse_args(ENGINE_ARGS)
    lr = ModelRunner(cfg, num_pages=args.num_pages, page_size=args.page_size,
                     max_pages_per_seq=-(-args.max_seq_len // args.page_size),
                     params=runner.params, lora_slots=3, lora_rank=LORA_RANK,
                     lora_targets=LORA_ALL_TARGETS)
    for name in ("ad-one", "ad-mlp"):
        lr.register_adapter(name, lora_factors(cfg, name))
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    check(not lr.ragged_mixed and lr.adapter_names == ["ad-one", "ad-mlp"],
          f"engine_lora: ragged {lr.ragged_mixed}, adapters {lr.adapter_names}")
    rec, launches, results = engine_phase(lr, "lora", build_s=build_s,
                                          adapters=LORA_TRAFFIC)
    st = rec["stats"]
    check(rec["fused_mixed"], "engine_lora: the engine did not fuse on the card")
    check(launches["ragged_paged_attention"] == 0 and st["ragged_mixed_dispatches"] == 0,
          f"engine_lora: the ragged kernel ran: {launches}, {st}")
    check(launches["decode_paged_attention"] > 0 and launches["prefill_paged_attention"] > 0
          and st["padded_prefill_dispatches"] > 0,
          f"engine_lora: mixed plans did not take the padded path: {launches}, {st}")
    for i, (toks, finish, _) in enumerate(results):
        check(finish == "length" and len(toks) == N_OUT,
              f"engine_lora: r{i} finished {finish!r} with {len(toks)} tokens")
    rec["lora"] = {"slots": 3, "rank": LORA_RANK, "targets": list(LORA_ALL_TARGETS),
                   "tree_mb": lora.lora_bytes(cfg, 4, LORA_RANK, LORA_ALL_TARGETS) / 1e6}
    # the LoRA-less runner on the same padded path, the same requests
    saved = runner.ragged_mixed
    runner.ragged_mixed = False
    try:
        base_rec, base_launches, _ = engine_phase(runner, "lora_base_padded")
    finally:
        runner.ragged_mixed = saved
    check(base_launches["ragged_paged_attention"] == 0,
          "lora_base_padded: the ragged kernel ran")
    emit(base_rec)
    emit({**rec, "phase": "engine_lora_turn"})
    # n-gram speculation under the adapters: the verify rides the ragged
    # step, a slot a flat token; mixed plans stay padded
    spec_rec, spec_launches, _ = engine_phase(lr, "lora_spec", spec=True,
                                              adapters=LORA_TRAFFIC)
    sst = spec_rec["stats"]
    check(spec_rec["spec_stats"]["drafted"] > 0 and sst["ragged_verify_dispatches"] > 0,
          f"lora_spec: nothing was drafted or verified: {spec_rec['spec_stats']}, {sst}")
    check(sst["ragged_mixed_dispatches"] == 0,
          f"lora_spec: a mixed plan took the ragged step: {sst}")
    emit(spec_rec)
    rec["spec_turn"] = {
        "launches": spec_launches, "ragged_verify_dispatches": sst["ragged_verify_dispatches"],
        "padded_prefill_dispatches": sst["padded_prefill_dispatches"],
        "spec_stats": spec_rec["spec_stats"],
        "decode_tok_s_per_request_median": spec_rec["decode_tok_s_per_request_median"]}
    rec["forward_checks"] = lora_forward_checks(lr, dev)
    engine = build_engine(args, runner=lr)
    try:
        streams, reused = asyncio.run(asyncio.wait_for(
            _lora_streams(engine, lr, cfg.vocab_size), 300))
    finally:
        engine.stop()
    for key in ("ad-one", "ad-mlp", "ad-late"):
        check(streams[key] != streams["base"],
              f"engine_lora: the {key} stream equals the base stream")
    check(streams["ad-one"] == streams["ad-one_again"],
          "engine_lora: ad-one's cached rerun differs")
    check(reused["ad-one"] == 0 and reused["ad-mlp"] == 0,
          f"engine_lora: a prompt reused another adapter's cache: {reused}")
    check(reused["ad-one_again"] >= 64, f"engine_lora: no reuse in ad-one's lineage: {reused}")
    rec["streams_differ_from_base"] = {k: streams[k] != streams["base"]
                                       for k in ("ad-one", "ad-mlp", "ad-late")}
    rec["reused_prefix_tokens_by_turn"] = reused
    rec["runtime_load"] = {"adapter": "ad-late", "slot": 3,
                           "adapters": lr.adapter_names}
    rec["decode_step"] = decode_step_ms(lr, LORA_STEP_ROWS)
    rec["decode_step_without_adapters"] = decode_step_ms(runner)
    rec["decode_step_lora_slots"] = list(LORA_STEP_ROWS)
    rec["lora_base_padded"] = {k: base_rec[k] for k in (
        "decode_tok_s_per_request_median", "output_tok_s_overall", "ttft_s_median",
        "wall_s")}
    rec["nvidia_smi"] = smi
    rec["seconds"] = time.monotonic() - t0
    emit(rec)
    free(lr)


LORA_SERVED_ARGS = model_args("llama-3.2-1b")
LORA_SERVED_MODEL = "llama-3.2-1b"


def lora_served_phase(smi):
    """`lora_served`: two `python -m dynamo_tpu_torch.worker` processes
    on llama-3.2-1b (full width and depth, 2048 pages), one with `--lora
    ad-one`, the other with one free slot (`--lora-slots 1`), behind
    `python -m dynamo_tpu_torch.frontend --router-mode kv`, on one
    file-discovery root. Checks: /v1/models lists ad-one; 8 ad-one
    completions (4 one at a time, 4 at once) all answer 16 tokens and
    only the holder runs forward passes for them (each worker's
    forward-pass metrics, subscribed here); an rl load_adapter of the
    same adapter on the other worker (its seed and scale) makes it a
    holder, and batches of 4 ad-one completions at once reach it within
    30 s; both processes and the frontend exit 0 on SIGTERM."""
    from dynamo_tpu_torch.router.protocols import FPM_SUBJECT

    def body(prompt, n=16):
        return {"model": "ad-one", "prompt": prompt, "max_tokens": n, "temperature": 0,
                "ignore_eos": True}

    async def run(root):
        rec = {"phase": "lora_served", "model": LORA_SERVED_MODEL, "nvidia_smi": smi}
        t_phase = time.monotonic()
        procs = {}
        rt = DistributedRuntime(discovery=FileDiscovery(root, poll_interval=0.05))
        sub = rt.event_subscriber([FPM_SUBJECT])
        fpm = {}
        listener = None
        gen = torch.Generator(device="cpu").manual_seed(53)
        V = get_config(LORA_SERVED_MODEL).vocab_size

        def prompt(n=48):
            return torch.randint(0, V, (n,), generator=gen).tolist()

        try:
            t0 = time.monotonic()
            (pa, la), (pb, lb) = await asyncio.gather(
                _spawn(["dynamo_tpu_torch.worker", *LORA_SERVED_ARGS, "--lora", "ad-one"],
                       root, "worker serving", os.path.join(root, "holder.log")),
                _spawn(["dynamo_tpu_torch.worker", *LORA_SERVED_ARGS, "--lora-slots", "1"],
                       root, "worker serving", os.path.join(root, "other.log")))
            procs.update(holder=pa, other=pb)
            rec["worker_start_s"] = time.monotonic() - t0
            fe, line = await _spawn(["dynamo_tpu_torch.frontend", "--router-mode", "kv",
                                     "--http-host", "127.0.0.1", "--http-port", "0"], root,
                                    "frontend serving at", os.path.join(root, "frontend.log"))
            procs["frontend"] = fe
            port = int(line.rsplit(":", 1)[1])

            def listed():
                status, _, data = _http(port, "GET", "/v1/models")
                return [m["id"] for m in json.loads(data)["data"]] if status == 200 else []

            t0 = time.monotonic()
            while (models := await asyncio.to_thread(listed)) != ["ad-one",
                                                                  LORA_SERVED_MODEL]:
                check(time.monotonic() - t0 < 60, f"lora_served: the frontend lists {models}")
                await asyncio.sleep(0.1)
            rec["models"] = models
            addr = {"holder": la.rsplit("(", 1)[1].rstrip(")"),
                    "other": lb.rsplit("(", 1)[1].rstrip(")")}
            insts = {i.address: i for i in await rt.discovery.list_instances("services/")
                     if (i.metadata or {}).get("model_card")}
            iid = {}
            for name, a in addr.items():
                inst = insts[a]
                iid[name] = inst.instance_id
                sub.connect(inst.metadata["fpm_publisher"])
                fpm[inst.instance_id] = 0

            async def listen():
                async for _, payload in sub.events():
                    w = payload["worker"][0]
                    if w in fpm:
                        fpm[w] += 1

            listener = asyncio.create_task(listen())
            await asyncio.sleep(0.5)  # the subscriptions connect

            async def completion(p):
                status, _, data = await asyncio.to_thread(_http, port, "POST",
                                                          "/v1/completions", body(p))
                check(status == 200, f"lora_served: ad-one answered {status}: {data[:300]}")
                out = json.loads(data)
                check(out["usage"]["completion_tokens"] == 16 and out["model"] == "ad-one",
                      f"lora_served: {out}")
                return out

            async def settled():
                last = None
                while last != dict(fpm):
                    last = dict(fpm)
                    await asyncio.sleep(0.5)
                return last

            before = await settled()
            t0 = time.monotonic()
            for _ in range(4):
                await completion(prompt())
            await asyncio.gather(*[completion(prompt()) for _ in range(4)])
            rec["ad_one_8_s"] = time.monotonic() - t0
            after = await settled()
            rec["fpm_before_load"] = {name: after[i] - before[i] for name, i in iid.items()}
            check(after[iid["other"]] == before[iid["other"]],
                  f"lora_served: ad-one traffic reached the non-holder: {rec}")
            check(after[iid["holder"]] > before[iid["holder"]],
                  f"lora_served: the holder ran no forward pass: {rec}")
            # the runtime load on the other worker
            rl = rt.client("dyn/tpu-worker/rl")
            await rl.start()
            await _until(lambda: iid["other"] in rl.instances, "the rl endpoint", 30)
            t_load = time.monotonic()
            got = [x async for x in rl.direct({"op": "load_adapter", "name": "ad-one",
                                                "seed": 100, "scale": 1.0}, iid["other"])][0]
            rec["load_adapter"] = {**got, "seconds": time.monotonic() - t_load}
            check(got.get("slot") == 1 and got.get("adapters") == ["ad-one"],
                  f"lora_served: load_adapter answered {got}")
            await rl.close()
            mark = dict(fpm)
            batches = 0
            while fpm[iid["other"]] == mark[iid["other"]]:
                check(time.monotonic() - t_load < 30,
                      f"lora_served: no ad-one traffic reached the new holder: {fpm}")
                await asyncio.gather(*[completion(prompt()) for _ in range(4)])
                batches += 1
                await asyncio.sleep(0.3)
            rec["new_holder"] = {"seconds_to_first_pass": time.monotonic() - t_load,
                                 "batches": batches}
            rc = {}
            for name in ("frontend", "holder", "other"):
                procs[name].send_signal(signal.SIGTERM)
                rc[name] = await asyncio.wait_for(procs[name].wait(), SERVE_TIMEOUT_S)
            check(rc == {"frontend": 0, "holder": 0, "other": 0},
                  f"lora_served: exit codes after SIGTERM {rc}")
            rec["exit_codes"] = rc
            rec["seconds"] = time.monotonic() - t_phase
            return rec
        finally:
            if listener is not None:
                listener.cancel()
            await sub.close()
            for proc in procs.values():
                if proc.returncode is None:
                    proc.kill()
                    await proc.wait()
            await rt.shutdown(drain_timeout=1)

    with tempfile.TemporaryDirectory() as root:
        rec = asyncio.run(asyncio.wait_for(run(root), 600))
    emit(rec)
    return rec


def parity_phase(runner, dev, phase: str = "parity", ragged: bool = True,
                 lens=(300, 180, 90), S: int = 320, MP: int = 24, NP: int = 80,
                 moe_sels=None, gate: bool = True, against: str = "ref"):
    """Three sequences of `lens` tokens prefilled in chunks of S (one
    chunk by default; padding rows, and rows that have finished in later
    chunks), two decode steps of the first two (the third a padding row),
    then (`ragged`) one ragged dispatch: both decode rows and a 77-token
    chunk of the third over its prior tokens (T 88, a 9-row tail).
    Through forward(attn_impl="kernel") and forward(attn_impl="ref") on
    their own pools (the runner's kind: int8 with kv_quantize); decode
    inputs are the kernel path's greedy tokens, fed to both. Only rows
    with tokens in a step are compared. With int8 pools the kernel path
    also runs on bf16 pools, and the int8 logits' distance to those is
    reported as information. `moe_sels` (from record_selections, around
    the call) adds how many top-k choices differ between the paths;
    gate=False reports the errors without holding them to the limit.
    against="kernel" runs the kernel path in place of the plain one, on
    pools of its own, and holds the two to bit-for-bit equality: the
    engine's greedy streams repeat run to run only if every kernel and
    the glue between them do."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.toolkit import make_kv_pool

    cfg, params = runner.config, runner.params
    PS = 16
    gen = torch.Generator(device="cpu").manual_seed(2)
    lens = list(lens)
    n_chunks = -(-max(lens) // S)
    toks = [torch.randint(0, cfg.vocab_size, (3, S), generator=gen)
            for _ in range(n_chunks)]
    pages = torch.randperm(NP, generator=gen)[: 3 * MP].view(3, MP).to(torch.int32)
    pages = pages.to(dev)
    # path name -> (attn_impl, pools)
    paths = {name: (impl, make_kv_pool(cfg, NP + 1, PS, runner.dtype, dev,
                                       kv_quantize=runner.kv_quantize))
             for name, impl in (("kernel", "kernel"), ("ref", against))}
    if runner.kv_quantize:
        paths["kernel_bf16"] = ("kernel", make_kv_pool(cfg, NP + 1, PS, runner.dtype, dev))
    rel, agree, worst_abs = [], [], 0.0
    rel_bf16, agree_bf16 = [], []

    def compare(logits, rows=None):
        nonlocal worst_abs
        a, b = logits["kernel"], logits["ref"]
        c = logits.get("kernel_bf16")
        if rows is not None:
            a, b = a[rows], b[rows]
            c = None if c is None else c[rows]
        check(torch.isfinite(a).all().item(), "kernel-path logits not finite")
        rel.append(((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item())
        worst_abs = max(worst_abs, (a - b).abs().max().item())
        agree.extend((a.argmax(-1) == b.argmax(-1)).tolist())
        if c is not None:
            rel_bf16.append(((a - c).norm(dim=-1) / c.norm(dim=-1)).max().item())
            agree_bf16.extend((a.argmax(-1) == c.argmax(-1)).tolist())
        return logits["kernel"].argmax(-1).to(torch.int32)

    nxt = torch.zeros(3, dtype=torch.int32, device=dev)
    real = []  # each step's real (not padding) tokens, flat
    for ci in range(n_chunks):  # chunked prefill, all rows in one batch
        pos = torch.full((3, S), -1, dtype=torch.int32)
        kvl = torch.zeros(3, dtype=torch.int32)
        last = torch.zeros(3, dtype=torch.long)
        for b, n in enumerate(lens):
            lo, hi = ci * S, min(n, (ci + 1) * S)
            if hi > lo:
                pos[b, :hi - lo] = torch.arange(lo, hi)
                kvl[b], last[b] = hi, hi - 1 - lo
        live = torch.tensor([n > ci * S for n in lens], device=dev)
        real.append((pos >= 0).reshape(-1))
        out = compare({
            name: llama.forward(cfg, params, toks[ci].to(dev), pos.to(dev),
                                *pl, pages, kvl.to(dev), last.to(dev),
                                attn_impl=impl)[:, -1]
            for name, (impl, pl) in paths.items()}, None if live.all() else live)
        done = torch.tensor([ci * S < n <= (ci + 1) * S for n in lens], device=dev)
        nxt = torch.where(done, out, nxt)
    for t in range(2):
        p1 = torch.tensor([[lens[0] + t], [lens[1] + t], [-1]],
                          dtype=torch.int32, device=dev)
        kvl = torch.where(p1[:, 0] < 0, 0, p1[:, 0] + 1).to(torch.int32)
        real.append((p1 >= 0).reshape(-1).cpu())
        nxt = compare({
            name: llama.forward(cfg, params, nxt[:, None], p1, *pl,
                                pages, kvl, None, attn_impl=impl)[:, -1]
            for name, (impl, pl) in paths.items()})
    steps_run = ["prefill"] * n_chunks + ["decode", "decode"]
    if ragged:
        ragged_parity_step(cfg, params, paths, nxt, lens, pages, MP, gen, dev,
                           compare)
        real.append(torch.arange(88) < 79)  # two decode rows, a 77-token chunk
        steps_run.append("ragged")
    worst = max(rel)
    rec = {"phase": phase, "model": cfg.name, "lens": lens, "steps": steps_run,
           "kv_quantize": runner.kv_quantize, "against": against,
           "rel_l2_err_per_step": rel, "max_abs_err": worst_abs,
           "tol_rel_l2": FORWARD_REL_TOL if against == "ref" else 0.0,
           "greedy_agreement": sum(agree) / len(agree)}
    if rel_bf16:  # information only: int8 against bf16 pools, both kernels
        rec["vs_bf16_pools"] = {"rel_l2_err_per_step": rel_bf16,
                                "greedy_agreement": sum(agree_bf16) / len(agree_bf16)}
    if moe_sels is not None:
        rec["moe_topk"] = selection_flips(moe_sels, len(paths), runner.moe_layers,
                                          real)
    rec["gated"] = gate
    emit(rec)
    check(not gate or worst <= rec["tol_rel_l2"],
          f"{phase}: kernel vs {against} forward: relative L2 error {worst} > "
          f"{rec['tol_rel_l2']}")
    check(not gate or against == "ref" or worst_abs == 0.0,
          f"{phase}: the kernel path twice: logits differ by {worst_abs}")


def ragged_parity_step(cfg, params, paths, nxt, lens, pages, MP, gen, dev,
                       compare):
    """The ragged dispatch of parity_phase over its paths (name ->
    (attn_impl, pools)): the decode rows' next tokens at lens + 2, and the
    third sequence's 77-token chunk."""
    from dynamo_tpu_torch.models import llama

    chunk = torch.randint(0, cfg.vocab_size, (77,), generator=gen).tolist()
    q_lens, starts = [1, 1, 77], [lens[0] + 2, lens[1] + 2, lens[2]]
    md = build_ragged_metadata(q_lens, starts, [s + n for s, n in zip(starts, q_lens)],
                               pages.tolist(), 88, max_pages=MP)
    flat = torch.zeros(88, dtype=torch.int32)
    flat[:2] = nxt[:2].cpu()
    flat[2:79] = torch.tensor(chunk)
    gather = torch.zeros(md["seg_kv_lens"].shape[0], dtype=torch.int32)
    gather[:3] = torch.from_numpy(md["last_index"])
    ragged = tuple(torch.from_numpy(md[k]).to(dev)
                   for k in ("seg_page_table", "seg_kv_lens", "meta"))
    positions = torch.from_numpy(md["tok_positions"]).to(dev)[None]
    compare({name: llama.forward(cfg, params, flat.to(dev)[None], positions,
                                 *pl, last_index=gather.to(dev),
                                 attn_impl=impl, ragged=ragged)[0, :3]
             for name, (impl, pl) in paths.items()})


def mla_pages_phase(engine, prompt) -> None:
    """MLA pages through the copy kernels: the latent and stub pages of
    `prompt` (cached by the finished engine) go export_pages_device ->
    import_pages_device into fresh slots, and export_pages ->
    import_pages(layer_groups=3) into others, bit for bit, with the copy
    kernels' launches counted."""
    runner = engine.runner
    src = [engine.pool.by_hash[h] for h in block_hashes(prompt, PAGE_SIZE)]
    free = [pg for pg in range(runner.num_pages - 1, -1, -1) if pg not in set(src)]
    dev_dst, wire_dst = free[:len(src)], free[len(src):2 * len(src)]
    torch.cuda.synchronize()
    _reset(runner)
    k, v = runner.export_pages_device(src)
    runner.import_pages_device(dev_dst, 0, k, v)
    payload = runner.export_pages(src)
    runner.import_pages(wire_dst, 0, payload, layer_groups=3)
    torch.cuda.synchronize()
    launches = {name: KERNELS[name].launches for name in COPY_KERNELS}
    for pool in (runner.k_pool, runner.v_pool):
        check(torch.equal(pool[:, dev_dst], pool[:, src]),
              "mla_pages: the device round trip changed the pages")
        check(torch.equal(pool[:, wire_dst], pool[:, src]),
              "mla_pages: the wire round trip changed the pages")
    check(runner.k_pool[:, src].float().abs().sum().item() > 0,
          "mla_pages: the exported latent pages are empty")
    # each export gathers and each import scatters once per pool
    want = {"gather_pages": 4, "scatter_pages": 2, "scatter_pages_layers": 6}
    check(launches == want, f"mla_pages: copy launches {launches} != {want}")
    emit({"phase": "mla_pages", "pages": len(src),
          "k_page_shape": list(runner.k_pool.shape[2:]),
          "v_page_shape": list(runner.v_pool.shape[2:]),
          "payload_shape": payload["shape"], "payload_v_shape": payload["v_shape"],
          "launches": launches, "bit_exact": True})


def mla_phases(dev):
    """DeepSeek-V3's three dense layers at full width: the engine phase
    (launch identities, every request length 32), the page round trip
    through the copy kernels, and the forward parity."""
    t0 = time.monotonic()
    runner = ModelRunner(MLA_CONFIG, num_pages=2048, page_size=PAGE_SIZE,
                         max_pages_per_seq=4096 // PAGE_SIZE)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    check(not runner.ragged_mixed, "engine_mla: the runner kept the ragged path")
    check(runner.kv_page_shape == (3, PAGE_SIZE, 1, MLA_CONFIG.mla_cache_dim),
          f"engine_mla: page shape {runner.kv_page_shape}")
    rec, launches, results = engine_phase(runner, "mla", build_s=build_s)
    st = rec["stats"]
    check(rec["fused_mixed"], "engine_mla: the engine did not fuse on the card")
    for name in MLA_KERNELS:
        check(launches[name] > 0, f"engine_mla: {name} never launched")
    check(st["padded_prefill_dispatches"] > 0 and st["ragged_mixed_dispatches"] == 0,
          f"engine_mla: mixed plans did not take the padded fallback: {st}")
    for i, (toks, finish, _) in enumerate(results):
        check(finish == "length" and len(toks) == N_OUT,
              f"engine_mla: r{i} finished {finish!r} with {len(toks)} tokens")
    rec["config"] = {k: getattr(MLA_CONFIG, k) for k in (
        "name", "dim", "n_layers", "n_heads", "q_lora_rank", "kv_lora_rank",
        "qk_rope_head_dim", "qk_nope_head_dim", "v_head_dim", "ffn_dim",
        "vocab_size", "rope_scaling", "rope_factor")}
    rec["kv_bytes_per_token_per_layer"] = MLA_CONFIG.mla_cache_dim * 2
    emit(rec)
    engine = build_engine(parse_args(ENGINE_ARGS), runner=runner)
    try:
        prompt = workload(MLA_CONFIG.vocab_size, seed=1)[0][5]["token_ids"]
        asyncio.run(asyncio.wait_for(_collect_timed(engine, {
            "token_ids": prompt, "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": 2, "stop_ids": []}}, "pages"), 300))
    finally:
        engine.stop()
    mla_pages_phase(engine, prompt)
    parity_phase(runner, dev, phase="parity_mla", ragged=False)

    # the int8 latent (same params): decode on the int8 body, prefill on
    # the reference's gather (no MLA prefill launch)
    runner8 = ModelRunner(MLA_CONFIG, num_pages=2048, page_size=PAGE_SIZE,
                          max_pages_per_seq=4096 // PAGE_SIZE, params=runner.params,
                          kv_quantize="int8")
    rec, launches8, results = engine_phase(runner8, "mla_int8")
    n = launches8["decode_mla_attention"]
    check(rec["fused_mixed"], "engine_mla_int8: the engine did not fuse on the card")
    check(n > 0 and rec["bodies"]["decode_mla_attention"] == {"int8": n},
          f"engine_mla_int8: MLA decode launches {n}, bodies "
          f"{rec['bodies']['decode_mla_attention']}")
    for i, (toks, finish, _) in enumerate(results):
        check(finish == "length" and len(toks) == N_OUT,
              f"engine_mla_int8: r{i} finished {finish!r} with {len(toks)} tokens")
    rec["kv_bytes_per_token_per_layer"] = MLA_CONFIG.mla_cache_dim + 4 + 1 + 4
    emit(rec)
    return launches, launches8


# llama-3.1-8b at full width (32 / 8 heads, head dim 128, bf16 random
# weights, seed 0; 8 of its 32 layers in int8kv_phases and quant_phases,
# DEPTH_CUTS) over int8 KV pools, 2048 pages x 16, serving workload()'s 8
# requests
ENGINE_8B_ARGS = model_args("llama-3.1-8b", kv_quantize=True)


def int8kv_phases(dev, smi):
    """`engine_int8kv` (fused, the card's default) and
    `engine_int8kv_unfused` on one llama-3.1-8b runner (8 layers) with
    int8 pools: every request `length`, each GQA kernel's launches equal to
    its passes x 8, all on the D128_int8 bodies; the pools' bytes beside a bf16
    pool's; then `parity_int8kv`. Returns the fused phase's launches and
    the bodies of both phases."""
    runner, cfg, build_s = timed_runner(ENGINE_8B_ARGS, cut=True)
    L = cfg.n_layers
    check(runner.kv_quantize == "int8" and runner.k_pool["q"].dtype == torch.int8,
          "engine_int8kv: the runner's pools are not int8")
    check(runner.kv_page_shape == (L, PAGE_SIZE, cfg.n_kv_heads, cfg.head_dim),
          f"engine_int8kv: page shape {runner.kv_page_shape}")
    pool_bytes = sum(t.numel() * t.element_size()
                     for pool in (runner.k_pool, runner.v_pool) for t in pool.values())
    bf16_bytes = 2 * runner.k_pool["q"].numel() * 2
    body = f"D{cfg.head_dim}_int8"
    found, fused_launches = {}, None
    for phase, fused in (("int8kv", None), ("int8kv_unfused", False)):
        rec, launches = served_turn(runner, phase, fused, ENGINE_8B_ARGS, one_body(body),
                                    build_s=build_s if fused is None else None)
        if fused is None:
            fused_launches = launches
        rec["kv_pool_bytes"] = pool_bytes
        rec["kv_pool_bytes_if_bf16"] = bf16_bytes
        rec["config"] = {k: getattr(cfg, k) for k in (
            "name", "dim", "n_layers", "n_heads", "n_kv_heads", "head_dim",
            "ffn_dim", "vocab_size", "rope_scaling")}
        rec["nvidia_smi"] = smi
        found[phase] = rec["bodies"]
        emit(rec)
    # a decode step's device time, for engine_quant's int8 weights beside it
    DECODE_STEP_MS["int8kv"] = decode_step_ms(runner)
    emit({"phase": "decode_step_int8kv", **DECODE_STEP_MS["int8kv"], "nvidia_smi": smi})
    parity_phase(runner, dev, phase="parity_int8kv")
    return fused_launches, found


# Gemma-2 9B at full width (10 of its 42 layers in gemma_phases), head dim 256, G 2, a
# 4096-token window on the even layers, soft caps 50 (scores) and 30
# (logits), served with workload()'s 8 requests and two prompts past the
# window
GEMMA_ARGS = model_args("gemma-2-9b", 8192)
GEMMA_LONG_PROMPTS = (4600, 5200)
GEMMA_WINDOW = 4096
# gemma_kernels: (Hk, G, D) of Gemma-2 9B and of the 3B's heads; 16-token
# pages, 384 of them a row (6144 tokens)
GEMMA_SHAPES = {"D256_G2": (8, 2, 256), "D128_G3": (8, 3, 128)}
GEMMA_MP = 384
# contexts around the 4096-token window, and contexts whose 7-token window
# crosses page (16), tile (64), decode-split (384) and ragged-split (512)
# edges
GEMMA_LONG = [1, 4095, 4096, 4097, 6000]
GEMMA_EDGES = [1, 7, 8, 20, 67, 388, 515, 1000]
# case: (contexts, window, softcap, scale, query scale); scale None is
# D^-0.5. The soft-capped cases draw queries 20x larger, so that scores
# reach the cap (std about 20): a body that skipped the cap would miss by
# far more than KERNEL_TOL. Every case is held against the plain version
# run in f32 on the same (bf16) inputs, as the MLA kernels are.
GEMMA_CASES = {
    "gemma2": (GEMMA_LONG, GEMMA_WINDOW, 50.0, 256 ** -0.5, 20.0),
    "window_4096": (GEMMA_LONG, GEMMA_WINDOW, 0.0, None, 1.0),
    "window_7": (GEMMA_EDGES, 7, 0.0, None, 1.0),
    "window_0": (GEMMA_LONG, 0, 0.0, None, 1.0),
    "softcap_50": (GEMMA_LONG, None, 50.0, None, 20.0),
    "scale": (GEMMA_LONG, None, 0.0, 0.05, 1.0),
}
GEMMA_CHUNK = 512  # prefill chunk: q_len = min(context, 512)
GEMMA_RAGGED_CHUNK = 48  # ragged chunk rows beside each decode row
# soft cap in the kernels: 7 f32 operations a score (two multiplies, ex2,
# add, rcp, fma, multiply)
CAP_FP32_OPS = 7


# int8 decode's warps a block at each head dim, one tile slot each
# (paged_attention.cu code_warps)
DECODE_CODE_WARPS = {64: 4, 96: 4, 128: 4, 256: 6}


def gqa_smem_bytes(D: int):
    """Dynamic shared memory of each GQA kernel's bf16 body at head dim D
    (the layouts of paged_attention.cu DecShape and paged_flash.cuh Shape:
    rows D + 8 bf16 apart, 64-token tiles, mbarriers) and of the int8
    decode kernel (DecCodeShape: per warp a slot of 64 K and 64 V rows of D
    + 16 bytes and their scales)."""
    row = (D + 8) * 2
    slots = DECODE_CODE_WARPS[D]
    return {"decode": (16 + 2 * 3 * 64) * row + 8 * 3,
            "decode_int8": slots * (2 * 64 * (D + 16) + 2 * 64 * 4 + 8),
            "prefill": (128 + 2 * 2 * 64) * row + 8 * 2,
            "ragged": (64 + 2 * 2 * 64) * row + 8 * 2}


def visible(q_start, q_len, kv, window):
    """(visible (query, key) pairs, visible tokens, their pages) of q_len
    query tokens from q_start over a kv-token context: the token at p sees
    [p - window + 1 (0 without a window), min(p, kv - 1)]."""
    pairs = 0
    for p in range(q_start, q_start + q_len):
        first = max(p - window + 1, 0) if window else 0
        pairs += max(min(p, kv - 1) - first + 1, 0)
    if q_len <= 0 or kv <= 0:
        return pairs, 0, 0
    first = max(q_start - window + 1, 0) if window else 0
    last = min(q_start + q_len - 1, kv - 1)
    if last < first:
        return pairs, 0, 0
    return pairs, last - first + 1, last // PAGE_SIZE - first // PAGE_SIZE + 1


def kv_row_bytes(D: int, int8: bool = False) -> int:
    """Bytes of one token's K and V rows of one head: bf16, or int8 codes
    and an f32 scale each."""
    return 2 * (D + 4) if int8 else 2 * D * 2


def gemma_bound(H, Hk, D, spans, window, io_rows, n_ints, softcap, int8=False):
    """Bound over what the data needs: `spans` [(q_start, q_len, kv)] of
    each sequence, whose visible K/V tokens are read once with their table
    entries (kv_row_bytes a head); `io_rows` query rows read and output
    rows written (H x D bf16 each); n_ints int32 metadata; one score and
    one PV product per visible pair and head, and the cap's f32 operations
    per score."""
    pairs = toks = pages = 0
    for q_start, q_len, kv in spans:
        p, t, g = visible(q_start, q_len, kv, window)
        pairs, toks, pages = pairs + p, toks + t, pages + g
    n_bytes = (io_rows * H * D * 2 + toks * Hk * kv_row_bytes(D, int8) + pages * 4
               + n_ints * 4)
    return bound(n_bytes, 4 * pairs * H * D,
                 CAP_FP32_OPS * pairs * H if softcap else 0.0)


def gemma_case_inputs(kernel, contexts, Hk, G, D, q_mul, pools, gen, dgen, dev,
                      lib_pools=None):
    """Operands of one gemma_kernels case (on the shape's shared pools,
    each sequence on its own random pages), its Spans, the rows to check,
    the query/output row count and int32 metadata count of its bound, and
    the yardstick's dense operands (q, K, V [.., H, ., D], from `lib_pools`,
    the bf16 pools, default `pools`) and mask without the window."""
    NP = pool_values(pools[0]).shape[0]
    kp, vp = pools if lib_pools is None else lib_pools
    H, MP, PS = Hk * G, GEMMA_MP, PAGE_SIZE

    def qrand(*shape):
        return (torch.randn(*shape, generator=dgen, device=dev) * q_mul).bfloat16()

    def dense(pt):  # [B, H, MP * PS, D] K and V of each row's pages
        return dense_kv(kp, pt, Hk, G), dense_kv(vp, pt, Hk, G)

    c_pos = torch.arange(MP * PS, device=dev)
    if kernel == "decode":
        kv = contexts + [0]
        B = len(kv)
        pt = random_pages(gen, B, MP, NP, dev)
        q = qrand(B, Hk, G, D)
        kvl = torch.tensor(kv, dtype=torch.int32, device=dev)
        kd, vd = dense(pt)
        pos = kvl.long()[:, None] - 1  # [B, 1] query positions
        mask = (c_pos[None, None, :] <= pos[:, :, None])[:, None]
        return {"args": (q, *pools, pt, kvl), "rows": B - 1,
                "spans": [(k - 1, 1, k) for k in kv if k > 0], "io_rows": 2 * B,
                "n_ints": B, "lib": (q.reshape(B, H, 1, D), kd, vd, mask, pos)}
    if kernel == "prefill":
        B, S = len(contexts), GEMMA_CHUNK
        q_len = [min(c, S) for c in contexts]
        q_start = [c - n for c, n in zip(contexts, q_len)]
        pt = random_pages(gen, B, MP, NP, dev)
        q = qrand(B, S, Hk, G, D)
        ints = [torch.tensor(x, dtype=torch.int32, device=dev)
                for x in (q_start, q_len, contexts)]
        kd, vd = dense(pt)
        pos = ints[0].long()[:, None] + torch.arange(S, device=dev)[None, :]
        mask = ((c_pos[None, None, :] <= pos[:, :, None])
                & (c_pos[None, None, :] < ints[2].long()[:, None, None]))[:, None]
        return {"args": (q, *pools, pt, *ints), "rows": q_len,
                "spans": list(zip(q_start, q_len, contexts)),
                "io_rows": sum(q_len) + B * S, "n_ints": 3 * B,
                "lib": (q.reshape(B, S, H, D).transpose(1, 2), kd, vd, mask, pos)}
    segs = [(1, c - 1) for c in contexts]
    segs += [(min(GEMMA_RAGGED_CHUNK, c), c - min(GEMMA_RAGGED_CHUNK, c))
             for c in contexts if c > 1]
    t_real = sum(n for n, _ in segs)
    T = -(-(t_real + 1) // 8) * 8  # a tail of dummy rows
    pt = random_pages(gen, len(segs), MP, NP, "cpu")
    md = build_ragged_metadata([n for n, _ in segs], [p for _, p in segs],
                               [p + n for n, p in segs], pt.tolist(), T,
                               max_pages=MP)
    ints = tuple(torch.from_numpy(md[k]).to(dev)
                 for k in ("seg_page_table", "seg_kv_lens", "meta"))
    return {"args": (qrand(T, Hk, G, D), *pools) + ints, "segs": segs, "md": md,
            "rows": t_real, "spans": [(p, n, p + n) for n, p in segs],
            "io_rows": t_real + T,
            "n_ints": md["seg_kv_lens"].size + md["meta"].size}


def gemma_plain_f32(kernel, inp, window, scale, softcap):
    """The plain version on the case's inputs in f32 (ragged: segment by
    segment, each flat token being an S = 1 row of its segment, so the
    gathered context stays a few GB)."""
    args = inp["args"]
    q = args[0].float()
    kw = dict(softcap=softcap, window=window)
    if kernel == "decode":
        return decode_paged_attention_ref(q, inp["kp32"], inp["vp32"], *args[3:],
                                          scale, **kw)
    if kernel == "prefill":
        return prefill_paged_attention_ref(q, inp["kp32"], inp["vp32"], *args[3:],
                                           scale, **kw)
    segs, md = inp["segs"], inp["md"]
    out = torch.zeros_like(q)
    lo = 0
    for s, (n, p) in enumerate(segs):
        tb = -(-n // 8) * 8
        ms = build_ragged_metadata([n], [p], [p + n], [md["seg_page_table"][s].tolist()],
                                   tb, max_pages=GEMMA_MP)
        ops = [torch.from_numpy(ms[k]).to(q.device)
               for k in ("seg_page_table", "seg_kv_lens", "meta")]
        qs = torch.zeros((tb,) + q.shape[1:], device=q.device)
        qs[:n] = q[lo:lo + n]
        out[lo:lo + n] = ragged_paged_attention_ref(
            qs, inp["kp32"], inp["vp32"], *ops, window, scale=scale,
            softcap=softcap)[:n]
        lo += n
    return out


def case_errors(kernel, got, want, rows):
    """(max abs error, row_rel_err) of a case's output over its valid rows
    (prefill: the first q_len rows of each sequence)."""
    if kernel == "prefill":
        pairs = [(got[b, :n], want[b, :n]) for b, n in enumerate(rows) if n]
    else:
        pairs = [(got[:rows], want[:rows])]
    return (max((g.float() - w.float()).abs().max().item() for g, w in pairs),
            max(row_rel_err(g, w) for g, w in pairs))


def planted_faults(kernel, inp, window, scale):
    """The plain computation (f32 SDPA over the case's dense K/V) with a
    fault planted: the window's edge moved one token either way, and, in
    each row that sees a whole 64-token tile before the tile of its last
    visible token, that tile skipped. {fault: output, laid out as the
    kernel's}; decode and prefill cases only."""
    qd, kd, vd, mask, pos = inp["lib"]
    args = inp["args"]
    c = torch.arange(kd.shape[2], device=kd.device)[None, None, None, :]
    kv = args[-1].long()[:, None, None, None]
    p = pos[:, None, :, None]  # [B, 1, S, 1] query positions
    seen = mask & (c < kv)
    first = (p - window + 1).clamp_min(0) if window else torch.zeros_like(p)
    t0 = (torch.minimum(p, kv - 1) // 64 - 1) * 64
    skipped = (c >= t0) & (c < t0 + 64) & (t0 >= first)
    masks = {}
    if (skipped & seen).any():
        masks["tile"] = seen & (c >= first) & ~skipped
    if window and window > 1:
        masks["window+1"] = seen & (c > p - window - 1)
        masks["window-1"] = seen & (c > p - window + 1)
    q32, k32, v32 = qd.float(), kd.float(), vd.float()
    shape = args[0].shape
    out = {}
    for name, m in masks.items():
        o = F.scaled_dot_product_attention(q32, k32, v32, attn_mask=m, scale=scale)
        out[name] = (o.reshape(shape) if kernel == "decode"
                     else o.transpose(1, 2).reshape(shape))
    return out


def planted_faults_ragged(inp, want, window, scale, kpool, vpool):
    """planted_faults for a ragged case, segment by segment (each a
    one-sequence prefill over the segment's dense K/V from `kpool`,
    `vpool`); a segment where a fault does not apply keeps `want`'s rows."""
    q = inp["args"][0]
    T, Hk, G, D = q.shape
    out = {}
    lo = 0
    for s, (n, p) in enumerate(inp["segs"]):
        pt = torch.from_numpy(inp["md"]["seg_page_table"][s:s + 1]).to(q.device)
        kd, vd = dense_kv(kpool, pt, Hk, G), dense_kv(vpool, pt, Hk, G)
        pos = torch.arange(p, p + n, device=q.device)[None]
        c = torch.arange(kd.shape[2], device=q.device)
        mask = (c[None, None, :] <= pos[:, :, None])[:, None]
        kvl = torch.tensor([p + n], dtype=torch.int32, device=q.device)
        seg = {"lib": (q[lo:lo + n].reshape(1, n, Hk * G, D).transpose(1, 2), kd, vd,
                       mask, pos),
               "args": (q[lo:lo + n][None], kvl)}
        for name, o in planted_faults("prefill", seg, window, scale).items():
            out.setdefault(name, want.clone())[lo:lo + n] = o[0]
        lo += n
    return out


def code_perms(D: int):
    """The int8 walk's dim orders (paged_flash.cuh code_slice, code_cols):
    q_perm[j] is the dim of Q that the kernel stages at j, o_perm[j] the dim
    that O's column j holds before the epilogue puts it back."""
    g64 = D // 64 * 64
    q_perm = [0] * D
    for d0 in range(0, D, 4):
        width, base = (64, d0 // 64 * 64) if d0 < g64 else (32, g64)
        off = d0 - base
        s, t4 = base // 16 + off % (width // 4) // 4, off // (width // 4)
        for k, d in ((2 * t4, d0), (2 * t4 + 1, d0 + 2), (2 * t4 + 8, d0 + 1),
                     (2 * t4 + 9, d0 + 3)):
            q_perm[16 * s + k] = d
    o_perm = [32 * c + 16 * (w >> 1) + 4 * t4 + (w & 1) + 2 * j
              for c in range(D // 32) for w in range(4) for t4 in range(4)
              for j in range(2)]
    return q_perm, o_perm


def int8_faults(kernel, inp, want, window, scale, softcap):
    """The plain version in f32 with a fault of the int8 walk planted
    (outputs laid out as the kernel's): each token's K or V scale read from
    the slot before it, every scale from the next head, O's columns left in
    the kernel's order, and Q's dims in the kernel's order against K's own.
    Over pools whose scales spread over decades (spread_int8_pool) each
    must break ROW_REL_TOL."""
    kp, vp = inp["kp32"], inp["vp32"]
    D = inp["args"][0].shape[-1]
    q_perm, o_perm = code_perms(D)

    def roll(pool, dim):
        return {"q": pool["q"], "s": pool["s"].roll(1, dims=dim)}

    def plain(**over):
        return gemma_plain_f32(kernel, {**inp, **over}, window, scale, softcap)

    args = inp["args"]
    return {
        "k_scale_token": plain(kp32=roll(kp, 1)),
        "v_scale_token": plain(vp32=roll(vp, 1)),
        "scale_head": plain(kp32=roll(kp, 2), vp32=roll(vp, 2)),
        "cols": want[..., o_perm],
        "dims": plain(args=(args[0][..., q_perm],) + tuple(args[1:])),
    }


def spread_int8_pool(x, gen, decades: float = 3.0):
    """int8_pool of bf16 rows x [NP, PS, Hk, D], each (token, head) row
    first scaled by 10^u, u uniform in [-decades, 0]: scales `decades`
    decades apart, dequantized values at most x's."""
    u = torch.rand(x.shape[:-1], generator=gen, device=x.device) * -decades
    return int8_pool((x.float() * torch.pow(10.0, u)[..., None]).bfloat16())


def gemma_case(kernel, what, heads, case, pools, pools32, gen, dgen, dev,
               lib_pools=None, spread=False, timed=True):
    """One kernel at `heads` (Hk, G, D) and `case` (a GEMMA_CASES tuple):
    checked against the plain version in f32 (max abs error within
    KERNEL_TOL, row_rel_err within ROW_REL_TOL; with no cap, each planted
    fault must break ROW_REL_TOL: on bf16 pools decode and prefill, on
    int8 pools prefill and ragged, and with `spread` (int8 pools from
    spread_int8_pool) decode's and int8_faults too), timed (unless not
    `timed`) with its
    yardstick and the plain version. Int8 dict `pools` are their own f32
    plain operands (`pools32`), and `lib_pools` their dequantized bf16
    pools for the yardstick and the planted faults. Everything it
    allocates is freed on return (the engine phases' peak memory is read
    later)."""
    Hk, G, D = heads
    contexts, window, softcap, scale, q_mul = case
    fn = {"decode": decode_paged_attention, "prefill": prefill_paged_attention,
          "ragged": ragged_paged_attention}[kernel]
    sc = D ** -0.5 if scale is None else scale
    int8 = lib_pools is not None
    inp = gemma_case_inputs(kernel, contexts, Hk, G, D, q_mul, pools, gen, dgen, dev,
                            lib_pools)
    inp["kp32"], inp["vp32"] = pools32
    args = inp["args"]
    kw = dict(scale=scale, softcap=softcap)
    got = fn(*args, window, **kw)
    torch.cuda.synchronize()
    want = gemma_plain_f32(kernel, inp, window, scale, softcap)
    rows = inp["rows"]
    err, rel = case_errors(kernel, got, want, rows)
    if kernel == "prefill":
        zero = all(got[b, n:].float().abs().max().item() == 0.0
                   for b, n in enumerate(rows) if n < GEMMA_CHUNK)
    else:
        tail = got[rows:] if kernel == "ragged" else got[-1:]
        zero = tail.numel() == 0 or tail.float().abs().max().item() == 0.0
    what = f"{what} {kernel}"
    check(torch.isfinite(got.float()).all().item(), f"{what}: not finite")
    check(zero, f"{what}: padding, tail or empty rows are not 0")
    check(err <= KERNEL_TOL, f"{what}: max abs err {err} > {KERNEL_TOL}")
    check(rel <= ROW_REL_TOL, f"{what}: row error {rel} > {ROW_REL_TOL}")
    bad = {}
    if not softcap and (kernel == "prefill" or (kernel == "ragged" and int8)
                        or (kernel == "decode" and (spread or not int8))):
        bad = (planted_faults_ragged(inp, want, window, sc, *lib_pools) if kernel == "ragged"
               else planted_faults(kernel, inp, window, sc))
    if spread:
        bad.update(int8_faults(kernel, inp, want, window, scale, softcap))
    faults = {}
    for name in list(bad):
        faults[name] = case_errors(kernel, bad.pop(name), want, rows)[1]
        check(faults[name] > ROW_REL_TOL,
              f"{what}: planted fault {name} reads {faults[name]}, "
              f"within ROW_REL_TOL {ROW_REL_TOL}")
    if not timed:
        return {"max_abs_err": err, "row_rel_err": rel, "planted_faults": faults}
    b_ms, b_by = gemma_bound(Hk * G, Hk, D, inp["spans"], window, inp["io_rows"],
                             inp["n_ints"], softcap, int8)
    if kernel == "ragged":
        lib_args = args if not int8 else (args[0], *lib_pools) + tuple(args[3:])
        lib = ragged_library(lib_args, inp["segs"], inp["md"], sc, window=window,
                             softcap=softcap)
    else:
        qd, kd, vd, mask, pos = inp["lib"]
        c = torch.arange(kd.shape[2], device=dev)[None, None, None, :]
        mask = mask & (c < args[-1].long()[:, None, None, None])
        if window:
            mask = mask & (c > pos[:, None, :, None] - window)
        lib = (capped_attention(qd, kd, vd, mask, sc, softcap) if softcap else
               lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                                      scale=sc))
    del want

    def call():
        return fn(*args, window, **kw)

    return {"max_abs_err": err, "row_rel_err": rel, "planted_faults": faults,
            "ms": cuda_ms(call), "device_ms": graph_ms(call),
            "plain_ms": cuda_ms(
                lambda: gemma_plain_f32(kernel, inp, window, scale, softcap),
                iters=2, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library": "bmm-tanh-softmax-bmm" if softcap else "sdpa",
            "library_ms": cuda_ms(lib), "library_device_ms": graph_ms(lib)}


def gemma_kernels_phase(dev):
    """The three GQA kernels' Gemma-2 bodies (window, soft cap, scale
    override, D 256) against their plain versions in f32, at Gemma-2's
    heads (Hk 8, G 2, D 256) and the 3B's (Hk 8, G 3, D 128): decode rows
    at the case's contexts (and an empty row), prefill chunks of up to 512
    tokens ending there, and a ragged step of a decode row and a 48-token
    chunk at each. Each case is timed back to back and replayed from a CUDA
    graph beside its yardstick (SDPA under a boolean window mask over
    dense K/V; with a soft cap, the bmm-tanh-softmax-bmm calls), with a
    bound over the visible bytes and operations only."""
    gen = torch.Generator(device="cpu").manual_seed(11)
    dgen = torch.Generator(device=dev).manual_seed(11)
    torch.cuda.synchronize()
    mem = {"start": torch.cuda.memory_allocated()}
    out = {}
    for shape, (Hk, G, D) in GEMMA_SHAPES.items():
        NP = 2 * len(GEMMA_EDGES) * GEMMA_MP + 1
        pools = tuple(torch.randn(NP, PAGE_SIZE, Hk, D, generator=dgen,
                                  device=dev).bfloat16() for _ in range(2))
        pools32 = tuple(x.float() for x in pools)
        rec = {"Hk": Hk, "G": G, "D": D, "smem_bytes": gqa_smem_bytes(D),
               "cases": {}}
        for case, (contexts, window, softcap, scale, q_mul) in GEMMA_CASES.items():
            crec = {"contexts": contexts, "window": window, "softcap": softcap,
                    "scale": scale, "q_scale": q_mul}
            for kernel in ("decode", "prefill", "ragged"):
                crec[kernel] = gemma_case(
                    kernel, f"gemma_kernels {shape} {case}", (Hk, G, D),
                    GEMMA_CASES[case], pools, pools32, gen, dgen, dev)
                torch.cuda.empty_cache()
            rec["cases"][case] = crec
        out[shape] = rec
        del pools, pools32
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem["end"] = torch.cuda.memory_allocated()
    # cuBLAS keeps a workspace for each stream it ran on, here the capped
    # yardstick's matmuls on graph_ms's capture streams: free them, so
    # that they do not count in the engine phases' peak memory
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
        mem["after_clearing_cublas_workspaces"] = torch.cuda.memory_allocated()
    emit({"phase": "gemma_kernels", "tol": KERNEL_TOL, "row_tol": ROW_REL_TOL,
          "memory_allocated_bytes": mem, **out})
    return out


# int8 KV (models/quant.py pools): the int8 bodies of the three GQA kernels
# at `kernels`' D 128 G 3 shapes and at gemma_kernels' Gemma-2 case, and of
# MLA decode at mla_kernels' decode shape; the kernels-line entries they
# head and the TPU kernel bodies they replace
INT8_SOURCES = {
    "decode_paged_attention_int8": (
        "dynamo_tpu_torch/ops/csrc/paged_attention.cu",
        "dynamo_tpu/ops/paged_attention.py:147"),
    "prefill_paged_attention_int8": (
        "dynamo_tpu_torch/ops/csrc/flash_prefill.cu",
        "dynamo_tpu/ops/flash_prefill.py:157"),
    "ragged_paged_attention_int8": (
        "dynamo_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "dynamo_tpu/ops/ragged_paged_attention.py:303"),
    "decode_mla_attention_int8": (
        "dynamo_tpu_torch/ops/csrc/mla_attention.cu",
        "dynamo_tpu/ops/mla_attention.py:107"),
}


def int8_pool(x):
    """An int8 pool quantized from bf16 rows x (codes and scales as the
    engine writes them) and its dequantized bf16 pool, the yardstick's
    operand (dequantized here, outside every timed call)."""
    d = kv_pool_quantize(x)
    return d, kv_pool_dequantize(d, torch.bfloat16)


def int8_record(call, plain, lib, n_bytes, n_flops, err):
    """Times of an int8 kernel call (back to back and replayed), its plain
    version (back to back) and its yardstick, and the bound."""
    b_ms, b_by = bound(n_bytes, n_flops)
    return {"max_abs_err": err, "ms": cuda_ms(call), "device_ms": graph_ms(call),
            "plain_ms": cuda_ms(plain, iters=5), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(lib), "library_device_ms": graph_ms(lib)}


# the engine-shaped int8 MLA decode batch: workload()'s prompt lengths and
# 16 output tokens
MLA_ENGINE_KV = [n + 16 for n in (17, 64, 300, 700, 1100, 1500, 406, 656)]
# kv lengths of the int8 MLA gate: the edges of its 64-token tiles and of its
# first two MLA_INT8_SPLIT_TOKENS splits, 0, 1 and 4096
MLA_I8_EDGES = sorted({0, 1, 4096}
                      | {k * INT8_TILE_TOKENS + d for k in (1, 2, 3) for d in (-1, 0, 1)}
                      | {k * MLA_INT8_SPLIT_TOKENS + d for k in (1, 2) for d in (-1, 0, 1)})
# page sizes of the gate: 16 (the engine's), TMA boxes of 8, 32 and 64 rows
# (64-row boxes inside 128-token pages) and a copy a token at 4 and 48
MLA_I8_PAGE_SIZES = (16, 4, 8, 32, 48, 64, 128)


def mla_int8_bytes(kv_lens):
    """Bytes int8 MLA decode moves at least: q and out once, each context
    token's codes and scale, its table entries and kv_lens."""
    Dl = MLA_DC + MLA_DR
    B = len(kv_lens)
    return (B * MLA_H * (Dl + MLA_DC) * 2 + sum(kv_lens) * (Dl + 4)
            + sum(-(-k // MLA_PS) for k in kv_lens) * 4 + B * 4)


def mla_decode_flops(kv_lens):
    return 2 * sum(kv_lens) * MLA_H * (2 * MLA_DC + MLA_DR)


def mla_int8_perms():
    """The int8 MLA kernel's orders: q_perm[j] the dim of Q it stages at j
    (code_perms' order in each 64-dim chunk), o_perm[j] the dim that O^T's
    row j holds (m-block 64 mb, warp rows 16 w + g + 8 h: dim 64 mb + 16 w
    + 2 g + h)."""
    q_perm, _ = code_perms(MLA_DC + MLA_DR)
    o_perm = [64 * mb + 16 * w + 2 * g + h for mb in range(MLA_DC // 64)
              for w in range(4) for h in range(2) for g in range(8)]
    return q_perm, o_perm


def mla_int8_gate(gen, dev, scale):
    """int8 MLA decode at H 128 with rows at MLA_I8_EDGES, over pools whose
    per-token scales spread over three decades, at MLA_I8_PAGE_SIZES
    (TMA boxes and copies a token), untimed: max abs err within KERNEL_TOL,
    each row's error over its RMS within ROW_REL_TOL, the kv_len-0 row
    exactly 0. At page size 16, faults planted in the plain f32 version must
    each break ROW_REL_TOL: each token's scale read from the slot before
    it, a row's last 64-token tile left out, O's dims left in the kernel's
    order, Q's dims in the kernel's order against the codes' own."""
    dgen = torch.Generator(device=dev).manual_seed(15)
    kv = MLA_I8_EDGES
    B = len(kv)
    kvl = torch.tensor(kv, dtype=torch.int32, device=dev)
    q = torch.randn(B, MLA_H, MLA_DC + MLA_DR, generator=dgen, device=dev).bfloat16()
    out = {"kv_lens": kv, "page_sizes": {}}
    for ps in MLA_I8_PAGE_SIZES:
        MP = -(-max(kv) // ps)
        pt = random_pages(gen, B, MP, B * MP + 1, dev)
        lq, _ = spread_int8_pool(
            torch.randn(B * MP + 1, ps, 1, MLA_DC + MLA_DR, generator=dgen,
                        device=dev).bfloat16(), dgen)
        got = decode_mla_attention(q, lq, pt, kvl, dc=MLA_DC, scale=scale)
        torch.cuda.synchronize()

        def plain(q=q.float(), pool=lq, kvl=kvl):
            return decode_mla_attention_ref(q, pool, pt, kvl, dc=MLA_DC, scale=scale)

        want = plain()
        what = f"int8 MLA decode gate PS {ps}"
        err = (got.float() - want).abs().max().item()
        rel = row_rel_err(got, want)
        check(torch.isfinite(got.float()).all().item(), f"{what}: not finite")
        check(got[kv.index(0)].float().abs().max().item() == 0.0,
              f"{what}: the kv_len-0 row is not 0")
        check(err <= KERNEL_TOL, f"{what}: max abs err {err} > {KERNEL_TOL}")
        check(rel <= ROW_REL_TOL, f"{what}: row error {rel} > {ROW_REL_TOL}")
        rec = {"max_abs_err": err, "row_rel_err": rel}
        if ps == MLA_PS:
            q_perm, o_perm = mla_int8_perms()
            tile = INT8_TILE_TOKENS
            short = torch.tensor([k - 1 - (k - 1) % tile if k > tile else k for k in kv],
                                 dtype=torch.int32, device=dev)
            bad = {"scale_token": plain(pool={"q": lq["q"], "s": lq["s"].roll(1, dims=1)}),
                   "tile_left_out": plain(kvl=short),
                   "cols": want[..., o_perm],
                   "dims": plain(q=q.float()[..., q_perm])}
            rec["planted_faults"] = {}
            for name, x in bad.items():
                f = row_rel_err(x, want)
                rec["planted_faults"][name] = f
                check(f > ROW_REL_TOL, f"{what}: planted fault {name} reads {f}, within "
                                       f"ROW_REL_TOL {ROW_REL_TOL}")
        out["page_sizes"][f"PS{ps}"] = rec
        del lq, got, want
    torch.cuda.empty_cache()
    return out


def kv_quantize_check(dev):
    """kv_quantize on the card against the CPU's on the same bf16 rows:
    codes equal, scales within 1 ulp."""
    gen = torch.Generator(device="cpu").manual_seed(13)
    x = (torch.randn(4096, 8, 128, generator=gen) * 3).bfloat16()
    x[0, 0] = 0.0
    cpu, card = kv_quantize(x), kv_quantize(x.to(dev))
    q_equal = torch.equal(card["q"].cpu(), cpu["q"])
    ulps = (card["s"].cpu().view(torch.int32).long()
            - cpu["s"].view(torch.int32).long()).abs().max().item()
    check(q_equal, "kv_quantize: the card's codes differ from the CPU's")
    check(ulps <= 1, f"kv_quantize: the card's scales differ by {ulps} ulps")
    return {"rows": list(x.shape), "q_equal": q_equal, "s_max_ulps": ulps}


# kv lengths of the int8 gate at the 3B shape: 64-token tile edges, and
# contexts whose walks wrap the 2- and 3-stage rings many times
I8_EDGES = [1, 63, 64, 65, 127, 128, 129, 700, 2047, 2048, 2049, 4095, 4096, 4097]
# ... and, for decode, the edges of its first two context splits
I8_DECODE_EDGES = sorted(set(I8_EDGES) | {k * decode_split_tokens(128, True) + d
                                          for k in (1, 2) for d in (-1, 0, 1)})


def int8_kernels_phase(dev, bf16_ms, gemma_bf16):
    """The int8 bodies against their plain int8 versions in f32 (the scale
    fold in the TPU kernels' order), each timed back to back and as a
    CUDA-graph replay beside its bf16 yardstick over the dequantized K/V,
    with a bound over the codes and scales the data needs: GQA decode,
    prefill and ragged at `kernels`' D 128 G 3 shapes (each held row by
    row too and with the bf16 body's replay from `bf16_ms` {kernel: ms}
    beside it; prefill and ragged over spread_int8_pool pools), the
    gate_3b cases (I8_EDGES, untimed, with planted faults), the Gemma-2 case
    (window 4096, cap 50, scale 1/16) at D 256 G 2 (beside its bf16 row,
    `gemma_bf16` {"decode": record, ...}), MLA decode at its
    main-path shape; and kv_quantize on the card against the CPU's."""
    gen = torch.Generator(device="cpu").manual_seed(12)
    dgen = torch.Generator(device=dev).manual_seed(12)
    Hk, G, D, PS = 8, 3, 128, 16
    H = Hk * G
    scale = D ** -0.5
    torch.cuda.synchronize()
    mem = {"start": torch.cuda.memory_allocated()}
    out = {"kv_quantize": kv_quantize_check(dev)}

    def rnd(*shape):
        return torch.randn(*shape, generator=dgen, device=dev).bfloat16()

    def pools(NP, Hk, D):
        (kq, kd), (vq, vd) = int8_pool(rnd(NP, PS, Hk, D)), int8_pool(rnd(NP, PS, Hk, D))
        return (kq, vq), (kd, vd)

    # decode: `kernels`' rows, kv_len up to 4096, one empty row
    kv_list = [4096, 0, 1, 17, 1000, 2048, 3333, 513]
    B, MP = len(kv_list), 4096 // PS
    (kq, vq), (kd, vd) = pools(B * MP + 1, Hk, D)
    q = rnd(B, Hk, G, D)
    pt = random_pages(gen, B, MP, B * MP + 1, dev)
    kvl = torch.tensor(kv_list, dtype=torch.int32, device=dev)
    got = decode_paged_attention(q, kq, vq, pt, kvl)
    torch.cuda.synchronize()
    want = decode_paged_attention_ref(q.float(), kq, vq, pt, kvl)
    err = (got.float() - want).abs().max().item()
    rel = row_rel_err(got, want)
    check(torch.isfinite(got.float()).all().item(), "int8 decode output not finite")
    check(got[1].float().abs().max().item() == 0.0, "int8 decode kv_len=0 row is not 0")
    check(err <= KERNEL_TOL, f"int8 decode max abs err {err} > {KERNEL_TOL}")
    check(rel <= ROW_REL_TOL, f"int8 decode row error {rel} > {ROW_REL_TOL}")
    kdd, vdd = dense_kv(kd, pt, Hk, G), dense_kv(vd, pt, Hk, G)
    mask = (torch.arange(MP * PS, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    qd = q.reshape(B, H, 1, D)
    n_tok = sum(kv_list)
    out["decode_paged_attention_int8"] = dict(int8_record(
        lambda: decode_paged_attention(q, kq, vq, pt, kvl),
        lambda: decode_paged_attention_ref(q.float(), kq, vq, pt, kvl),
        lambda: F.scaled_dot_product_attention(qd, kdd, vdd, attn_mask=mask,
                                               scale=scale),
        2 * q.numel() * 2 + n_tok * Hk * kv_row_bytes(D, True)
        + sum(-(-k // PS) for k in kv_list) * 4 + B * 4,
        4 * n_tok * H * D, err), row_rel_err=rel,
        bf16_device_ms=bf16_ms.get("decode_paged_attention"),
        shape={"B": B, "Hk": Hk, "G": G, "D": D, "PS": PS, "kv_lens": kv_list})
    del kq, vq, kd, vd, kdd, vdd

    # prefill: S 512, q_len 450 over 700 prior tokens (padding rows after),
    # over pools whose scales spread over three decades
    S, prior, q_len = 512, 700, 450
    kv = prior + q_len
    MP = -(-kv // PS) + 2
    (kq, kd), (vq, vd) = (spread_int8_pool(rnd(MP + 1, PS, Hk, D), dgen) for _ in range(2))
    q = rnd(1, S, Hk, G, D)
    pt = random_pages(gen, 1, MP, MP + 1, dev)
    ints = [torch.tensor([x], dtype=torch.int32, device=dev) for x in (prior, q_len, kv)]
    got = prefill_paged_attention(q, kq, vq, pt, *ints)
    torch.cuda.synchronize()
    want = prefill_paged_attention_ref(q.float(), kq, vq, pt, *ints)
    err = (got[:, :q_len].float() - want[:, :q_len]).abs().max().item()
    rel = row_rel_err(got[:, :q_len], want[:, :q_len])
    check(torch.isfinite(got.float()).all().item(), "int8 prefill output not finite")
    check(got[:, q_len:].float().abs().max().item() == 0.0,
          "int8 prefill padding rows are not 0")
    check(err <= KERNEL_TOL, f"int8 prefill max abs err {err} > {KERNEL_TOL}")
    check(rel <= ROW_REL_TOL, f"int8 prefill row error {rel} > {ROW_REL_TOL}")
    kdd, vdd = dense_kv(kd, pt, Hk, G), dense_kv(vd, pt, Hk, G)
    s_pos = prior + torch.arange(S, device=dev)
    c_pos = torch.arange(MP * PS, device=dev)
    mask = ((c_pos[None, :] <= s_pos[:, None]) & (c_pos[None, :] < kv))[None, None]
    qd = q.reshape(1, S, H, D).transpose(1, 2)
    n_pairs = sum(min(prior + s + 1, kv) for s in range(q_len))
    out["prefill_paged_attention_int8"] = dict(int8_record(
        lambda: prefill_paged_attention(q, kq, vq, pt, *ints),
        lambda: prefill_paged_attention_ref(q.float(), kq, vq, pt, *ints),
        lambda: F.scaled_dot_product_attention(qd, kdd, vdd, attn_mask=mask,
                                               scale=scale),
        q_len * H * D * 2 + q.numel() * 2 + kv * Hk * kv_row_bytes(D, True)
        + (-(-kv // PS)) * 4 + 3 * 4,
        4 * n_pairs * H * D, err), row_rel_err=rel,
        bf16_device_ms=bf16_ms.get("prefill_paged_attention"),
        shape={"S": S, "prior": prior, "q_len": q_len})
    del kq, vq, kd, vd, kdd, vdd

    # ragged: the 264-token mixed step of 8 decode rows and 4 chunks
    segs = [(1, kv - 1) for kv in RAGGED_DECODE_KV] + RAGGED_CHUNKS
    args, md = ragged_inputs(gen, segs, RAGGED_T, Hk, G, D, PS, 4096 // PS, dev)
    (kq, kd), (vq, vd) = spread_int8_pool(args[1], dgen), spread_int8_pool(args[2], dgen)
    a8 = (args[0], kq, vq) + tuple(args[3:])
    got = ragged_paged_attention(*a8)
    torch.cuda.synchronize()
    want = ragged_paged_attention_ref(args[0].float(), kq, vq, *args[3:])
    n = sum(q_len for q_len, _ in segs)
    err = (got[:n].float() - want[:n]).abs().max().item()
    rel = row_rel_err(got[:n], want[:n])
    check(torch.isfinite(got.float()).all().item(), "int8 ragged output not finite")
    check(n == got.shape[0] or got[n:].float().abs().max().item() == 0.0,
          "int8 ragged tail rows are not 0")
    check(err <= KERNEL_TOL, f"int8 ragged max abs err {err} > {KERNEL_TOL}")
    check(rel <= ROW_REL_TOL, f"int8 ragged row error {rel} > {ROW_REL_TOL}")
    kv_tok = sum(q_len + p for q_len, p in segs)
    pairs = sum(p + i + 1 for q_len, p in segs for i in range(q_len))
    out["ragged_paged_attention_int8"] = dict(int8_record(
        lambda: ragged_paged_attention(*a8),
        lambda: ragged_paged_attention_ref(args[0].float(), kq, vq, *args[3:]),
        ragged_library((args[0], kd, vd) + tuple(args[3:]), segs, md, scale),
        n * H * D * 2 + RAGGED_T * H * D * 2 + kv_tok * Hk * kv_row_bytes(D, True)
        + sum(-(-(q_len + p) // PS) for q_len, p in segs) * 4
        + md["seg_kv_lens"].size * 4 + md["meta"].size * 4,
        4 * pairs * H * D, err), row_rel_err=rel,
        bf16_device_ms=bf16_ms.get("ragged_paged_attention"),
        shape={"T": RAGGED_T, "segments": segs})
    del args, a8, kq, vq, kd, vd

    # the gate at the 3B shape (untimed): decode rows at I8_DECODE_EDGES,
    # prefill chunks and ragged steps ending at I8_EDGES, over pools whose
    # scales spread over three decades, held row by row with gemma_case's
    # planted faults and int8_faults
    NP = 2 * len(I8_DECODE_EDGES) * GEMMA_MP + 1
    (kq, kd), (vq, vd) = (spread_int8_pool(rnd(NP, PS, Hk, D), dgen) for _ in range(2))
    out["gate_3b"] = {
        kernel: gemma_case(kernel, "int8_kernels gate_3b", (Hk, G, D),
                           (I8_DECODE_EDGES if kernel == "decode" else I8_EDGES, 0, 0.0,
                            None, 1.0), (kq, vq), (kq, vq), gen, dgen,
                           dev, lib_pools=(kd, vd), spread=True, timed=False)
        for kernel in ("decode", "prefill", "ragged")}
    del kq, vq, kd, vd
    torch.cuda.empty_cache()

    # the Gemma-2 case at D 256 G 2: the int8 window + soft-cap bodies
    Hk2, G2, D2 = GEMMA_SHAPES["D256_G2"]
    NP = 2 * len(GEMMA_EDGES) * GEMMA_MP + 1
    (kq, kd), (vq, vd) = (int8_pool(rnd(NP, PS, Hk2, D2)) for _ in range(2))
    out["gemma2_D256_G2"] = {
        kernel: dict(gemma_case(kernel, "int8_kernels gemma2", (Hk2, G2, D2),
                                GEMMA_CASES["gemma2"],
                                (kq, vq), (kq, vq), gen, dgen, dev, lib_pools=(kd, vd)),
                     bf16_device_ms=gemma_bf16[kernel]["device_ms"])
        for kernel in ("decode", "prefill", "ragged")}
    del kq, vq, kd, vd
    torch.cuda.empty_cache()

    # MLA decode: mla_kernels' decode rows at DeepSeek-V3's shapes, beside
    # the bf16 body's replay; the engine-shaped batch; then the gate
    dc, dr = MLA_DC, MLA_DR
    Dl = dc + dr
    mscale = attn_score_scale(MLA_CONFIG, MLA_CONFIG.qk_nope_head_dim + dr)
    q, lat, pt, kvl = mla_decode_args(gen, dev)
    lq, ld = int8_pool(lat)
    B, MP = len(MLA_DECODE_KV), pt.shape[1]
    got = decode_mla_attention(q, lq, pt, kvl, dc=dc, scale=mscale)
    torch.cuda.synchronize()
    want = decode_mla_attention_ref(q.float(), lq, pt, kvl, dc=dc, scale=mscale)
    err = (got.float() - want.float()).abs().max().item()
    rel = row_rel_err(got, want)
    check(torch.isfinite(got.float()).all().item(), "int8 MLA decode output not finite")
    check(got[1].float().abs().max().item() == 0.0, "int8 MLA decode kv_len=0 row is not 0")
    check(err <= KERNEL_TOL, f"int8 MLA decode max abs err {err} > {KERNEL_TOL}")
    check(rel <= ROW_REL_TOL, f"int8 MLA decode row error {rel} > {ROW_REL_TOL}")
    dense = ld[pt.long()].reshape(B, MP * MLA_PS, Dl)
    mask = (torch.arange(MP * MLA_PS, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    lib_fn, lib_name = mla_library(q[:, :, None], dense, mask, dc, mscale)
    out["decode_mla_attention_int8"] = dict(int8_record(
        lambda: decode_mla_attention(q, lq, pt, kvl, dc=dc, scale=mscale),
        lambda: decode_mla_attention_ref(q.float(), lq, pt, kvl, dc=dc, scale=mscale),
        lib_fn, mla_int8_bytes(MLA_DECODE_KV), mla_decode_flops(MLA_DECODE_KV), err),
        row_rel_err=rel, library=lib_name,
        bf16_device_ms=bf16_ms.get("decode_mla_attention"),
        shape={"B": B, "H": MLA_H, "dc": dc, "dr": dr, "PS": MLA_PS,
               "kv_lens": MLA_DECODE_KV, "split": MLA_INT8_SPLIT_TOKENS})
    del q, lat, lq, ld, dense, want
    # the engine-shaped batch: workload()'s prompts and 16 output tokens,
    # int8 beside the bf16 body on the latent it was quantized from
    q, lat, pt, kvl = mla_decode_args(gen, dev, MLA_ENGINE_KV)
    lq, _ = int8_pool(lat)
    got = decode_mla_attention(q, lq, pt, kvl, dc=dc, scale=mscale)
    torch.cuda.synchronize()
    want = decode_mla_attention_ref(q.float(), lq, pt, kvl, dc=dc, scale=mscale)
    err = (got.float() - want.float()).abs().max().item()
    rel = row_rel_err(got, want)
    check(err <= KERNEL_TOL and rel <= ROW_REL_TOL,
          f"int8 MLA decode, engine shape: max abs err {err}, row error {rel}")
    b_ms, b_by = bound(mla_int8_bytes(MLA_ENGINE_KV), mla_decode_flops(MLA_ENGINE_KV))
    out["decode_mla_attention_int8"]["engine_shape"] = {
        "kv_lens": MLA_ENGINE_KV, "max_abs_err": err, "row_rel_err": rel,
        "device_ms": graph_ms(lambda: decode_mla_attention(q, lq, pt, kvl, dc=dc,
                                                           scale=mscale)),
        "bf16_device_ms": graph_ms(lambda: decode_mla_attention(q, lat, pt, kvl, dc=dc,
                                                                scale=mscale)),
        "bound_ms": b_ms, "bound_by": b_by}
    del q, lat, lq, want
    out["decode_mla_attention_int8"]["gate"] = mla_int8_gate(gen, dev, mscale)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem["end"] = torch.cuda.memory_allocated()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
        mem["after_clearing_cublas_workspaces"] = torch.cuda.memory_allocated()
    emit({"phase": "int8_kernels", "tol": KERNEL_TOL, "memory_allocated_bytes": mem,
          **out})
    return out


# head_shape_kernels: the head shapes (Hk, G, D) of qwen2.5-7b (G 7),
# phi-3-mini-4k (D 96, MHA, a 2047-token window on every layer) and
# llama-3.2-1b (D 64), each with a gemma_kernels case (contexts, window,
# softcap, scale, query scale): decode rows at the contexts (and an empty
# row), prefill chunks of up to 512 tokens ending there, and a ragged step
# of a decode row and a 48-token chunk at each. qwen2.5-7b and
# llama-3.2-1b: `kernels`' decode contexts; phi-3: contexts around the
# window's edge, whose chunks straddle it, and gemma_kernels' 7-token
# window, whose edge moves O(1) outputs
HEAD_SHAPES = {
    "qwen2_G7_D128": ((4, 7, 128), ([4096, 1, 17, 1000, 2048, 3333, 513],
                                    0, 0.0, None, 1.0)),
    "phi3_G1_D96": ((32, 1, 96), ([1, 2046, 2047, 2048, 2049, 4000],
                                  2047, 0.0, None, 1.0)),
    "phi3_G1_D96_window_7": ((32, 1, 96), GEMMA_CASES["window_7"]),
    "llama1b_G4_D64": ((8, 4, 64), ([4096, 1, 17, 1000, 2048, 3333, 513],
                                    0, 0.0, None, 1.0)),
}


def head_shape_kernels_phase(dev):
    """The three GQA kernels at HEAD_SHAPES, bf16 and int8 (the pools
    quantized; the yardstick over them dequantized beforehand), each
    against its plain version in f32 (gemma_case: KERNEL_TOL, ROW_REL_TOL
    and the planted faults) and timed back to back, as a CUDA-graph replay
    and beside the plain version and SDPA, with the bound over what the
    data needs."""
    gen = torch.Generator(device="cpu").manual_seed(17)
    dgen = torch.Generator(device=dev).manual_seed(17)
    out = {}
    for shape, (heads, case) in HEAD_SHAPES.items():
        Hk, G, D = heads
        NP = 2 * len(case[0]) * GEMMA_MP + 1
        bf = tuple(torch.randn(NP, PAGE_SIZE, Hk, D, generator=dgen,
                               device=dev).bfloat16() for _ in range(2))
        rec = {"Hk": Hk, "G": G, "D": D, "smem_bytes": gqa_smem_bytes(D),
               "contexts": case[0], "window": case[1]}
        for kind in ("bf16", "int8"):
            if kind == "bf16":
                pools, pools32, lib = bf, tuple(x.float() for x in bf), None
            else:
                (kq, kd), (vq, vd) = int8_pool(bf[0]), int8_pool(bf[1])
                pools = pools32 = (kq, vq)
                lib = (kd, vd)
            rec[kind] = {kernel: gemma_case(kernel, f"head_shape_kernels {shape} {kind}",
                                            heads, case, pools, pools32, gen, dgen, dev,
                                            lib_pools=lib)
                         for kernel in ("decode", "prefill", "ragged")}
            del pools, pools32, lib
            torch.cuda.empty_cache()
        for kernel, r in rec["int8"].items():  # each int8 row beside its bf16 row
            r["bf16_device_ms"] = rec["bf16"][kernel]["device_ms"]
        out[shape] = rec
        del bf
        torch.cuda.empty_cache()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    emit({"phase": "head_shape_kernels", "tol": KERNEL_TOL, "row_tol": ROW_REL_TOL,
          **out})
    return out


def gemma_phases(dev, smi):
    """gemma-2-9b at full width, 10 layers: `engine_gemma2` (the card's
    default, fused: ragged and decode kernels; a prefill chunk with no
    decode row on the prefill kernel) and `engine_gemma2_unfused`
    (DYN_FUSED_MIXED=0: prefill and decode kernels) on one runner, each
    request finishing `length`, each kernel's launches equal to its
    passes x 10, half of them on the window bodies; then `parity_gemma2`,
    a 4700- and a 4500-token sequence prefilled in 512-token chunks, two
    decode steps and a ragged step with a chunk past the window."""
    runner, cfg, build_s = timed_runner(GEMMA_ARGS, cut=True)
    L = cfg.n_layers
    check(runner.kv_page_shape == (L, PAGE_SIZE, cfg.n_kv_heads, cfg.head_dim),
          f"engine_gemma2: page shape {runner.kv_page_shape}")
    sliding = sum(1 for l in range(L) if l % cfg.sw_period != cfg.sw_global_residue)
    found = {}

    def turn(runner, phase, fused, args):
        # sliding layers launch the window bodies, global layers the others
        body = f"D{cfg.head_dim}" + ("_int8" if runner.kv_quantize else "") + "_softcap"
        win = body.replace("_softcap", "_window_softcap")

        def expect(n):
            return {k: v for k, v in ((win, n // L * sliding),
                                      (body, n - n // L * sliding)) if v}

        rec, _ = served_turn(runner, phase, fused, args, expect, extra=GEMMA_LONG_PROMPTS,
                             build_s=build_s if phase == "gemma2" else None)
        check(max(rec["prompt_tokens"]) > GEMMA_WINDOW,
              f"{phase}: no request ran past the window")
        rec["config"] = {k: getattr(cfg, k) for k in (
            "name", "dim", "n_layers", "n_heads", "n_kv_heads", "head_dim",
            "ffn_dim", "vocab_size", "sliding_window", "attn_logit_softcap",
            "final_logit_softcap", "query_pre_attn_scalar")}
        rec["nvidia_smi"] = smi
        found[phase] = rec["bodies"]
        emit(rec)

    turn(runner, "gemma2", None, GEMMA_ARGS)
    turn(runner, "gemma2_unfused", False, GEMMA_ARGS)
    parity_phase(runner, dev, phase="parity_gemma2", lens=(4700, 180, 4500),
                 S=512, MP=300, NP=960)
    # the int8 turn: the same params over int8 pools (the bf16 pools freed)
    params = runner.params
    free(runner)
    args8 = GEMMA_ARGS + ["--kv-quantize", "int8"]
    runner8, _, _ = timed_runner(args8, params=params, cut=True)
    turn(runner8, "gemma2_int8", None, args8)
    free(runner8)
    return found


CONFIG_FIELDS = ("name", "dim", "n_layers", "n_heads", "n_kv_heads", "head_dim",
                 "ffn_dim", "vocab_size", "sliding_window", "sw_period",
                 "attn_bias", "qk_norm", "qk_norm_wide", "pre_norms", "post_norms",
                 "embed_multiplier", "residual_multiplier", "attn_scale",
                 "logits_divider", "act", "norm_zero_centered", "n_experts",
                 "n_experts_active", "moe_ffn_dim")


def family_turn(runner, phase, fused, args, body, smi, extra=(), build_s=None):
    """served_turn with every launch on `body`, the config and the card
    recorded; with `extra` prompts, one must run past the window. Returns
    (bodies, launches)."""
    rec, launches = served_turn(runner, phase, fused, args, one_body(body),
                                extra=extra, build_s=build_s)
    cfg = runner.config
    if extra and cfg.sliding_window:
        check(max(rec["prompt_tokens"]) > cfg.sliding_window,
              f"{phase}: no request ran past the window")
    rec["config"] = {k: getattr(cfg, k) for k in CONFIG_FIELDS}
    rec["nvidia_smi"] = smi
    emit(rec)
    return rec["bodies"], launches


# qwen2.5-7b: 28 layers (8 served), 28 query heads over 4 KV heads (G 7), q/k/v biases
QWEN2_ARGS = model_args("qwen2.5-7b")
# phi-3-mini-4k: 32 layers (8 served), MHA at head dim 96, a 2047-token window on every
# layer; two prompts past the window
PHI3_ARGS = model_args("phi-3-mini-4k")
PHI3_LONG_PROMPTS = (2600, 3900)


def qwen2_phases(dev, smi):
    """`engine_qwen2` (fused) and `engine_qwen2_unfused` on one runner
    whose q/k/v biases are drawn non-zero (k's larger, as in Qwen2.5
    checkpoints): every request `length`, launches = passes x 28, all on
    D128 (G 7); then `parity_qwen2`. Returns the fused launches and both
    phases' bodies."""
    runner, cfg, build_s = timed_runner(QWEN2_ARGS, cut=True)
    check(cfg.n_heads // cfg.n_kv_heads == 7 and cfg.attn_bias,
          f"engine_qwen2: not qwen2.5-7b's heads: {cfg}")
    g = torch.Generator(device=dev).manual_seed(5)
    for name, std in (("bq", 0.5), ("bk", 2.0), ("bv", 0.5)):
        b = runner.params["layers"][name]
        b.copy_(torch.randn(b.shape, generator=g, device=dev) * std)
    found, fused_launches = {}, None
    for phase, fused in (("qwen2", None), ("qwen2_unfused", False)):
        found[phase], launches = family_turn(
            runner, phase, fused, QWEN2_ARGS, "D128", smi,
            build_s=build_s if fused is None else None)
        fused_launches = fused_launches or launches
    parity_phase(runner, dev, phase="parity_qwen2")
    free(runner)
    return fused_launches, found


def phi3_phases(dev, smi):
    """`engine_phi3` (fused), `engine_phi3_unfused` and, on the same params
    over int8 pools, `engine_phi3_int8`: the 3B's traffic and two prompts
    past the 2047-token window, every request `length`, launches = passes
    x 8, all on D96_window (int8: D96_int8_window); between them
    `parity_phi3`, a 2600- and a 2300-token sequence prefilled in 512-token
    chunks, two decode steps and a ragged step, all past the window.
    Returns the fused bf16 and int8 launches and every phase's bodies."""
    runner, cfg, build_s = timed_runner(PHI3_ARGS, cut=True)
    check(cfg.head_dim == 96 and cfg.n_heads == cfg.n_kv_heads
          and {layer_window(cfg, l) for l in range(cfg.n_layers)} == {2047},
          f"engine_phi3: not phi-3's heads and window: {cfg}")
    found, fused_launches = {}, None
    for phase, fused in (("phi3", None), ("phi3_unfused", False)):
        found[phase], launches = family_turn(
            runner, phase, fused, PHI3_ARGS, "D96_window", smi,
            extra=PHI3_LONG_PROMPTS, build_s=build_s if fused is None else None)
        fused_launches = fused_launches or launches
    parity_phase(runner, dev, phase="parity_phi3", lens=(2600, 180, 2300), S=512,
                 MP=170, NP=520)
    params = runner.params
    free(runner)
    args8 = model_args("phi-3-mini-4k", kv_quantize=True)
    runner8, _, _ = timed_runner(args8, params=params, cut=True)
    found["phi3_int8"], int8_launches = family_turn(
        runner8, "phi3_int8", None, args8, "D96_int8_window", smi,
        extra=PHI3_LONG_PROMPTS)
    free(runner8)
    return fused_launches, int8_launches, found


# the other dense families, one fused turn each at full width and the
# depth of DEPTH_CUTS (llama-3.2-1b at its full 16 layers):
# (preset, max_seq_len, prompts added to the 3B's, the body every launch
# takes, int8 pools). Mistral's prompts run past its 4096-token window;
# llama-3.2-1b (16 layers, Hk 8, G 4) is the card's path through the D 64
# bodies, over int8 pools
FAMILIES = {
    "qwen3": ("qwen3-8b", 4096, (), "D128", False),
    "mistral": ("mistral-7b", 8192, (4600, 5200), "D128_window", False),
    "gemma7b": ("gemma-7b", 4096, (), "D256", False),
    "olmo2": ("olmo-2-7b", 4096, (), "D128", False),
    "granite": ("granite-3.1-8b", 4096, (), "D128", False),
    "llama1b_int8": ("llama-3.2-1b", 4096, (), "D64_int8", True),
}


def families_phase(dev, smi):
    """Each of FAMILIES in turn, random weights freed before the next:
    `engine_<family>` (fused) and `parity_<family>`. Returns the bodies."""
    found = {}
    for fam, (model, max_seq_len, extra, body, int8) in FAMILIES.items():
        args = model_args(model, max_seq_len, kv_quantize=int8)
        runner, _, build_s = timed_runner(args, cut=model in DEPTH_CUTS)
        found[fam], _ = family_turn(runner, fam, None, args, body, smi, extra=extra,
                                    build_s=build_s)
        parity_phase(runner, dev, phase=f"parity_{fam}")
        free(runner)
    return found


# -- MoE: the grouped GEMM and the MoE models ---------------------------------

# the grouped GEMM's cases: each model's (E, F, n_experts, k) and the
# tokens a step gives it: a decode batch of 8, the fused ragged step (T
# 264) and a 512-token chunk
MOE_SHAPES = {"qwen3-30b-a3b": ((2048, 768, 128, 8), (8, 264, 512)),
              "deepseek-v3": ((7168, 2048, 256, 8), (8, 512))}
MOE_ROUTINGS = ("uniform", "skewed")
# the kernels line's case: qwen3-30b-a3b's fused step, uniform routing
MOE_HEAD = ("qwen3-30b-a3b", 264, "uniform")
# x's RMS in the kernel cases held to KERNEL_TOL: a quarter of a normed
# hidden state's. With the init's 1/sqrt(fan_in) weights, g and u then have
# an RMS of about 0.25 and h and y about 0.03, so KERNEL_TOL is about a
# typical output there and the max-abs limit is nominal: the row gates
# (ROW_REL_TOL, each row against its own scale) carry the check. At RMS
# 0.5 the reference's bf16 roundings of the largest outputs already reach
# 0.0314 on an H100 (PERF.md §6, the grouped GEMM), so no max-abs limit
# holds at the engine's scale; MOE_RMS1_CASES run there, at the RMS 1 of
# the engine's normed x, held by the row gates alone
MOE_X_RMS = 0.25
MOE_RMS1_CASES = (("qwen3-30b-a3b", 264, "uniform"), ("deepseek-v3", 8, "uniform"))


def moe_routing(gen, T, k, n, how):
    """sel [T, k]: `uniform`, k distinct experts a token drawn uniformly;
    `skewed`, half the pairs on expert 0 and the rest on experts 1 to
    n/2 - 1, so that the upper half of the experts gets no row (padding
    tokens of a bucket all route alike; the kernel takes any sel)."""
    if how == "uniform":
        return torch.rand(T, n, generator=gen).topk(k, dim=-1).indices
    pick = torch.randint(1, n // 2, (T, k), generator=gen)
    return torch.where(torch.rand(T, k, generator=gen) < 0.5, 0, pick)


def row_errs(got, want, scale=None):
    """The grouped GEMM's row errors: over the rows (the last dim), the max
    of each row's max abs error against `want` divided by the row's RMS
    (row_rel_err's form), and divided by the row's max abs value, both taken in
    `scale` (default `want`; a planted fault is read against the right
    rows' scale). A row with no error reads 0."""
    want = want.float()
    scale = want if scale is None else scale.float()
    err = (got.float() - want).abs().amax(-1)

    def form(den):
        return torch.where(err == 0, 0.0, err / den).max().item()

    return {"rms": form(scale.square().mean(-1).sqrt()),
            "max": form(scale.abs().amax(-1))}


def skipped_rows(a, r0, r1, skip):
    """The rows of a [r1 - r0, K] that skip = (s0, s1, k0) covers, as
    (first, end) in a's rows, with the K slice k0 .. k0 + MOE_BK zeroed:
    a ring stage the kernel skipped (None where the spans miss)."""
    if skip is None:
        return None
    s0, s1, k0 = skip
    lo, hi = max(r0, s0), min(r1, s1)
    if lo >= hi:
        return None
    part = a[lo - r0:hi - r0].clone()
    part[:, k0:k0 + md.MOE_BK] = 0
    return lo, hi, part


def gate_up_plain32(x, tok, wg, wu, tiles, wrong_row=None, skip=None):
    """moe_gate_up's plain version in f32 from the bf16 operands, expert by
    expert (each expert's weights converted on their own: V3's in f32
    would be 15 GB). wrong_row plants a fault: that row computed with the
    next expert's weights; skip = (first row, end row, k0) another: those
    rows with the 64-deep K slice from k0 left out of both sums."""
    n = wg.shape[0]
    h = torch.zeros(tok.shape[0], wg.shape[-1], device=x.device)
    for e, r0, r1 in md.expert_rows(tiles):
        xr = x[tok[r0:r1].long()].float()
        h[r0:r1] = F.silu(xr @ wg[e].float()) * (xr @ wu[e].float())
        if wrong_row is not None and r0 <= wrong_row < r1:
            xw, f = xr[wrong_row - r0], (e + 1) % n
            h[wrong_row] = F.silu(xw @ wg[f].float()) * (xw @ wu[f].float())
        part = skipped_rows(xr, r0, r1, skip)
        if part is not None:
            lo, hi, xs = part
            h[lo:hi] = F.silu(xs @ wg[e].float()) * (xs @ wu[e].float())
    return h


def down_plain32(h, wd, tiles, wrong_row=None, skip=None):
    """moe_down's plain version in f32 (and its two faults)."""
    n = wd.shape[0]
    y = torch.zeros(h.shape[0], wd.shape[-1], device=h.device)
    for e, r0, r1 in md.expert_rows(tiles):
        hr = h[r0:r1].float()
        y[r0:r1] = hr @ wd[e].float()
        if wrong_row is not None and r0 <= wrong_row < r1:
            y[wrong_row] = h[wrong_row].float() @ wd[(e + 1) % n].float()
        part = skipped_rows(hr, r0, r1, skip)
        if part is not None:
            lo, hi, hs = part
            y[lo:hi] = hs @ wd[e].float()
    return y


def moe_case(what, x, sel, wg, wu, wd, k, abs_gate=True):
    """Both grouped-GEMM entries on one routing, against their plain
    versions in f32: max abs error (held to KERNEL_TOL with `abs_gate`), the row errors over the row's RMS
    (row_rel_err's form) and over the row's max abs value, the planted faults
    (a pair on the wrong expert, the last tile dropped, the last tile's
    middle 64-deep K slice left out: a ring stage skipped), times (b2b and
    CUDA-graph replay) beside the plain version (the per-expert
    torch.matmul loop), the dense every-expert form (the reference's) and
    torch._grouped_mm where the card's torch has it, and the bound."""
    dev = x.device
    T, E = x.shape
    n, _, F_ = wg.shape
    r = md.route(sel.to(dev), n)
    h = md.moe_gate_up(x, r.tok, wg, wu, r.tiles)
    y = md.moe_down(h, wd, r.tiles)
    torch.cuda.synchronize()
    live = [t for t in r.tiles.tolist() if t[0] >= 0]
    counts = torch.bincount(sel.reshape(-1), minlength=n)
    touched = int((counts > 0).sum())
    P = T * k
    # the faults: the first row of the last expert with rows on the next
    # expert's weights; the rows of the last tile left 0; the last tile's
    # rows without the middle 64-deep K slice of their sums
    wrong = md.expert_rows(r.tiles)[-1][1]
    last0, last1 = live[-1][1], live[-1][2]
    out = {"routing": what, "T": T, "pairs": P, "touched_experts": touched,
           "x_rms": x.float().square().mean().sqrt().item(), "abs_gated": abs_gate,
           "tiles": len(live), "grid_tiles": r.tiles.shape[0],
           "max_rows_an_expert": int(counts.max())}
    entries = {
        "moe_gate_up": (h, lambda wr=None, sk=None: gate_up_plain32(
            x, r.tok, wg, wu, r.tiles, wr, sk), "max", E),
        "moe_down": (y, lambda wr=None, sk=None: down_plain32(h, wd, r.tiles, wr, sk),
                     "rms", F_),  # each with its K: the skipped stage's depth
    }
    for name, (got, plain, gate, K) in entries.items():
        want = plain()
        check(torch.isfinite(got.float()).all().item(), f"{name} {what}: not finite")
        err = (got.float() - want).abs().max().item()
        rel = row_errs(got, want)
        dropped = want.clone()
        dropped[last0:last1] = 0
        k_mid = K // md.MOE_BK // 2 * md.MOE_BK
        faults = {"wrong_expert": plain(wrong), "dropped_tile": dropped,
                  "skipped_stage": plain(sk=(last0, last1, k_mid))}
        fault_rel = {f: row_errs(got, w, want)[gate] for f, w in faults.items()}
        out[name] = {"max_abs_err": err, "row_rel_err_rms": rel["rms"],
                     "row_rel_err_max": rel["max"], "row_gate": gate,
                     "planted_faults": fault_rel}
    # bounds: the touched experts' weights, each input row read once and
    # each output row written once, the maps; or the FLOPs
    maps = P * 4 + r.tiles.numel() * 4
    gu_bytes = touched * 2 * E * F_ * 2 + T * E * 2 + P * F_ * 2 + maps
    dn_bytes = touched * F_ * E * 2 + P * F_ * 2 + P * E * 2 + r.tiles.numel() * 4
    bounds = {"moe_gate_up": bound(gu_bytes, 2 * P * E * F_ * 2),
              "moe_down": bound(dn_bytes, 2 * P * F_ * E)}
    # yardsticks: the dense every-expert form over all n experts, and
    # torch._grouped_mm over the sorted rows (x gathered, h as it is)
    h_dense = F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu)
    calls = {
        "moe_gate_up": (lambda: md.moe_gate_up(x, r.tok, wg, wu, r.tiles),
                        lambda: md.moe_gate_up_ref(x, r.tok, wg, wu, r.tiles),
                        lambda: F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu)),
        "moe_down": (lambda: md.moe_down(h, wd, r.tiles),
                     lambda: md.moe_down_ref(h, wd, r.tiles),
                     lambda: torch.matmul(h_dense, wd)),
    }
    offs = torch.cumsum(counts, 0).to(torch.int32).to(dev)
    xs = x[r.tok.long()]
    grouped = {"moe_gate_up": lambda: (torch._grouped_mm(xs, wg, offs=offs),
                                       torch._grouped_mm(xs, wu, offs=offs)),
               "moe_down": lambda: torch._grouped_mm(h, wd, offs=offs)}
    for name, (kern, plain, dense) in calls.items():
        bms, by = bounds[name]
        rec = out[name]
        rec.update({"ms": cuda_ms(kern), "device_ms": graph_ms(kern),
                    "plain_ms": cuda_ms(plain, iters=5, warmup=1),
                    "bound_ms": bms, "bound_by": by,
                    "dense_ms": cuda_ms(dense, iters=5, warmup=1),
                    "dense_device_ms": graph_ms(dense, iters=5, replays=2)})
        try:
            rec["grouped_mm_ms"] = cuda_ms(grouped[name])
            rec["grouped_mm_device_ms"] = graph_ms(grouped[name])
        except (AttributeError, RuntimeError) as e:  # a yardstick only
            rec["grouped_mm_ms"] = rec["grouped_mm_device_ms"] = None
            rec["grouped_mm_error"] = str(e)[:200]
        rec["device_ms_over_bound"] = rec["device_ms"] / bms
    del h_dense, xs
    emit({"phase": "moe_case", **out})
    for name in MOE_KERNELS:  # the checks, after the record is out
        rec = out[name]
        err, gate = rec["max_abs_err"], rec["row_gate"]
        rel = rec[f"row_rel_err_{gate}"]
        check(not abs_gate or err <= KERNEL_TOL,
              f"{name} {what}: max abs err {err} > {KERNEL_TOL}")
        check(rel <= ROW_REL_TOL,
              f"{name} {what}: row error {rel} ({gate} form) > {ROW_REL_TOL}")
        for f, v in rec["planted_faults"].items():
            check(v > ROW_REL_TOL, f"{name} {what}: the planted {f} reads {v}, "
                  f"under {ROW_REL_TOL}")
    return out


def moe_sync_check(x, wg, wu, wd, k, dev):
    """One moe_block (routing, both entries, the combine) on CUDA tensors
    under torch.cuda.set_sync_debug_mode("error"): any host sync raises.
    Its output beside the every-expert path's (information)."""
    cfg = get_config("qwen3-30b-a3b")
    gen = torch.Generator(device=dev).manual_seed(7)
    E, n = wg.shape[1], wg.shape[0]
    lp = {"w_router": (torch.randn(E, n, generator=gen, device=dev) * E ** -0.5
                       ).bfloat16(),
          "we_gate": wg, "we_up": wu, "we_down": wd}
    xb = x[None]
    torch.cuda.synchronize()
    before = md.moe_gate_up.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = moe_model.moe_block(cfg, lp, xb, "kernel")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(md.moe_gate_up.launches == before + 1, "moe_block did not launch the kernel")
    ref = moe_model.moe_block(cfg, lp, xb, "ref")
    return {"T": x.shape[0], "host_syncs": 0,
            "vs_every_expert_max_abs": (y.float() - ref.float()).abs().max().item(),
            "vs_every_expert_row_errs": row_errs(y[0], ref[0])}


def moe_kernels_phase(dev):
    """Both grouped-GEMM entries at qwen3-30b-a3b's and DeepSeek-V3's
    expert shapes, random bf16 weights at the init's scale, each T of
    MOE_SHAPES under each routing of MOE_ROUTINGS at x RMS MOE_X_RMS, and
    MOE_RMS1_CASES again at x RMS 1 (row gates alone); then the sync
    check. Returns the kernels line's records (MOE_HEAD's case; its
    max_abs_err the largest of the cases held to KERNEL_TOL)."""
    lib = _build.load()["moe_grouped_gemm"]
    check(lib.moe_tile_rows() == md.MOE_BM,
          f"grouped GEMM tiles of {lib.moe_tile_rows()} rows, route's {md.MOE_BM}")
    gen = torch.Generator(device="cpu").manual_seed(11)
    dgen = torch.Generator(device=dev).manual_seed(11)
    cases, rms1, head, sync = [], [], {}, None
    for model, ((E, F_, n, k), Ts) in MOE_SHAPES.items():
        def w(*shape):
            return torch.randn(shape, generator=dgen, device=dev,
                               dtype=torch.bfloat16).mul_(shape[-2] ** -0.5)
        wg, wu, wd = w(n, E, F_), w(n, E, F_), w(n, F_, E)
        for T in Ts:
            x = (torch.randn(T, E, generator=dgen, device=dev) * MOE_X_RMS).bfloat16()
            for how in MOE_ROUTINGS:
                rec = moe_case(f"{model} T {T} {how}", x,
                               moe_routing(gen, T, k, n, how), wg, wu, wd, k)
                rec.update(model=model, routing=how)
                cases.append(rec)
                if (model, T, how) == MOE_HEAD:
                    head = rec
            if (model, T) == MOE_HEAD[:2]:
                sync = moe_sync_check(x, wg, wu, wd, k, dev)
            for how in (h for m, t, h in MOE_RMS1_CASES if (m, t) == (model, T)):
                x1 = (x.float() / MOE_X_RMS).bfloat16()
                rec = moe_case(f"{model} T {T} {how} x RMS 1", x1,
                               moe_routing(gen, T, k, n, how), wg, wu, wd, k,
                               abs_gate=False)
                rec.update(model=model, routing=how)
                rms1.append(rec)
        del wg, wu, wd
        gc.collect()
        torch.cuda.empty_cache()
    # each entry's registers and spills in both configurations, 128 x 128
    # and 64 x 64 items (ptxas -v, when built in this run)
    ents = ptxas_entries(_build.build_log.get("moe_grouped_gemm", ""))
    ptxas = {name: {cfg: ents.get(f"moe_gemm_kernel<{gated},{small},0>")
                    for cfg, small in (("128x128", 0), ("64x64", 1))}
             for name, gated in zip(MOE_KERNELS, (1, 0))}
    emit({"phase": "moe_kernels", "tol": KERNEL_TOL, "row_tol": ROW_REL_TOL,
          "x_rms": MOE_X_RMS, "tile_rows": md.MOE_BM, "ptxas": ptxas,
          "sync_check": sync,
          "cases": [{k: c[k] for k in ("model", "T", "routing")} for c in cases],
          "row_gated_only_at_x_rms_1": [{k: c[k] for k in ("model", "T", "routing")}
                                        for c in rms1]})
    out = {}
    for name in MOE_KERNELS:
        rec = dict(head[name])
        rec["max_abs_err"] = max(c[name]["max_abs_err"] for c in cases)
        # torch._grouped_mm computes moe_down in one call; gate/up takes two
        # and the SwiGLU besides, so it has no one-call yardstick
        rec["library_ms"] = rec["grouped_mm_ms"] if name == "moe_down" else None
        rec["case"] = {"model": MOE_HEAD[0], "T": MOE_HEAD[1], "routing": MOE_HEAD[2]}
        out[name] = rec
    return out


class record_selections:
    """Within it, every moe_block's routing (weights, top-k ids) is kept in
    call order (parity_phase's `moe_sels`: each step runs the kernel path's
    layers, then the plain path's). With `pin`, the plain path's block l
    takes the kernel path's routing of block l instead of its own, so the
    two paths compute the same experts and differ only in arithmetic."""

    def __init__(self, moe_layers: int, pin: bool = False):
        self.moe_layers, self.pin = moe_layers, pin

    def __enter__(self):
        self.sels, self._orig = [], moe_model.router_topk
        routes = []

        def recording(*a, **kw):
            weights, sel = self._orig(*a, **kw)
            i = len(routes) % (2 * self.moe_layers)
            if self.pin and i >= self.moe_layers:  # the plain path
                weights, sel = routes[-self.moe_layers]
            routes.append((weights, sel))
            self.sels.append(sel)
            return weights, sel

        moe_model.router_topk = recording
        return self.sels

    def __exit__(self, *exc):
        moe_model.router_topk = self._orig


def selection_flips(sels, n_paths: int, moe_layers: int, real):
    """The top-k choices of the kernel path (the first of parity_phase's
    paths) that the plain path (the second) did not make, over every
    step's MoE layers, at the step's real tokens (`real`, one mask a step;
    padding tokens are routed too, on other attention outputs in each
    path): each path's forward runs its layers in turn, the paths one
    after the other."""
    chunks = [sels[i:i + moe_layers] for i in range(0, len(sels), moe_layers)]
    check(len(chunks) == n_paths * len(real),
          f"{len(chunks)} MoE forwards recorded for {len(real)} steps")
    choices = differ = tokens = token_layers = 0
    for step, mask in enumerate(real):
        i = step * n_paths
        for a, b in zip(chunks[i], chunks[i + 1]):
            a, b = a[mask.to(a.device)], b[mask.to(b.device)]
            same = (a[..., :, None] == b[..., None, :]).any(-1)
            choices += a.numel()
            differ += int((~same).sum())
            tokens += int((~same).any(-1).sum())
            token_layers += a.shape[0]
    return {"choices": choices, "choices_differing": differ,
            "token_layers": token_layers, "token_layers_differing": tokens}


def moe_parity(runner, dev, phase, **kw):
    """parity_phase on a MoE model three times: `<phase>_free`, each path
    routing on its own logits (information: a top-k choice near a tie
    flips between paths that differ in bf16 rounding, and a flipped
    expert moves the token's output by its whole weight), then `<phase>`,
    the plain path on the kernel path's routing, held to FORWARD_REL_TOL.
    Both report the choices that differ (0 when pinned). Last,
    `repeat_<model>`: the kernel path twice, held to equal logits."""
    with record_selections(runner.moe_layers) as sels:
        parity_phase(runner, dev, phase=f"{phase}_free", moe_sels=sels, gate=False,
                     **kw)
    with record_selections(runner.moe_layers, pin=True) as sels:
        parity_phase(runner, dev, phase=phase, moe_sels=sels, **kw)
    parity_phase(runner, dev, phase=phase.replace("parity", "repeat"),
                 against="kernel", **kw)


# qwen3-30b-a3b: 48 MoE layers (8 served; 128 experts, top 8, width 768),
# 32 / 4 heads (G 8) at D 128 with qk-norm
QWEN3MOE_ARGS = model_args("qwen3-30b-a3b")


def qwen3moe_phases(dev, smi):
    """`engine_qwen3moe` (fused) and `engine_qwen3moe_unfused` on one
    runner at full width, 8 layers: every request `length`, each GQA
    kernel's launches = passes x 8 on D128 (G 8), each grouped-GEMM
    entry's = passes x 8; then `parity_qwen3moe` with the top-k choices
    that differ between the paths. Returns the fused launches and the
    phases' bodies."""
    runner, cfg, build_s = timed_runner(QWEN3MOE_ARGS, cut=True)
    check(cfg.n_heads // cfg.n_kv_heads == 8 and runner.moe_layers == cfg.n_layers,
          f"engine_qwen3moe: not qwen3-30b-a3b's heads and experts: {cfg}")
    found, fused_launches = {}, None
    for phase, fused in (("qwen3moe", None), ("qwen3moe_unfused", False)):
        found[phase], launches = family_turn(
            runner, phase, fused, QWEN3MOE_ARGS, "D128", smi,
            build_s=build_s if fused is None else None)
        check(launches["moe_gate_up"] > 0, f"{phase}: the grouped GEMM never ran")
        fused_launches = fused_launches or launches
    moe_parity(runner, dev, "parity_qwen3moe")
    free(runner)
    return fused_launches, found


def mla_moe_phases(dev, smi):
    """DeepSeek-V3's three dense layers and its first MoE layer at full
    width (256 experts, sigmoid gates with the selection bias, 8 groups
    keeping 4, routed scale 2.5, one shared expert): `engine_mla_moe` on
    the padded fallback (MLA launches = passes x 4, grouped GEMM = passes
    x 1 each) and `parity_mla_moe`."""
    cfg = MLA_MOE_CONFIG
    t0 = time.monotonic()
    runner = ModelRunner(cfg, num_pages=2048, page_size=PAGE_SIZE,
                         max_pages_per_seq=4096 // PAGE_SIZE)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    check(runner.moe_layers == 1 and "layers_dense" in runner.params,
          f"engine_mla_moe: {runner.moe_layers} MoE layers")
    # the selection bias drawn away from 0, so that it moves the choice
    g = torch.Generator(device=dev).manual_seed(6)
    bias = runner.params["layers"]["router_bias"]
    bias.copy_(torch.randn(bias.shape, generator=g, device=dev) * 0.01)
    rec, launches, results = engine_phase(runner, "mla_moe", build_s=build_s)
    st = rec["stats"]
    check(rec["fused_mixed"], "engine_mla_moe: the engine did not fuse on the card")
    check(st["padded_prefill_dispatches"] > 0 and st["ragged_mixed_dispatches"] == 0,
          f"engine_mla_moe: mixed plans did not take the padded fallback: {st}")
    for i, (toks, finish, _) in enumerate(results):
        check(finish == "length" and len(toks) == N_OUT,
              f"engine_mla_moe: r{i} finished {finish!r} with {len(toks)} tokens")
    rec["config"] = {k: getattr(cfg, k) for k in (
        "name", "dim", "n_layers", "n_dense_layers", "n_experts", "n_experts_active",
        "moe_ffn_dim", "n_shared_experts", "moe_scoring", "n_expert_groups",
        "topk_groups", "moe_routed_scale")}
    rec["nvidia_smi"] = smi
    emit(rec)
    moe_parity(runner, dev, "parity_mla_moe", ragged=False)
    free(runner)
    return launches


# -- weight-only quantization: the quantized GEMMs and the quantized models ----

QUANT_MODES = ("int8", "fp8")
# the rows of x a launch takes on the main path: decode buckets 1, 8 and
# 64, the fused ragged step (T 264) and a padded prefill batch
QGEMM_M = (1, 8, 64, 264, 2048)
# the matrices each layout serves, (K, N): llama-3.1-8b's and mixtral's in
# the KN layout (x @ W), llama-3.2-3b's tied embedding in the NK layout
QGEMM_SHAPES = {
    "kn": {"llama-3.1-8b wq/wo": (4096, 4096), "llama-3.1-8b wk/wv": (4096, 1024),
           "llama-3.1-8b w_gate/w_up": (4096, 14336),
           "llama-3.1-8b w_down": (14336, 4096),
           "llama-3.1-8b lm_head": (4096, 128256),
           "mixtral-8x7b lm_head": (4096, 32000)},
    "nk": {"llama-3.2-3b embed (tied head)": (3072, 128256)},
}
# each kernels-line entry's case (layout, code, matrix, M) and the engine
# phase whose launches it reports
QGEMM_ENTRIES = {
    "quant_gemm_kn_int8": ("kn", "int8", "llama-3.1-8b w_gate/w_up", 8, "quant"),
    "quant_gemm_kn_fp8": ("kn", "fp8", "llama-3.1-8b w_gate/w_up", 8, "quant_fp8_3b"),
    "quant_gemm_nk_fp8": ("nk", "fp8", "llama-3.2-3b embed (tied head)", 8,
                          "quant_fp8_3b"),
}
# the cases that also carry planted faults: every layout and code at the
# decode batch and the fused step
QGEMM_FAULT_M = (8, 264)
# edges, untimed: N a multiple of 32 but not of 64 (a block's second warp
# column past the end), K a multiple of 64 but not of 256 (the decode
# rows on the prefill tiles), and row counts that end inside a tile
QGEMM_EDGES = {"kn": ((4096, 4128), (4160, 1024)), "nk": ((3072, 4128),)}
QGEMM_EDGE_M = (1, 17, 65, 130)
QUANT_SOURCE = ("dynamo_tpu_torch/ops/csrc/quant_gemm.cu",
                "dynamo_tpu/models/quant.py:41 (mm; XLA fuses the dequantization, "
                "no Pallas kernel)")
MOE_QUANT_SOURCE = ("dynamo_tpu_torch/ops/csrc/moe_grouped_gemm.cu",
                    "dynamo_tpu/models/moe.py:66 (mm on quantized experts under an "
                    "XLA vmap; no Pallas kernel)")
QUANT_SOURCES = {**{name: QUANT_SOURCE for name in QGEMM_ENTRIES},
                 "moe_gate_up_int8": MOE_QUANT_SOURCE, "moe_down_int8": MOE_QUANT_SOURCE}


def qgemm_weight(K, N, nk, mode, dgen, dev):
    """A quantized weight at the init's scale: KN codes [K, N] with column
    scales, or an NK table [N, K] with row scales (the tied embedding),
    held to what the kernel takes, as a tree's leaves are."""
    w = torch.randn(N, K, generator=dgen, device=dev).mul_(K ** -0.5).bfloat16()
    out = quantize_embed(w, mode) if nk else quantize_weight(w.T.contiguous(), mode)
    qg.check_weight(out["q"], out["s"], nk)
    return out


def qgemm_dequantized(w, nk):
    """The bf16 weight [K, N] the yardstick multiplies by (outside its timing)."""
    if nk:
        return (w["q"].float() * w["s"]).T.bfloat16().contiguous()
    return dequantize_weight(w, torch.bfloat16)


def flip_sign(q, k, n, nk):
    """The codes with the one at (k, n) of the product negated."""
    q = q.clone()
    at = (n, k) if nk else (k, n)
    q[at] = (-q[at].float()).to(q.dtype)
    return q


def qgemm_faults(x, w, nk, got, want):
    """Faults planted in the plain version, each read as the kernel's row
    error against it (row_errs' RMS form): the scales dropped (s = 1),
    the largest code that x's largest element meets with its sign flipped,
    and the middle 64-deep K stage left out of every sum."""
    K = x.shape[-1]
    ones = torch.ones_like(w["s"])
    k = int(x.float().abs().amax(0).argmax())
    codes_k = (w["q"][:, k] if nk else w["q"][k]).float().abs()
    n = int(codes_k.argmax())
    k0 = K // qg.QGEMM_BK // 2 * qg.QGEMM_BK
    xs = x.clone()
    xs[:, k0:k0 + qg.QGEMM_BK] = 0
    faults = {"scale_dropped": qg.quant_matmul_ref(x, w["q"], ones, nk),
              "code_sign_flipped": qg.quant_matmul_ref(x, flip_sign(w["q"], k, n, nk),
                                                       w["s"], nk),
              "k_stage_skipped": qg.quant_matmul_ref(xs, w["q"], w["s"], nk)}
    return {f: row_errs(got, v, want)["rms"] for f, v in faults.items()}


def qgemm_case(layout, mode, what, K, N, M, w, w_bf16, dgen, dev):
    """One launch shape against the plain version (max abs error; per row,
    the max error over the row's RMS), timed (b2b and CUDA-graph replay)
    beside the plain version and the yardstick, torch.matmul on the
    dequantized bf16 weight (cuBLAS: the unquantized model's product), with
    the bound (codes, scales, x and y at the HBM rate, or the products at
    the bf16 peak)."""
    nk = layout == "nk"
    x = (torch.randn(M, K, generator=dgen, device=dev) * MOE_X_RMS).bfloat16()
    got = qg.quant_matmul(x, w["q"], w["s"], nk)
    want = qg.quant_matmul_ref(x, w["q"], w["s"], nk)
    torch.cuda.synchronize()
    check(torch.isfinite(got.float()).all().item(), f"quant_gemm {what}: not finite")
    rec = {"layout": layout, "code": mode, "matrix": what, "K": K, "N": N, "M": M,
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "row_rel_err": row_errs(got, want)["rms"]}
    if M in QGEMM_FAULT_M:
        rec["planted_faults"] = qgemm_faults(x, w, nk, got, want)
    del got, want
    b_ms, b_by = bound(K * N + 4 * N + 2 * M * K + 2 * M * N, 2 * M * K * N)
    heavy = M * N >= 2048 * 32000  # the large heads at prefill: fewer calls
    it = dict(iters=5, replays=2) if heavy else {}

    def kern():
        return qg.quant_matmul(x, w["q"], w["s"], nk)

    def lib():
        return torch.matmul(x, w_bf16)

    rec.update({"ms": cuda_ms(kern, iters=5 if heavy else 20),
                "device_ms": graph_ms(kern, **it),
                "plain_ms": cuda_ms(lambda: qg.quant_matmul_ref(x, w["q"], w["s"], nk),
                                    iters=3, warmup=1),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": cuda_ms(lib, iters=5 if heavy else 20),
                "library_device_ms": graph_ms(lib, **it)})
    rec["device_ms_over_bound"] = rec["device_ms"] / b_ms
    rec["device_ms_over_library"] = rec["device_ms"] / rec["library_device_ms"]
    return rec


def quant_kernels_phase(dev):
    """The weight-only GEMM (ops/csrc/quant_gemm.cu) in both layouts, int8
    and e4m3 codes, at QGEMM_SHAPES x QGEMM_M, each against its plain
    version (KERNEL_TOL at x RMS MOE_X_RMS, ROW_REL_TOL row by row, the
    planted faults above it), then the grouped GEMM's quantized bodies
    (moe_quant_kernels). Returns the kernels line's records."""
    dgen = torch.Generator(device=dev).manual_seed(13)
    cases, entries = [], {}
    for layout, shapes in QGEMM_SHAPES.items():
        for what, (K, N) in shapes.items():
            for mode in QUANT_MODES:
                w = qgemm_weight(K, N, layout == "nk", mode, dgen, dev)
                w_bf16 = qgemm_dequantized(w, layout == "nk")
                for M in QGEMM_M:
                    rec = qgemm_case(layout, mode, what, K, N, M, w, w_bf16, dgen, dev)
                    emit({"phase": "quant_case", **rec})
                    cases.append(rec)
                    for name, (lo, co, mat, m, _) in QGEMM_ENTRIES.items():
                        if (lo, co, mat, m) == (layout, mode, what, M):
                            entries[name] = rec
                del w, w_bf16
                torch.cuda.empty_cache()
    edges = []
    for layout, shapes in QGEMM_EDGES.items():
        for K, N in shapes:
            for mode in QUANT_MODES:
                w = qgemm_weight(K, N, layout == "nk", mode, dgen, dev)
                for M in QGEMM_EDGE_M:
                    x = (torch.randn(M, K, generator=dgen, device=dev) * MOE_X_RMS
                         ).bfloat16()
                    got = qg.quant_matmul(x, w["q"], w["s"], layout == "nk")
                    want = qg.quant_matmul_ref(x, w["q"], w["s"], layout == "nk")
                    edges.append({"layout": layout, "code": mode, "matrix": "edge",
                                  "K": K, "N": N, "M": M,
                                  "max_abs_err": (got.float() - want.float()).abs()
                                  .max().item(), "row_rel_err": row_errs(got, want)["rms"]})
    ents = ptxas_entries(_build.build_log.get("quant_gemm", ""))
    emit({"phase": "quant_kernels", "tol": KERNEL_TOL, "row_tol": ROW_REL_TOL,
          "x_rms": MOE_X_RMS, "small_m": qg.QGEMM_SMALL_M, "ptxas": ents,
          "cases": len(cases), "edges": edges})
    for rec in cases + edges:  # the checks, after the records are out
        what = f"quant_gemm {rec['layout']} {rec['code']} {rec['matrix']} M {rec['M']}"
        check(rec["max_abs_err"] <= KERNEL_TOL,
              f"{what}: max abs err {rec['max_abs_err']} > {KERNEL_TOL}")
        check(rec["row_rel_err"] <= ROW_REL_TOL,
              f"{what}: row error {rec['row_rel_err']} > {ROW_REL_TOL}")
        for f, v in rec.get("planted_faults", {}).items():
            check(v > ROW_REL_TOL, f"{what}: the planted {f} reads {v}, under {ROW_REL_TOL}")
    lib = _build.load()["quant_gemm"]
    check(lib.quant_gemm_small_m() == qg.QGEMM_SMALL_M,
          f"quant_gemm's small tiles up to {lib.quant_gemm_small_m()} rows")
    out = {name: dict(rec, max_abs_err=max(c["max_abs_err"] for c in cases
                                           if c["layout"] == rec["layout"]
                                           and c["code"] == rec["code"]))
           for name, rec in entries.items()}
    out.update(moe_quant_kernels(dev))
    return out


# the quantized grouped GEMM's cases: qwen3-30b-a3b's experts (MOE_SHAPES)
# and mixtral-8x7b's (E 4096, F 14336, 8 experts, top 2) at a decode batch,
# the fused step and a chunk; the kernels line's case is mixtral's fused step
MOE_QUANT_SHAPES = {"qwen3-30b-a3b": ((2048, 768, 128, 8), (8, 264, 512)),
                    "mixtral-8x7b": ((4096, 14336, 8, 2), (8, 264, 512))}
MOE_QUANT_HEAD = ("mixtral-8x7b", 264, "uniform")


def moe_quant_case(what, x, sel, q, k):
    """Both grouped-GEMM entries on int8 experts q = (gate, up, down) against
    their plain versions (max abs error; row errors in row_errs' forms,
    gate/up on the max form and down on the RMS form, as moe_case; planted
    faults: the last live expert's scales dropped, the last tile's middle
    64-deep K stage skipped) and against the bf16 body on the dequantized
    experts (information), timed beside the plain version, the bf16 body
    on the dequantized experts and torch._grouped_mm on them, with the
    bound over the touched experts' codes and scales."""
    dev = x.device
    T, E = x.shape
    wg, wu, wd = q
    n, _, F_ = wg["q"].shape
    r = md.route(sel.to(dev), n)
    h = md.moe_gate_up(x, r.tok, wg, wu, r.tiles)
    y = md.moe_down(h, wd, r.tiles)
    deq = [dequantize_weight(w, torch.bfloat16) for w in q]
    h16 = md.moe_gate_up(x, r.tok, deq[0], deq[1], r.tiles)
    y16 = md.moe_down(h, deq[2], r.tiles)
    torch.cuda.synchronize()
    live = [t for t in r.tiles.tolist() if t[0] >= 0]
    counts = torch.bincount(sel.reshape(-1), minlength=n)
    touched = int((counts > 0).sum())
    P = T * k
    last_e, last0, last1 = live[-1]

    def no_scale(w, e):
        s = w["s"].clone()
        s[e] = 1.0
        return dict(w, s=s)

    out = {"routing": what, "T": T, "pairs": P, "touched_experts": touched,
           "tiles": len(live), "max_rows_an_expert": int(counts.max())}
    entries = {
        "moe_gate_up": (h, h16, lambda xx=x, e=None: md.moe_gate_up_ref(
            xx, r.tok, wg if e is None else no_scale(wg, e),
            wu if e is None else no_scale(wu, e), r.tiles), "max", E, x),
        "moe_down": (y, y16, lambda xx=h, e=None: md.moe_down_ref(
            xx, wd if e is None else no_scale(wd, e), r.tiles), "rms", F_, h),
    }
    for name, (got, body16, plain, gate, K, a) in entries.items():
        want = plain()
        check(torch.isfinite(got.float()).all().item(), f"{name} {what}: not finite")
        k_mid = K // md.MOE_BK // 2 * md.MOE_BK
        if name == "moe_gate_up":  # the last tile's rows, from their tokens
            rows = r.tok[last0:last1].long()
            faulty = want.clone()
            xs = a[rows].clone()
            xs[:, k_mid:k_mid + md.MOE_BK] = 0
            hs = md.moe_gate_up_ref(xs, torch.arange(len(rows), device=dev,
                                                     dtype=torch.int32),
                                    wg, wu, torch.tensor([[last_e, 0, len(rows)]],
                                                         dtype=torch.int32, device=dev))
            faulty[last0:last1] = hs
        else:
            skipped = a.clone()
            skipped[last0:last1, k_mid:k_mid + md.MOE_BK] = 0
            faulty = plain(xx=skipped)
        faults = {"scale_dropped": plain(e=last_e), "skipped_stage": faulty}
        out[name] = {
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "row_rel_err_rms": row_errs(got, want)["rms"],
            "row_rel_err_max": row_errs(got, want)["max"], "row_gate": gate,
            "vs_bf16_body_on_dequantized": row_errs(got, body16),
            "planted_faults": {f: row_errs(got, v, want)[gate] for f, v in faults.items()}}
    code_bytes = touched * E * F_ + touched * F_ * 4
    maps = P * 4 + r.tiles.numel() * 4
    bounds = {"moe_gate_up": bound(2 * code_bytes + T * E * 2 + P * F_ * 2 + maps,
                                   2 * P * E * F_ * 2),
              "moe_down": bound(touched * F_ * E + touched * E * 4 + P * F_ * 2
                                + P * E * 2 + r.tiles.numel() * 4, 2 * P * F_ * E)}
    offs = torch.cumsum(counts, 0).to(torch.int32).to(dev)
    calls = {
        "moe_gate_up": (lambda: md.moe_gate_up(x, r.tok, wg, wu, r.tiles),
                        lambda: md.moe_gate_up_ref(x, r.tok, wg, wu, r.tiles),
                        lambda: md.moe_gate_up(x, r.tok, deq[0], deq[1], r.tiles), None),
        "moe_down": (lambda: md.moe_down(h, wd, r.tiles),
                     lambda: md.moe_down_ref(h, wd, r.tiles),
                     lambda: md.moe_down(h, deq[2], r.tiles),
                     lambda: torch._grouped_mm(h, deq[2], offs=offs)),
    }
    for name, (kern, plain, body16, grouped) in calls.items():
        bms, by = bounds[name]
        rec = out[name]
        rec.update({"ms": cuda_ms(kern), "device_ms": graph_ms(kern),
                    "plain_ms": cuda_ms(plain, iters=3, warmup=1),
                    "bound_ms": bms, "bound_by": by,
                    "bf16_body_on_dequantized_device_ms": graph_ms(body16),
                    "library_ms": None})
        if grouped is not None:
            try:
                rec["library_ms"] = cuda_ms(grouped)
                rec["grouped_mm_device_ms"] = graph_ms(grouped)
            except (AttributeError, RuntimeError) as e:  # a yardstick only
                rec["grouped_mm_error"] = str(e)[:200]
        rec["device_ms_over_bound"] = rec["device_ms"] / bms
    del deq
    emit({"phase": "moe_quant_case", **out})
    for name in MOE_KERNELS:
        rec = out[name]
        err, gate = rec["max_abs_err"], rec["row_gate"]
        rel = rec[f"row_rel_err_{gate}"]
        check(err <= KERNEL_TOL, f"{name} int8 {what}: max abs err {err} > {KERNEL_TOL}")
        check(rel <= ROW_REL_TOL,
              f"{name} int8 {what}: row error {rel} ({gate} form) > {ROW_REL_TOL}")
        for f, v in rec["planted_faults"].items():
            check(v > ROW_REL_TOL, f"{name} int8 {what}: the planted {f} reads {v}, "
                  f"under {ROW_REL_TOL}")
    return out


def moe_quant_kernels(dev):
    """The grouped GEMM's int8 bodies at MOE_QUANT_SHAPES under both
    routings of MOE_ROUTINGS, x at RMS MOE_X_RMS, and one e4m3 case (the
    head's shape). Returns the kernels line's records for the int8
    entries."""
    gen = torch.Generator(device="cpu").manual_seed(17)
    dgen = torch.Generator(device=dev).manual_seed(17)
    head = {}
    for model, ((E, F_, n, k), Ts) in MOE_QUANT_SHAPES.items():
        def w(mode, *shape):
            return quantize_weight(torch.randn(shape, generator=dgen, device=dev,
                                               dtype=torch.bfloat16)
                                   .mul_(shape[-2] ** -0.5), mode)
        q8 = (w("int8", n, E, F_), w("int8", n, E, F_), w("int8", n, F_, E))
        for T in Ts:
            x = (torch.randn(T, E, generator=dgen, device=dev) * MOE_X_RMS).bfloat16()
            for how in MOE_ROUTINGS:
                sel = moe_routing(gen, T, k, n, how)
                rec = moe_quant_case(f"{model} T {T} {how}", x, sel, q8, k)
                if (model, T, how) == MOE_QUANT_HEAD:
                    head = rec
                    q_fp8 = (w("fp8", n, E, F_), w("fp8", n, E, F_), w("fp8", n, F_, E))
                    moe_quant_case(f"{model} T {T} {how} fp8", x, sel, q_fp8, k)
                    del q_fp8
        del q8
        gc.collect()
        torch.cuda.empty_cache()
    ents = ptxas_entries(_build.build_log.get("moe_grouped_gemm", ""))
    emit({"phase": "moe_quant_kernels",
          "ptxas": {k: v for k, v in ents.items() if not k.endswith(",0>")}})
    out = {}
    for name in MOE_KERNELS:
        rec = dict(head[name])
        rec["case"] = dict(zip(("model", "T", "routing"), MOE_QUANT_HEAD))
        out[f"{name}_int8"] = rec
    return out


# llama-3.1-8b at full width, 8 layers, int8 weights over int8 pools (the
# 3B's traffic); llama-3.2-3b with e4m3 weights (its tied head on the NK
# layout), 8 layers; mixtral-8x7b at full width, 8 layers, with int8 weights
QUANT_8B_ARGS = ENGINE_8B_ARGS + ["--quantize", "int8"]
QUANT_3B_FP8_ARGS = ENGINE_ARGS + ["--quantize", "fp8"]
MIXTRAL_ARGS = model_args("mixtral-8x7b") + ["--quantize", "int8"]
# the decode step timed beside engine_int8kv's: 8 rows at 1024 tokens
DECODE_STEP_ROWS, DECODE_STEP_CONTEXT = 8, 1024
DECODE_STEP_MS = {}


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def decode_step_ms(runner, adapters=None):
    """One warm decode forward pass of DECODE_STEP_ROWS rows at
    DECODE_STEP_CONTEXT tokens of context, on the runner's pools (after its
    engine turns), as CUDA-graph replays: the device time of a step, the
    host's launch cost left out; back to back (host included); and the
    host's time to launch one step onto an idle device (`host_ms`).
    `adapters`: the rows' LoRA slots on a LoRA runner."""
    from dynamo_tpu_torch.models import llama

    cfg, dev = runner.config, runner.device
    B, ctx = DECODE_STEP_ROWS, DECODE_STEP_CONTEXT
    per = ctx // runner.page_size + 1
    pt = torch.arange(B * per, dtype=torch.int32, device=dev).view(B, per)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), device=dev, dtype=torch.int32)
    pos = torch.full((B, 1), ctx, dtype=torch.int32, device=dev)
    kvl = torch.full((B,), ctx + 1, dtype=torch.int32, device=dev)
    kw = {}
    if adapters is not None:
        kw = {"lora": runner.lora,
              "adapter_idx": torch.tensor(adapters, dtype=torch.int32, device=dev)}

    def step():
        return llama.forward(cfg, runner.params, tok, pos, runner.k_pool, runner.v_pool,
                             pt, kvl, 0, **kw)

    out = {"b2b_ms": cuda_ms(step, iters=10), "host_ms": host_ms(step, iters=10),
           "rows": B, "context": ctx}
    try:
        out["device_ms"] = graph_ms(step, iters=5, replays=3)
    except RuntimeError as e:  # a step that does not capture: b2b only
        out["device_ms"], out["graph_error"] = None, str(e)[:200]
    return out


def quant_phases(dev, smi):
    """`engine_quant` (fused) on llama-3.1-8b with int8 weights and int8
    pools: every request `length`, quant_gemm launches = passes x (7 L +
    1) on its KN int8 body, the attention kernels' on D128_int8; the
    params' GB and a decode step's device time beside engine_int8kv's
    (bf16 weights); then `parity_quant` (the kernel path against the plain
    path on the same quantized params). Then `engine_quant_fp8_3b`:
    llama-3.2-3b with e4m3 weights, one fused turn, the tied head on the
    NK body. Returns the kernels line's launches of QGEMM_ENTRIES."""
    from dynamo_tpu_torch.models import llama

    found = {}
    runner, cfg, build_s = timed_runner(QUANT_8B_ARGS, cut=True)
    L = cfg.n_layers
    check(runner.quantize == "int8" and runner.params["layers"]["wq"]["q"].dtype
          == torch.int8, "engine_quant: the runner's weights are not int8")
    rec, launches = served_turn(runner, "quant", None, QUANT_8B_ARGS,
                                one_body(f"D{cfg.head_dim}_int8"), build_s=build_s)
    passes = (launches["quant_gemm"] // (7 * L + 1))
    check(launches["quant_gemm"] == passes * (7 * L + 1) > 0,
          f"engine_quant: quant_gemm launches {launches['quant_gemm']}")
    rec["params_gb"] = tree_bytes(runner.params) / 1e9
    rec["params_gb_if_bf16"] = llama.param_bytes(cfg) / 1e9
    DECODE_STEP_MS["quant"] = decode_step_ms(runner)
    rec["decode_step"] = DECODE_STEP_MS["quant"]
    rec["decode_step_bf16_weights"] = DECODE_STEP_MS.get("int8kv")
    rec["config"] = {k: getattr(cfg, k) for k in CONFIG_FIELDS}
    rec["nvidia_smi"] = smi
    emit(rec)
    found["quant"] = rec["quant_gemm_bodies"]
    parity_phase(runner, dev, phase="parity_quant")
    free(runner)
    runner, cfg, build_s = timed_runner(QUANT_3B_FP8_ARGS, cut=True)
    check(cfg.tie_embeddings and runner.params["embed"]["q"].dtype == torch.float8_e4m3fn,
          "engine_quant_fp8_3b: not a tied e4m3 table")
    rec, launches = served_turn(runner, "quant_fp8_3b", None, QUANT_3B_FP8_ARGS,
                                one_body(f"D{cfg.head_dim}"), build_s=build_s)
    check(rec["quant_gemm_bodies"].get("nk_fp8", 0) > 0,
          f"engine_quant_fp8_3b: the NK body never ran: {rec['quant_gemm_bodies']}")
    rec["params_gb"] = tree_bytes(runner.params) / 1e9
    rec["nvidia_smi"] = smi
    emit(rec)
    found["quant_fp8_3b"] = rec["quant_gemm_bodies"]
    parity_phase(runner, dev, phase="parity_quant_fp8_3b", lens=(300, 90, 40))
    free(runner)
    return {name: found[phase].get(f"{lo}_{code}", 0)
            for name, (lo, code, _, _, phase) in QGEMM_ENTRIES.items()}


def mixtral_phases(dev, smi):
    """`engine_mixtral`: mixtral-8x7b at full width, 8 of its 32 MoE
    layers (8 experts, top 2), with int8 weights, 2048 pages, the 3B's
    traffic: check_fits passes, the params' GB at 8 layers beside the full
    depth's computed bytes (its build and fit check no longer run) and the
    card's free memory after the build, every request `length`, each
    grouped-GEMM entry's launches = passes x 8 all on its int8 body,
    quant_gemm's = passes x
    (4 L + 1). Then, with it freed, the MoE parity at two layers
    (`parity_mixtral_free`, `parity_mixtral` pinned to the kernel path's
    routing, `repeat_mixtral`). Returns the fused launches."""
    from dynamo_tpu_torch.models import llama

    cfg0 = get_config("mixtral-8x7b")
    free_before = torch.cuda.mem_get_info()[0]
    runner, cfg, build_s = timed_runner(MIXTRAL_ARGS, cut=True)
    L = cfg.n_layers
    check(L == DEPTH_CUTS["mixtral-8x7b"] and runner.moe_layers == L
          and runner.quantize == "int8",
          f"engine_mixtral: {L} layers, {runner.moe_layers} MoE, {runner.quantize}")
    bodies, launches = family_turn(runner, "mixtral", None, MIXTRAL_ARGS, "D128", smi,
                                   build_s=build_s)
    passes = launches["moe_gate_up"] // L
    check(launches["quant_gemm"] == passes * (4 * L + 1) and passes > 0,
          f"engine_mixtral: quant_gemm launches {launches['quant_gemm']}, {passes} passes")
    check(md.moe_gate_up.bodies == {"int8": passes * L} == md.moe_down.bodies,
          f"engine_mixtral: grouped GEMM bodies {md.moe_gate_up.bodies}, "
          f"{md.moe_down.bodies}")
    emit({"phase": "mixtral_memory", "n_layers": L,
          "params_gb": tree_bytes(runner.params) / 1e9,
          "param_bytes_gb": llama.param_bytes(cfg, quantize="int8") / 1e9,
          "params_gb_if_bf16": llama.param_bytes(cfg) / 1e9,
          "full_depth_layers": cfg0.n_layers,
          "full_depth_param_bytes_gb_computed":
              llama.param_bytes(cfg0, quantize="int8") / 1e9,
          "free_gb_before": free_before / 1e9,
          "free_gb_after_build": torch.cuda.mem_get_info()[0] / 1e9,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
          "nvidia_smi": smi})
    free(runner)
    del runner
    small = ModelRunner(cfg0.with_(n_layers=2), num_pages=2048, page_size=PAGE_SIZE,
                        max_pages_per_seq=4096 // PAGE_SIZE, quantize="int8")
    moe_parity(small, dev, "parity_mixtral")
    free(small)
    return launches


# -- observability: the runtime hooks on the card ---------------------------
# each entry: a planted operation on a CUDA tensor, and whether the sync
# debug mode "error" must catch it (True) or lets it through (False), as a
# run on an H100 found (PERF.md §6): the list the sanitizer's docstring
# names
SYNC_CASES = {
    "item": (lambda x, pin: x[0].item(), True),
    "cpu": (lambda x, pin: x.cpu(), True),
    "tolist": (lambda x, pin: x.tolist(), True),
    "int": (lambda x, pin: int(x[1]), True),
    "bool": (lambda x, pin: bool(x[1] > 0), True),
    "nonzero": (lambda x, pin: torch.nonzero(x), True),
    "masked_select": (lambda x, pin: x[x > 3], True),
    "index_put_accumulate": (lambda x, pin: torch.zeros_like(x).index_put_(
        (torch.arange(2, device=x.device),), x[:2], accumulate=True), False),
    "h2d_pageable": (lambda x, pin: pin.clone().to(x.device), True),
    "h2d_pinned_blocking": (lambda x, pin: pin.to(x.device), True),
    "torch_tensor_on_device": (lambda x, pin: torch.tensor([1, 2], device=x.device), True),
    "stream_synchronize": (lambda x, pin: torch.cuda.current_stream().synchronize(), True),
    "h2d_pinned_non_blocking": (lambda x, pin: pin.to(x.device, non_blocking=True), False),
    "d2h_pinned_non_blocking": (lambda x, pin: torch.empty(
        x.shape, pin_memory=True).copy_(x, non_blocking=True), False),
    "torch_cuda_synchronize": (lambda x, pin: torch.cuda.synchronize(), False),
    "event_synchronize": (lambda x, pin: torch.cuda.Event().synchronize(), False),
    "topk": (lambda x, pin: torch.topk(x, 3), False),
    "generator_seed": (lambda x, pin: torch.Generator(device=x.device).manual_seed(3),
                       False),
}
ANOMALY_K = 8.0  # the stall phase's trigger: well above the decode's spread
HW_DECODE_STEPS = 4  # the hardware sweep's decode steps a timed call
ANOMALY_PROFILE_MS = 300
OBS_COST_TURNS = (0, 1)  # off, on: one pair a hook (the script's time)
HOOK_CALLS = 5000  # hook_call_costs: calls a hook
# a hook's host work, as a share of the iterations it runs in: below
# every hook's run-to-run spread of the decode rate that the cost pairs
# have shown on an H100 (the larger side's, 2.9-32.3% of the rate,
# PERF.md §6)
HOOK_SHARE_MAX = 0.01
# a cost turn's batch: decode-bound, so the rate a request is the decode
# loop's (the prefills batched at the start)
COST_REQUESTS, COST_PROMPT, COST_OUT = 8, 64, 32


def sync_mode_phase(dev):
    """What set_sync_debug_mode("error") catches: each SYNC_CASES entry
    inside a warm guard, caught (raised and recorded) or not, held to
    the table."""
    from dynamo_tpu_torch.runtime.sanitizer import Sanitizer

    san = Sanitizer(strict=False, warmup_steps=0)
    san.mark_warm()
    x = torch.arange(16, device=dev, dtype=torch.float32)
    pin = torch.ones(16, pin_memory=True)
    got = {}
    try:
        for name, (fn, _) in SYNC_CASES.items():
            n = len(san.violations)
            try:
                with san.transfer_scope(name):
                    fn(x, pin)
                got[name] = False
            except RuntimeError:
                got[name] = len(san.violations) == n + 1
            torch.cuda.synchronize()
    finally:
        san.disarm()
    want = {name: caught for name, (_, caught) in SYNC_CASES.items()}
    check(got == want, f"sync mode: caught {got}, expected {want}")
    return got


def _one(engine, prompt, max_tokens=8, **sampling):
    """One request: (tokens, finish reason, error text)."""
    async def run():
        toks, finish, err = [], None, None
        req = {"token_ids": prompt, "sampling": {"temperature": 0.0, **sampling},
               "stop": {"max_tokens": max_tokens, "stop_ids": []}}
        async for item in engine.generate(req, Context()):
            toks.extend(item["token_ids"])
            if item.get("finish_reason"):
                finish, err = item["finish_reason"], item.get("error")
        return toks, finish, err
    return asyncio.run(asyncio.wait_for(run(), 120))


def _planted(runner, name, fn):
    """runner.<name> with fn(runner) run inside it, before the call."""
    orig = getattr(runner, name)

    def wrapped(*a, **kw):
        fn(runner)
        return orig(*a, **kw)

    setattr(runner, name, wrapped)
    return lambda: setattr(runner, name, orig)


def guard_beside_tiers(runner, engine, san):
    """Guarded decodes beside another engine's device work in one process:
    a TIER_ARGS engine (a second runner on the same params, a 512-block
    host tier, no sanitizer) serves A and the two fillers (its G2
    offloads) and A2 (a G2 onboard) while `engine`, warm under `san`,
    runs rounds of four greedy decodes until the tier side is done. The
    device gate keeps the tier engine's iterations out of the guarded
    windows: no new violation, more guarded dispatches, and every
    request of both engines finishes `length`."""
    r2, _ = build_runner(parse_args(TIER_ARGS), params=runner.params)
    tier = build_engine(parse_args(TIER_ARGS + TIER_HOST), runner=r2)
    labels = _onboard_labels(tier)
    a, fillers, a2, _ = _tier_prompts(runner.config.vocab_size)
    V = runner.config.vocab_size
    gen = torch.Generator(device="cpu").manual_seed(53)
    n0, g0 = len(san.violations), san.counters["guarded_dispatches"]

    async def collect(eng, prompt, rid):
        finish = None
        req = {"token_ids": prompt, "sampling": {"temperature": 0.0},
               "stop": {"max_tokens": N_OUT, "stop_ids": []}}
        async for item in eng.generate(req, Context(request_id=rid)):
            finish = item.get("finish_reason") or finish
        return finish

    async def run():
        done = asyncio.Event()

        async def tiers():
            try:
                return [await collect(tier, p, f"beside_tier{i}")
                        for i, p in enumerate([a, *fillers, a2])]
            finally:
                done.set()

        async def decodes():
            out, n = [], 0
            while not done.is_set():
                out += await asyncio.gather(*[
                    collect(engine, torch.randint(0, V, (64,), generator=gen).tolist(),
                            f"beside_decode{n}_{i}") for i in range(4)])
                n += 1
            return out

        return await asyncio.gather(tiers(), decodes())

    try:
        t0 = time.monotonic()
        tier_fin, decode_fin = _run(run())
        seconds = time.monotonic() - t0
        exported = r2.stats["kv_pages_exported"]
    finally:
        tier.stop()
        free(r2)
    guarded = san.counters["guarded_dispatches"] - g0
    check(san.violations[n0:] == [] and guarded > 0 and "G2" in labels and exported > 0
          and set(tier_fin) == {"length"} and set(decode_fin) == {"length"},
          f"guard beside tiers: violations {san.violations[n0:]}, guarded {guarded}, "
          f"onboards {labels}, offloaded pages {exported}, tier {tier_fin}, "
          f"decodes {decode_fin}")
    return {"guarded_dispatches": guarded, "decode_requests": len(decode_fin),
            "tier_requests": len(tier_fin), "onboards": labels,
            "offloaded_pages": exported, "seconds": seconds}


def guard_phase(runner, dev):
    """The sync guard in a warm 3B engine (a non-strict sanitizer, so a
    violation is recorded and its step fails alone): the workload's
    guarded decodes with no violation; guarded decodes beside a second
    engine's G2 offloads and onboard with none (guard_beside_tiers); a
    `.item()` planted inside the
    guarded decode fails its request and is recorded against the decode;
    the same sync in an allow_transfer("token_readback") scope passes; an
    unknown label is a violation (strict: raised); a request with a
    frequency penalty (count tables inside the decode) is reported as it
    comes; and a kernel library that nvcc builds after warm-up is a
    violation."""
    from dynamo_tpu_torch.runtime.sanitizer import Sanitizer, SanitizerViolation

    V = runner.config.vocab_size
    gen = torch.Generator(device="cpu").manual_seed(41)
    prompt = lambda n: torch.randint(0, V, (n,), generator=gen).tolist()  # noqa: E731
    san = Sanitizer(strict=False, warmup_steps=4)
    engine = build_engine(parse_args(ENGINE_ARGS), runner=runner, sanitizer=san)
    rec = {}
    try:
        serve(engine, seed=1)
        rep = san.report()
        check(rep["ok"] and rep["warm"] and rep["counters"]["guarded_dispatches"] > 0,
              f"guard: the workload under the guard: {rep}")
        rec["workload"] = rep["counters"]
        rec["beside_tiers"] = guard_beside_tiers(runner, engine, san)
        zero = lambda r: torch.zeros(1, device=dev).sum().item()  # noqa: E731
        undo = _planted(runner, "decode_multi_ex", zero)
        try:
            toks, finish, _ = _one(engine, prompt(40))
        finally:
            undo()
        v = san.violations
        check(finish == "error" and len(v) == 1 and v[0]["kind"] == "transfer"
              and "decode" in v[0]["message"],
              f"guard: the planted .item() finished {finish!r}, violations {v}")
        rec["planted_item"] = v[0]["message"][:160]

        def allowed(r):
            with r._allow("token_readback"):
                zero(r)

        undo = _planted(runner, "decode_multi_ex", allowed)
        try:
            toks, finish, _ = _one(engine, prompt(40))
        finally:
            undo()
        check(finish == "length" and len(toks) == 8 and len(san.violations) == 1,
              f"guard: an allowed sync finished {finish!r}: {san.violations}")
        with san.allow_transfer("not_a_label"):
            pass
        check(san.violations[-1]["kind"] == "allowlist",
              f"guard: an unknown label: {san.violations[-1]}")
        try:
            with Sanitizer(strict=True).allow_transfer("not_a_label"):
                pass
            check(False, "guard: a strict unknown label did not raise")
        except SanitizerViolation:
            pass
        # the penalties' count tables inside the decode: reported as they
        # come (a sync here would be a finding for ROADMAP A.2)
        n = len(san.violations)
        toks, finish, err = _one(engine, prompt(40), frequency_penalty=0.5)
        rec["finding_penalty_decode"] = {
            "finish": finish, "violations": [x["message"][:200] for x in san.violations[n:]]}
        # a kernel library rebuilt after warm-up (block_copy: the smallest)
        n = len(san.violations)
        lib = _build.library_path("block_copy")
        moved = lib.with_name(lib.name + ".aside")
        os.replace(lib, moved)
        _build._libs.pop("block_copy")
        try:
            t0 = time.monotonic()
            _build.load()
            rec["rebuild_s"] = time.monotonic() - t0
            san.note_step(runner)
        finally:
            moved.unlink(missing_ok=True)
        check([x["kind"] for x in san.violations[n:]] == ["kernel_build"],
              f"guard: the rebuild after warm-up: {san.violations[n:]}")
    finally:
        engine.stop()
        runner.attach_sanitizer(None)
    rec["violations"] = [x["kind"] for x in san.violations]
    return rec


def anomaly_phase(runner, smi):
    """A planted stall: one decode iteration held twice the trigger's
    threshold (at least 1 s) inside a warm 3B engine (recorder anomaly_k
    ANOMALY_K, 16 samples a kind before it arms) fires exactly one
    anomaly; its dump lands, and its profile
    window (ANOMALY_PROFILE_MS, torch.profiler opened by the step thread)
    writes a Chrome trace holding the engine's ranges and the GQA
    kernels' names."""
    root = tempfile.mkdtemp(prefix="chip_smoke_anomaly_")
    args = ENGINE_ARGS + ["--anomaly-k", str(ANOMALY_K), "--anomaly-dump-dir", root,
                          "--anomaly-profile-ms", str(ANOMALY_PROFILE_MS)]
    engine = build_engine(parse_args(args), runner=runner)
    fr = engine.recorder
    fr.anomaly_min_samples = 16
    V = runner.config.vocab_size
    gen = torch.Generator(device="cpu").manual_seed(43)
    try:
        for _ in range(2):  # 32 decode iterations: the decode EWMA, armed
            _one(engine, torch.randint(0, V, (64,), generator=gen).tolist(), 64)
        # the stall: twice the trigger's threshold over the decode EWMA
        # the warm-up left (at least 1 s)
        stall_s = max(1.0, 2 * ANOMALY_K * fr.stats()["ewma_s"]["decode"])
        stalled = [False]

        def stall(r):
            if not stalled[0]:
                stalled[0] = True
                time.sleep(stall_s)

        undo = _planted(runner, "decode_multi_ex", stall)
        try:
            _one(engine, torch.randint(0, V, (64,), generator=gen).tolist(), 64)
        finally:
            undo()
        # the dump thread asks the step thread for the window: keep the
        # engine stepping until it is written
        t0 = time.monotonic()
        while fr.profiles_written < 1 and time.monotonic() - t0 < 60:
            _one(engine, [1] * 64, max_tokens=32)
    finally:
        engine.stop()
    trig = [r for r in fr.snapshot() if r.anomaly]
    dumps = [f for f in os.listdir(root) if f.endswith(".json")]
    check(fr.anomalies_fired == 1 and len(trig) == 1 and trig[0].wall_s >= stall_s
          and dumps == [f"flight_dump_{trig[0].seq:08d}.json"],
          f"anomaly: fired {fr.anomalies_fired}, triggers {trig}, dumps {dumps}, "
          f"stall {stall_s} s, {fr.stats()}")
    check(fr.profiles_written == 1, f"anomaly: {fr.stats()}")
    events = json.load(open(fr.last_profile))["traceEvents"]
    names = {e.get("name") for e in events}
    ranges = sorted(n for n in names if n and n.startswith("engine."))
    kernels = sorted({m.group(1) for n in names
                      if n and (m := re.search(r"(\w+_kernel)\s*<", n))})
    check(ranges and any("decode" in k or "ragged" in k for k in kernels),
          f"anomaly: the profile window holds ranges {ranges}, kernels {kernels}")
    rec = {"stall_s": stall_s, "trigger_kind": trig[0].kind, "trigger_wall_s": trig[0].wall_s,
           "ewma_s": fr.stats()["ewma_s"], "profile": fr.last_profile,
           "profile_ranges": ranges, "profile_kernels": kernels,
           "profile_events": len(events)}
    shutil.rmtree(root, ignore_errors=True)
    return rec


def _traced(engine):
    """probe: every request carries a traceparent, so the engine rebuilds
    its spans and the iteration records its trace ids."""
    import secrets

    gen = engine.generate

    async def generate(req, ctx):
        ctx.metadata.setdefault(
            "traceparent", f"00-{secrets.token_hex(16)}-{secrets.token_hex(8)}-01")
        async for item in gen(req, ctx):
            yield item

    engine.generate = generate


def _decode_turn(engine, phase):
    """COST_REQUESTS concurrent greedy requests of COST_PROMPT prompt and
    COST_OUT output tokens through `engine` (their prefill batched, then
    decode rows alone), with every launch count and runner.stats set to 0
    just before and the launch identities held just after. Returns the
    median decode rate a request, (output tokens - 1) / (e2e - TTFT)."""
    runner = engine.runner
    V = runner.config.vocab_size
    gen = torch.Generator(device="cpu").manual_seed(47)
    prompts = [torch.randint(0, V, (COST_PROMPT,), generator=gen).tolist()
               for _ in range(COST_REQUESTS)]

    async def one(i, p):
        toks, phases = [], {}
        req = {"token_ids": p, "sampling": {"temperature": 0.0},
               "stop": {"max_tokens": COST_OUT, "stop_ids": []}}
        async for item in engine.generate(req, Context(request_id=f"{phase}{i}")):
            toks.extend(item["token_ids"])
            if item.get("finish_reason"):
                check(item["finish_reason"] == "length",
                      f"{phase}: r{i} finished {item['finish_reason']!r}")
                phases = item["phases"]
        return (len(toks) - 1) / (phases["e2e_s"] - phases["ttft_s"])

    async def run():
        return await asyncio.gather(*[one(i, p) for i, p in enumerate(prompts)])

    torch.cuda.synchronize()
    reset_launches()
    runner.reset_stats()
    try:
        rates = asyncio.run(asyncio.wait_for(run(), 300))
    finally:
        engine.stop()
    torch.cuda.synchronize()
    check_launches(phase, {name: fn.launches for name, fn in KERNELS.items()},
                   dict(runner.stats), runner.config.n_layers)
    return statistics.median(rates)


class _TimedScope:
    """A context manager whose enter and exit (not its body) add their
    seconds to `acc` = [seconds, calls]."""

    __slots__ = ("cm", "acc")

    def __init__(self, cm, acc):
        self.cm, self.acc = cm, acc

    def __enter__(self):
        t0 = time.perf_counter()
        out = self.cm.__enter__()
        self.acc[0] += time.perf_counter() - t0
        self.acc[1] += 1
        return out

    def __exit__(self, *exc):
        t0 = time.perf_counter()
        out = self.cm.__exit__(*exc)
        self.acc[0] += time.perf_counter() - t0
        return out


def _timed_scopes(factory, acc):
    return lambda *a, **kw: _TimedScope(factory(*a, **kw), acc)


def _timed_calls(fn, acc):
    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            acc[0] += time.perf_counter() - t0
            acc[1] += 1
    return timed


def _hook_timers(engine, hook):
    """Time `hook`'s host work in `engine` where it runs (step thread):
    the recorder's _record_iteration; the worker spans' emission; the
    annotate ranges' enter and exit; the sanitizer's guard scopes, allow
    scopes, note_step and the device gate's enter and exit. Also times
    each iteration (_step_once calls that dispatched). Returns
    ({part: [seconds, calls]}, the step accumulator, undo)."""
    from dynamo_tpu_torch.engine import engine as engine_mod

    parts, undo = {}, []

    def patch(obj, name, wrap, part):
        acc = parts.setdefault(part, [0.0, 0])
        orig = getattr(obj, name)
        setattr(obj, name, wrap(orig, acc))
        undo.append(lambda: setattr(obj, name, orig))

    if hook == "recorder":
        patch(engine, "_record_iteration", _timed_calls, "record_iteration")
    elif hook == "tracing":
        patch(engine, "_emit_worker_spans", _timed_calls, "emit_worker_spans")
    elif hook == "annotate":
        patch(engine_mod, "annotate", _timed_scopes, "annotate")
    elif hook == "sanitizer":
        san = engine.sanitizer
        patch(san, "transfer_scope", _timed_scopes, "transfer_scope")
        patch(san, "allow_transfer", _timed_scopes, "allow_transfer")
        patch(san, "note_step", _timed_calls, "note_step")
        patch(engine_mod, "device_gate", _timed_scopes, "device_gate")
    steps = [0.0, 0]
    orig_step = engine._step_once

    def step():
        t0 = time.perf_counter()
        idle = orig_step()
        if not idle:
            steps[0] += time.perf_counter() - t0
            steps[1] += 1
        return idle

    engine._step_once = step
    undo.append(lambda: setattr(engine, "_step_once", orig_step))
    return parts, steps, lambda: [u() for u in reversed(undo)]


def _per_call_us(fn, n=HOOK_CALLS):
    """fn() run n times: microseconds a call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def hook_call_costs():
    """Each hook's host work alone, HOOK_CALLS times on this thread (no
    engine): a recorder append of one IterationRecord, one span into a
    4096-span ring, an annotate range entered and left (ranges on), and
    a warm sanitizer's guard scope with one allow scope inside, entered
    through the armed device gate. Microseconds a call."""
    from dynamo_tpu_torch.runtime import annotations as ann
    from dynamo_tpu_torch.runtime import tracing
    from dynamo_tpu_torch.runtime.flight_recorder import FlightRecorder, IterationRecord
    from dynamo_tpu_torch.runtime.sanitizer import Sanitizer, device_gate

    fr = FlightRecorder(capacity=4096)
    n = [0]

    def record():
        n[0] += 1
        fr.append(IterationRecord(
            seq=n[0], ts=time.time(), wall_s=0.03, kind="decode", decode_seqs=8,
            decode_steps=4, n_chunks=0, chunk_tokens=0, charged_tokens=0, ragged=False,
            fused=True, n_waiting=0, n_running=8, kv_usage=0.1, g2_blocks=0, g3_blocks=0,
            prefetch_hits=0, compile_variants=3, compile_calls=n[0]))

    tracing.set_exporter(SpanRing(4096))
    try:
        tp = f"00-{'1' * 32}-{'2' * 16}-01"
        span = _per_call_us(lambda: tracing.record_span(
            "worker.stream", 0, 1000, parent=tp, attributes={"request.id": "r"}))
    finally:
        tracing.set_exporter(None)
    os.environ["DYN_ENABLE_JAX_TRACE"] = "1"
    ann._enabled.cache_clear()
    try:
        def rng():
            with ann.annotate("engine.decode"):
                pass
        annotate_us = _per_call_us(rng)
    finally:
        os.environ.pop("DYN_ENABLE_JAX_TRACE", None)
        ann._enabled.cache_clear()
    san = Sanitizer(warmup_steps=0)
    san.mark_warm()
    try:
        def guard():
            with device_gate():
                with san.transfer_scope("decode"):
                    with san.allow_transfer("token_readback"):
                        pass
        guard_us = _per_call_us(guard)
    finally:
        san.disarm()
    return {"calls": HOOK_CALLS, "recorder_append_us": _per_call_us(record),
            "span_us": span, "annotate_us": annotate_us, "guard_scope_us": guard_us}


def cost_pairs_phase(runner, smi):
    """Each hook's cost to the decode rate a request, off and on in turns
    OBS_COST_TURNS (off, on) over _decode_turn's batch
    (its launch identities held in every turn): the recorder (size 0
    against 4096), the span ring (off against DYN_TRACE_RING's ring,
    every request traced), the profiler ranges (DYN_ENABLE_JAX_TRACE off
    against on) and the sanitizer (off against armed). Prints each side's
    decode rates, their median and their spread (max - min). The "on"
    turns also time the hook's own host work where it runs
    (_hook_timers): microseconds an iteration beside the iteration's own
    milliseconds, a cost that host drift between turns does not blur;
    hook_call_costs times each hook alone over HOOK_CALLS calls."""
    from dynamo_tpu_torch.runtime import annotations as ann
    from dynamo_tpu_torch.runtime import tracing
    from dynamo_tpu_torch.runtime.sanitizer import Sanitizer

    def turn(hook, on):
        kw = {}
        if hook == "recorder":
            kw["recorder_size"] = 4096 if on else 0
        elif hook == "tracing":
            tracing.set_exporter(tracing.SpanRing(4096) if on else None)
        elif hook == "annotate":
            os.environ["DYN_ENABLE_JAX_TRACE"] = "1" if on else "0"
            ann._enabled.cache_clear()
        elif hook == "sanitizer":
            kw["sanitizer"] = Sanitizer(warmup_steps=4) if on else None
        try:
            engine = build_engine(parse_args(ENGINE_ARGS), runner=runner, **kw)
            if hook == "tracing":
                _traced(engine)
            parts, steps, undo = _hook_timers(engine, hook if on else None)
            try:
                rate = _decode_turn(engine, f"cost_{hook}_{'on' if on else 'off'}")
            finally:
                undo()
            return rate, parts, steps
        finally:
            tracing.set_exporter(None)
            os.environ.pop("DYN_ENABLE_JAX_TRACE", None)
            ann._enabled.cache_clear()
            runner.attach_sanitizer(None)

    out = {}
    for hook in ("recorder", "tracing", "annotate", "sanitizer"):
        rates = {0: [], 1: []}
        hook_s, step_s, iters, calls = 0.0, 0.0, 0, {}
        for on in OBS_COST_TURNS:
            rate, parts, steps = turn(hook, on)
            rates[on].append(rate)
            if on:
                step_s += steps[0]
                iters += steps[1]
                for part, (sec, n) in parts.items():
                    hook_s += sec
                    calls[part] = calls.get(part, 0) + n
        out[hook] = {
            side: {"decode_tok_s_per_request": r, "median": statistics.median(r),
                   "spread": max(r) - min(r)}
            for side, r in (("off", rates[0]), ("on", rates[1]))}
        spread = max(out[hook]["off"]["spread"], out[hook]["on"]["spread"])
        share = hook_s / step_s
        out[hook]["host_work"] = {
            "iterations": iters, "calls": calls,
            "us_per_iteration": hook_s / iters * 1e6,
            "step_ms_per_iteration": step_s / iters * 1e3,
            "share_of_step": share,
            "spread_share_of_rate": spread / out[hook]["off"]["median"]}
        check(share < HOOK_SHARE_MAX,
              f"observability_costs: {hook} takes {share:.2%} of the step")
    emit({"phase": "observability_costs", "model": runner.config.name,
          "turns": OBS_COST_TURNS, "requests": COST_REQUESTS,
          "prompt_tokens": COST_PROMPT, "output_tokens": COST_OUT, "nvidia_smi": smi,
          **out, "per_call": hook_call_costs()})
    return out


def hw_profile_phase(runner, smi):
    """`run_hw_sweep` at llama-3.2-3b's full width on the 3B's params:
    variants kernel and ref x bf16 and int8 KV, batches 1/8/32 (each call
    HW_DECODE_STEPS steps), prefill chunks 128/512, 3 timed calls each. The GQA kernels' launches equal
    the kernel variants' passes x layers (the ref variants launch none),
    the artifact reads back through load_profile / profile_fit, and each
    variant's fitted lines and capacities are printed."""
    from dynamo_tpu_torch.planner.hw_profile import (
        load_profile, profile_fit, run_hw_sweep, save_profile)

    L = runner.config.n_layers
    reset_launches()
    t0 = time.monotonic()
    prof = run_hw_sweep("llama-3.2-3b", params=runner.params, batches=(1, 8, 32),
                        prefill_chunks=(128, 512), kv_quants=(None, "int8"), iters=3,
                        decode_steps=HW_DECODE_STEPS)
    seconds = time.monotonic() - t0
    launches = {name: KERNELS[name].launches for name in GQA_KERNELS}
    kern = [v["passes"] for k, v in prof["variants"].items() if k.startswith("kernel")]
    want = {"decode_paged_attention": sum(p["decode"] for p in kern) * L,
            "prefill_paged_attention": sum(p["prefill"] for p in kern) * L,
            "ragged_paged_attention": 0}
    check(launches == want, f"hw_profile: launches {launches} != passes x {L} {want}")
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_hw_"),
                        "hw_profile_llama-3.2-3b.json")
    save_profile(prof, path)
    back = load_profile(path)
    fits = {k: profile_fit(back, k) for k in back["variants"]}
    check(set(fits) == {"kernel", "kernel+kv_int8", "ref", "ref+kv_int8"}
          and back["device"] == torch.cuda.get_device_name(0)
          and all(f["decode_capacity_tok_s"] > 0 for f in fits.values()),
          f"hw_profile: the artifact read back: {back['device']}, {fits}")
    emit({"phase": "hw_profile", "model": prof["model"], "device": prof["device"],
          "nvidia_smi": smi, "seconds": seconds, "best_variant": prof["best_variant"],
          "launches": launches, "fits": fits,
          "points": {k: {"decode": v["decode"], "prefill": v["prefill"]}
                     for k, v in prof["variants"].items()}})
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    return launches


def observability_engine_phase(runner, dev, smi):
    """`observability_engine`, in process on the 3B runner: the sync
    mode's catch list, the guard in an engine, the planted stall's anomaly
    and profile window, and the hooks' costs."""
    t0 = time.monotonic()
    rec = {"phase": "observability_engine", "model": runner.config.name,
           "nvidia_smi": smi, "sync_mode_catches": sync_mode_phase(dev)}
    rec["guard"] = guard_phase(runner, dev)
    rec["anomaly"] = anomaly_phase(runner, smi)
    rec["seconds_checks"] = time.monotonic() - t0
    emit(rec)
    cost_pairs_phase(runner, smi)


def tier_cost_feed(engine):
    """The measured G2 price: after the G2 onboard, the engine's digest
    carries kv_onboard_ewma; a FleetObserver ingests it, and a KvRouter
    bound to the observer's onboard_costs prices that worker's G2 credit
    from the measured seconds a block (its audit says "measured"), where
    an unbound one uses the prior."""
    from types import SimpleNamespace

    from dynamo_tpu_torch.router.protocols import OverlapScores
    from dynamo_tpu_torch.runtime.fleet_observer import DigestBuilder, FleetObserver

    digest = DigestBuilder(7).build(engine=engine, period_s=1.0)
    ewma = digest["kv"].get("onboard_ewma", {}).get("host")
    check(ewma is not None and ewma["n"] > 0 and ewma["s_per_block"] > 0,
          f"tier costs: the digest's kv block: {digest['kv']}")
    obs = FleetObserver(None, window_s=60.0)
    check(obs.ingest(digest), "tier costs: the observer refused the digest")
    stub_rt = SimpleNamespace(event_subscriber=lambda subjects=None: None)
    stub_client = SimpleNamespace(
        instances={i: SimpleNamespace(instance_id=i, metadata={}) for i in (7, 8)},
        router=SimpleNamespace(sick_instances=lambda: set()))

    def credit(bound):
        kv = KvRouter(stub_rt, stub_client, block_size=PAGE_SIZE, use_kv_events=False)
        if bound:
            kv.bind_tier_costs(obs.onboard_costs)
        audit = []
        kv.selector.select(kv.workers(), 64, OverlapScores(scores={}, total_blocks=64),
                           kv.sequences, host_overlaps={(7, 0): 64},
                           tier_costs=kv._tier_costs(), audit=audit)
        return next(e for e in audit if e["worker"] == [7, 0])

    measured, prior = credit(True), credit(False)
    cfg = KvRouterConfig()
    check(measured["credit_src"]["host"] == "measured"
          and measured["host_credit_w"] == round(cfg.credit_fraction(ewma["s_per_block"]), 3)
          and prior["credit_src"]["host"] == "prior"
          and prior["host_credit_w"] == cfg.host_credit,
          f"tier costs: bound {measured}, unbound {prior}")
    return {"kv_onboard_ewma": ewma, "host_credit_measured": measured["host_credit_w"],
            "host_credit_prior": prior["host_credit_w"],
            "recompute_block_s": cfg.recompute_block_s}



# -- tensor parallelism: llama-3.1-8b over two rank processes on one card -----

TP_ARGS = model_args("llama-3.1-8b") + ["--tensor-parallel", "2"]
TP_L, TP_HK, TP_G, TP_D = 32, 4, 4, 128  # llama-3.1-8b's rank at TP 2
TP_SHARDED = {
    "decode_paged_attention_sharded": (
        "dynamo_tpu_torch/ops/csrc/paged_attention.cu",
        "dynamo_tpu/ops/paged_attention.py:163 (decode_paged_attention_sharded: "
        "shard_map of :302 over the model axis)"),
    "prefill_paged_attention_sharded": (
        "dynamo_tpu_torch/ops/csrc/flash_prefill.cu",
        "dynamo_tpu/ops/flash_prefill.py:168 (prefill_paged_attention_sharded: "
        "shard_map of :313)"),
    "ragged_paged_attention_sharded": (
        "dynamo_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "dynamo_tpu/ops/ragged_paged_attention.py:345 (ragged_paged_attention_sharded: "
        "shard_map of :486)"),
    "gather_pages_sharded": (
        "dynamo_tpu_torch/ops/csrc/block_copy.cu",
        "dynamo_tpu/ops/block_copy.py:88 (gather_pages_sharded: shard_map of :79)"),
    "scatter_pages_sharded": (
        "dynamo_tpu_torch/ops/csrc/block_copy.cu",
        "dynamo_tpu/ops/block_copy.py:121 (scatter_pages_sharded: shard_map of :226)"),
    "decode_mla_attention_sharded": (
        "dynamo_tpu_torch/ops/csrc/mla_attention.cu",
        "dynamo_tpu/ops/mla_attention.py:345 (decode_mla_attention_sharded: "
        "shard_map of :161 over the model axis)"),
    "prefill_mla_attention_sharded": (
        "dynamo_tpu_torch/ops/csrc/mla_attention.cu",
        "dynamo_tpu/ops/mla_attention.py:310 (prefill_mla_attention_sharded: "
        "shard_map of :299)"),
}
# the plain kernel each sharded wrapper launches
TP_INNER = {"decode_paged_attention_sharded": "decode_paged_attention",
            "prefill_paged_attention_sharded": "prefill_paged_attention",
            "ragged_paged_attention_sharded": "ragged_paged_attention",
            "gather_pages_sharded": "gather_pages",
            "scatter_pages_sharded": "scatter_pages",
            "decode_mla_attention_sharded": "decode_mla_attention",
            "prefill_mla_attention_sharded": "prefill_mla_attention"}
# DeepSeek-V3's query heads a rank at TP 2 (the latent pool is whole)
TP_MLA_H = MLA_H // 2
# the MoE model at TP 2: qwen3-30b-a3b at its DEPTH_CUTS depth, a rank's
# Hk 2 with G 8 (the GQA sharded wrappers at G 8) and F 384 of each expert
TP_MOE_MODEL = "qwen3-30b-a3b"
TP_MOE_HK = 2


def tp_kernels_phase(dev):
    """Each sharded wrapper on one rank's slice at llama-3.1-8b's TP 2
    shapes (Hk 4, G 4, D 128, PS 16; the page copies over a 32-layer pool
    of 2048 pages) against its plain version on the same inputs: the
    attention ones within KERNEL_TOL and, row by row, ROW_REL_TOL of the
    plain version in f32; the copies bit for bit. Timed back to back and
    as CUDA-graph replays, beside the plain version, the bound and the
    yardstick (SDPA over K/V gathered dense beforehand; index_select /
    index_copy_) at the same shapes."""
    gen = torch.Generator(device="cpu").manual_seed(25)
    Hk, G, D, PS = TP_HK, TP_G, TP_D, 16
    H, scale = Hk * G, TP_D ** -0.5
    out = {}

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).bfloat16().to(dev)

    # decode: B 8 over the main path's contexts
    kv_list = [4096, 0, 1, 17, 1000, 2048, 3333, 513]
    B, MP = len(kv_list), 4096 // PS
    NP = B * MP + 1
    kp, vp, q = rnd(NP, PS, Hk, D), rnd(NP, PS, Hk, D), rnd(B, Hk, G, D)
    pt = random_pages(gen, B, MP, NP, dev)
    kvl = torch.tensor(kv_list, dtype=torch.int32, device=dev)
    fn = decode_paged_attention_sharded
    got = fn(q, kp, vp, pt, kvl)
    torch.cuda.synchronize()
    ref = decode_paged_attention_ref(q, kp, vp, pt, kvl)
    err = (got.float() - ref.float()).abs().max().item()
    rel = row_rel_err(got, decode_paged_attention_ref(*plain32((q, kp, vp)), pt, kvl))
    check(torch.isfinite(got.float()).all().item() and err <= KERNEL_TOL
          and rel <= ROW_REL_TOL, f"tp decode: err {err}, row error {rel}")
    kq, vq = dense_kv(kp, pt, Hk, G), dense_kv(vp, pt, Hk, G)
    mask = (torch.arange(MP * PS, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    n_tok = sum(kv_list)
    n_bytes = (2 * q.numel() * 2 + n_tok * Hk * D * 4
               + sum(-(-k // PS) for k in kv_list) * 4 + B * 4)
    b_ms, b_by = bound(n_bytes, 4 * n_tok * H * D)
    qd = q.reshape(B, H, 1, D)

    def lib():
        return F.scaled_dot_product_attention(qd, kq, vq, attn_mask=mask, scale=scale)

    out[fn.__name__] = {
        "max_abs_err": err, "row_rel_err": rel,
        "ms": cuda_ms(lambda: fn(q, kp, vp, pt, kvl)),
        "plain_ms": cuda_ms(lambda: decode_paged_attention_ref(q, kp, vp, pt, kvl)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(lib),
        "device_ms": graph_ms(lambda: fn(q, kp, vp, pt, kvl)), "library_device_ms": graph_ms(lib),
        "shape": {"B": B, "Hk": Hk, "G": G, "D": D, "PS": PS, "kv_lens": kv_list}}
    del kp, vp, kq, vq

    # prefill: a 450-token chunk over 700 prior tokens, S 512
    prior, q_len, S = 700, 450, 512
    kv = prior + q_len
    MP = -(-kv // PS) + 2
    NP = MP + 1
    kp, vp, q = rnd(NP, PS, Hk, D), rnd(NP, PS, Hk, D), rnd(1, S, Hk, G, D)
    pt = random_pages(gen, 1, MP, NP, dev)
    ints = [torch.tensor([x], dtype=torch.int32, device=dev) for x in (prior, q_len, kv)]
    args = (q, kp, vp, pt, *ints)
    fn = prefill_paged_attention_sharded
    got = fn(*args)
    torch.cuda.synchronize()
    ref = prefill_paged_attention_ref(*args)
    err = (got[:, :q_len].float() - ref[:, :q_len].float()).abs().max().item()
    rel = row_rel_err(got[:, :q_len], prefill_paged_attention_ref(
        *plain32(args[:3]), *args[3:])[:, :q_len])
    check(err <= KERNEL_TOL and rel <= ROW_REL_TOL
          and got[:, q_len:].float().abs().max().item() == 0.0,
          f"tp prefill: err {err}, row error {rel} (padding rows must be 0)")
    kq, vq = dense_kv(kp, pt, Hk, G), dense_kv(vp, pt, Hk, G)
    qd = q.reshape(1, S, H, D).transpose(1, 2)
    s_pos = prior + torch.arange(S, device=dev)
    c_pos = torch.arange(MP * PS, device=dev)
    mask = ((c_pos[None, :] <= s_pos[:, None]) & (c_pos[None, :] < kv))[None, None]
    n_pairs = sum(min(prior + s + 1, kv) for s in range(q_len))
    b_ms, b_by = bound(q_len * H * D * 2 + q.numel() * 2 + kv * Hk * D * 4
                       + (-(-kv // PS)) * 4 + 12, 4 * n_pairs * H * D)

    def lib():
        return F.scaled_dot_product_attention(qd, kq, vq, attn_mask=mask, scale=scale)

    out[fn.__name__] = {
        "max_abs_err": err, "row_rel_err": rel,
        "ms": cuda_ms(lambda: fn(*args)),
        "plain_ms": cuda_ms(lambda: prefill_paged_attention_ref(*args)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(lib),
        "device_ms": graph_ms(lambda: fn(*args)), "library_device_ms": graph_ms(lib),
        "shape": {"S": S, "q_len": q_len, "prior": prior, "Hk": Hk, "G": G, "D": D}}
    del kp, vp, kq, vq, args

    # ragged: the main path's 264-token mixed step (8 decode rows, 4 chunks)
    segs = [(1, k - 1) for k in RAGGED_DECODE_KV] + RAGGED_CHUNKS
    args, md = ragged_inputs(gen, segs, RAGGED_T, Hk, G, D, PS, 4096 // PS, dev)
    fn = ragged_paged_attention_sharded
    got = fn(*args)
    torch.cuda.synchronize()
    ref = ragged_paged_attention_ref(*args)
    n = sum(k for k, _ in segs)
    err = (got[:n].float() - ref[:n].float()).abs().max().item()
    rel = row_rel_err(got[:n], ragged_paged_attention_ref(*plain32(args[:3]), *args[3:])[:n])
    check(err <= KERNEL_TOL and rel <= ROW_REL_TOL
          and (n == got.shape[0] or got[n:].float().abs().max().item() == 0.0),
          f"tp ragged: err {err}, row error {rel} (tail rows must be 0)")
    kv_tok = sum(k + p for k, p in segs)
    pairs = sum(p + i + 1 for k, p in segs for i in range(k))
    b_ms, b_by = bound(n * H * D * 2 + RAGGED_T * H * D * 2 + kv_tok * Hk * D * 4
                       + sum(-(-(k + p) // PS) for k, p in segs) * 4
                       + md["seg_kv_lens"].size * 4 + md["meta"].size * 4,
                       4 * pairs * H * D)
    lib = ragged_library(args, segs, md, scale)
    out[fn.__name__] = {
        "max_abs_err": err, "row_rel_err": rel,
        "ms": cuda_ms(lambda: fn(*args)),
        "plain_ms": cuda_ms(lambda: ragged_paged_attention_ref(*args), iters=5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(lib),
        "device_ms": graph_ms(lambda: fn(*args)), "library_device_ms": graph_ms(lib),
        "shape": {"T": RAGGED_T, "Hk": Hk, "G": G, "D": D, "PS": PS}}
    del args, lib

    out.update(tp_mla_kernels(gen, dev))

    # the page copies: 94 random pages of a rank's 32-layer, 2048-page pool
    shape = (TP_L, 2048, PS, Hk, D)
    pool = torch.randn(shape, generator=gen).bfloat16().to(dev)
    idx = torch.randperm(2048, generator=gen)[:94].to(torch.int32).to(dev)
    idx_l = idx.long()
    fn = gather_pages_sharded
    pages = fn(pool, idx)
    torch.cuda.synchronize()
    check(torch.equal(pages, bc.gather_pages_ref(pool, idx)), "tp gather: not bit for bit")
    buf = torch.empty_like(pages)
    b_ms, b_by = bound(2 * pages.numel() * pages.element_size() + idx.numel() * 4, 0)
    out[fn.__name__] = {
        "max_abs_err": 0.0, "ms": cuda_ms(lambda: fn(pool, idx)),
        "plain_ms": cuda_ms(lambda: bc.gather_pages_ref(pool, idx)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: pool.index_select(1, idx_l)),
        # the wrapper reads its page ids back, which a graph cannot hold:
        # its kernel's launch on the checked operands is replayed
        "device_ms": graph_ms(lambda: bc._launch_gather(pool, idx, buf, False)),
        "library_device_ms": graph_ms(lambda: pool.index_select(1, idx_l)),
        "shape": {"pool": list(shape), "pages": 94}}
    fn = scatter_pages_sharded
    new = torch.randn(pages.shape, generator=gen).bfloat16().to(dev)
    a, b = pool.clone(), pool.clone()
    fn(a, idx, new)
    bc.scatter_pages_ref(b, idx, new)
    torch.cuda.synchronize()
    check(torch.equal(a, b), "tp scatter: not bit for bit")
    out[fn.__name__] = {
        "max_abs_err": 0.0, "ms": cuda_ms(lambda: fn(a, idx, new)),
        "plain_ms": cuda_ms(lambda: bc.scatter_pages_ref(b, idx, new)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: b.index_copy_(1, idx_l, new)),
        "device_ms": graph_ms(lambda: bc._launch_scatter(a, idx, new)),
        "library_device_ms": graph_ms(lambda: b.index_copy_(1, idx_l, new)),
        "shape": {"pool": list(shape), "pages": 94}}
    del pool, a, b, pages, new, buf
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "tp_kernels", "tol": KERNEL_TOL, "row_tol": ROW_REL_TOL, **out})
    return out


def tp_mla_kernels(gen, dev):
    """The sharded MLA pair at DeepSeek-V3's TP 2 rank shape (H 64 of 128,
    d_c 512, d_rh 64, PS 16; the latent pool whole): decode at B 8 over
    MLA_DECODE_KV on the bf16 and the int8 latent bodies, prefill of a
    450-token chunk over 700 prior tokens (S 512), each against its plain
    version within KERNEL_TOL and, row by row against the plain version in
    f32, ROW_REL_TOL; timed back to back and as graph replays beside the
    plain version, the bound and the three-call yardstick over the latent
    gathered dense beforehand (mla_library). Decode at TP 1's H 128 on the
    same inputs is replayed beside it: a decode block owns 64 heads, so a
    rank launches half of TP 1's blocks, each reading the same latent."""
    H, dc, dr, PS = TP_MLA_H, MLA_DC, MLA_DR, MLA_PS
    Dl = dc + dr
    scale = attn_score_scale(MLA_CONFIG, MLA_CONFIG.qk_nope_head_dim + dr)
    rnd = mla_rnd(gen, dev)
    out = {}

    kv_list = MLA_DECODE_KV
    B, MP = len(kv_list), 4096 // PS
    NP = B * MP + 1
    lat = rnd(NP, PS, 1, Dl)
    q_full = rnd(B, MLA_H, Dl)
    q = q_full[:, :H].contiguous()  # rank 0's heads
    pt = random_pages(gen, B, MP, NP, dev)
    kvl = torch.tensor(kv_list, dtype=torch.int32, device=dev)
    lat8, lat8_deq = int8_pool(lat)
    dense = lat[pt.long()].reshape(B, MP * PS, Dl)
    dense8 = lat8_deq[pt.long()].reshape(B, MP * PS, Dl)
    mask = (torch.arange(MP * PS, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    n_tok = sum(kv_list)
    io = q.numel() * 2 + B * H * dc * 2 + sum(-(-k // PS) for k in kv_list) * 4 + B * 4
    fn = decode_mla_attention_sharded
    bodies = {}
    for body, pool, deq in (("bf16", lat, dense), ("int8", lat8, dense8)):
        call = lambda pool=pool: fn(q, pool, pt, kvl, dc=dc, scale=scale)  # noqa: E731
        before = dict(decode_mla_attention.bodies)
        got = call()
        torch.cuda.synchronize()
        check(decode_mla_attention.bodies.get(body, 0) == before.get(body, 0) + 1,
              f"tp mla decode: the {body} call did not launch the {body} body")
        ref = decode_mla_attention_ref(q, pool, pt, kvl, dc=dc, scale=scale)
        err = (got.float() - ref.float()).abs().max().item()
        rel = row_rel_err(got, decode_mla_attention_ref(q.float(), pool.float() if body == "bf16"
                                                        else pool, pt, kvl, dc=dc, scale=scale))
        check(torch.isfinite(got.float()).all().item() and err <= KERNEL_TOL
              and rel <= ROW_REL_TOL and got[1].float().abs().max().item() == 0.0,
              f"tp mla decode ({body}): err {err}, row error {rel} (the kv_len 0 row must be 0)")
        lat_bytes = n_tok * (Dl + 4 if body == "int8" else Dl * 2)
        b_ms, b_by = bound(io + lat_bytes, 2 * n_tok * H * (Dl + dc))
        lib, lib_name = mla_library(q[:, :, None], deq, mask, dc, scale)
        bodies[body] = {
            "max_abs_err": err, "row_rel_err": rel, "ms": cuda_ms(call),
            "plain_ms": cuda_ms(lambda pool=pool: decode_mla_attention_ref(
                q, pool, pt, kvl, dc=dc, scale=scale), iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(lib),
            "library": lib_name, "device_ms": graph_ms(call),
            "library_device_ms": graph_ms(lib)}
        # TP 1's call on all 128 heads of the same rows: twice the blocks
        full = lambda pool=pool: decode_mla_attention(  # noqa: E731
            q_full, pool, pt, kvl, dc=dc, scale=scale)
        tb_ms, _ = bound(io * MLA_H // H + lat_bytes, 2 * n_tok * MLA_H * (Dl + dc))
        bodies[body]["tp1_H128"] = {"device_ms": graph_ms(full), "bound_ms": tb_ms}
    out[fn.__name__] = {**bodies["bf16"], "bodies": bodies,
                        # a decode block owns 64 heads of a row's split
                        "head_blocks": {"rank": -(-H // 64), "tp1": -(-MLA_H // 64)},
                        "shape": {"B": B, "H": H, "dc": dc, "dr": dr, "PS": PS,
                                  "kv_lens": kv_list}}
    del lat, lat8, lat8_deq, dense, dense8

    S, (q_len, prior) = MLA_TIMED_S, MLA_TIMED_SEG
    kv = prior + q_len
    MP = -(-kv // PS) + 2
    lat = rnd(MP + 1, PS, 1, Dl)
    q = rnd(1, S, H, Dl)
    pt = random_pages(gen, 1, MP, MP + 1, dev)
    ints = [torch.tensor([x], dtype=torch.int32, device=dev) for x in (prior, q_len, kv)]
    args = (q, lat, pt, *ints)
    fn = prefill_mla_attention_sharded
    got = fn(*args, dc=dc, scale=scale)
    torch.cuda.synchronize()
    ref = prefill_mla_attention_ref(*args, dc=dc, scale=scale)
    err = (got[:, :q_len].float() - ref[:, :q_len].float()).abs().max().item()
    rel = row_rel_err(got[:, :q_len], prefill_mla_attention_ref(
        *plain32(args[:2]), *args[2:], dc=dc, scale=scale)[:, :q_len])
    check(torch.isfinite(got.float()).all().item() and err <= KERNEL_TOL
          and rel <= ROW_REL_TOL and got[:, q_len:].float().abs().max().item() == 0.0,
          f"tp mla prefill: err {err}, row error {rel} (padding rows must be 0)")
    n_pairs = sum(min(prior + s + 1, kv) for s in range(q_len))
    b_ms, b_by = bound(q_len * H * Dl * 2 + S * H * dc * 2 + kv * Dl * 2
                       + (-(-kv // PS)) * 4 + 3 * 4, 2 * n_pairs * H * (Dl + dc))
    dense = lat[pt.long()].reshape(1, MP * PS, Dl)
    s_pos = prior + torch.arange(q_len, device=dev)
    c_pos = torch.arange(MP * PS, device=dev)
    mask = ((c_pos[None, :] <= s_pos[:, None]) & (c_pos[None, :] < kv))[None, None]
    lib, lib_name = mla_library(q[:, :q_len].permute(0, 2, 1, 3).contiguous(), dense,
                                mask, dc, scale)
    out[fn.__name__] = {
        "max_abs_err": err, "row_rel_err": rel,
        "ms": cuda_ms(lambda: fn(*args, dc=dc, scale=scale)),
        "plain_ms": cuda_ms(lambda: prefill_mla_attention_ref(*args, dc=dc, scale=scale),
                            iters=5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(lib), "library": lib_name,
        "device_ms": graph_ms(lambda: fn(*args, dc=dc, scale=scale)),
        "library_device_ms": graph_ms(lib),
        "shape": {"S": S, "q_len": q_len, "prior": prior, "H": H, "dc": dc, "dr": dr,
                  "PS": PS}}
    del lat, dense, args, lib
    return out


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def tp_check_ranks(phase: str, runner, L: int, reps, want_calls=None, heads=TP_HK):
    """Every rank's report after a run: the same runner counters and the
    same digest of returned arrays (the followers' tokens are rank 0's);
    each sharded wrapper's launches equal to the launches of its kernel
    (every launch went through it) on the rank's `heads` only (KV heads,
    or an MLA model's query heads), each attention kernel's of the model's
    family to its passes x L and the other family's 0, and each grouped-
    GEMM entry's to passes x the MoE layers."""
    st = reps[0]["stats"]
    cfg = runner.config
    prefill = st["prefill_chunks"] + st["padded_prefill_dispatches"]
    ragged = st["ragged_mixed_dispatches"] + st["ragged_verify_dispatches"]
    gqa = {"decode_paged_attention_sharded": st["decode_steps"],
           "prefill_paged_attention_sharded": prefill + st["spec_verify_passes"],
           "ragged_paged_attention_sharded": ragged}
    mla = {"decode_mla_attention_sharded": st["decode_steps"],
           "prefill_mla_attention_sharded": 0 if runner.kv_quantize else prefill}
    passes = {**{k: 0 if cfg.is_mla else n for k, n in gqa.items()},
              **{k: n if cfg.is_mla else 0 for k, n in mla.items()}}
    all_passes = prefill + st["decode_steps"] + ragged + st["spec_verify_passes"]
    for rep in reps:
        r = rep["rank"]
        check(rep["stats"] == st, f"{phase}: rank {r} counters {rep['stats']} != rank 0's {st}")
        check(rep["digest"] == reps[0]["digest"] and rep["outputs"] == reps[0]["outputs"],
              f"{phase}: rank {r}'s returned tokens differ from rank 0's")
        for name, inner in TP_INNER.items():
            n = rep["launches"][name]
            check(n == rep["launches"][inner],
                  f"{phase}: rank {r} {inner} {rep['launches'][inner]} launches, "
                  f"{n} through {name}")
            check(rep["heads"][name] == ({heads: n} if n else {}),
                  f"{phase}: rank {r} {name} heads {rep['heads'][name]}")
        for name, p in passes.items():
            check(rep["launches"][name] == p * L,
                  f"{phase}: rank {r} {name} {rep['launches'][name]} != {p} passes x {L}")
        for name in MOE_KERNELS:
            check(rep["launches"][name] == all_passes * runner.moe_layers,
                  f"{phase}: rank {r} {name} {rep['launches'][name]} != {all_passes} "
                  f"passes x {runner.moe_layers} MoE layers")
        for name, n in (want_calls or {}).items():
            check(rep["launches"][name] == n,
                  f"{phase}: rank {r} {name} {rep['launches'][name]} != {n}")
    return {
        "per_rank": [{k: rep.get(k) for k in ("rank", "pid", "device", "launches", "heads",
                                              "peak_bytes", "digest", "outputs")}
                     for rep in reps],
        "bodies": [rep["bodies"] for rep in reps]}


def tp_turn(runner, phase: str, fused, build_s=None, base_args=TP_ARGS, heads=TP_HK):
    """One engine turn of the 3B's traffic on the TP 2 runner: every rank's
    counters zeroed just before and read just after; rank 0's launch
    identities as every turn's (served_turn), then every rank's
    (tp_check_ranks, the sharded wrappers on the rank's `heads`). Returns
    (rec, rank 0's launches)."""
    cfg = runner.config
    rec, launches, results = engine_phase(
        runner, phase, fused=fused, build_s=build_s, base_args=base_args,
        probe=lambda engine: runner.reset_counters())
    check(all(f == "length" and len(t) == N_OUT for t, f, _ in results),
          f"{phase}: a request did not finish `length` with {N_OUT} tokens")
    st = rec["stats"]
    if fused is None and cfg.is_mla:  # MLA has no ragged step
        check(rec["fused_mixed"] and st["padded_prefill_dispatches"] > 0
              and st["ragged_mixed_dispatches"] == 0,
              f"{phase}: mixed plans did not take the padded fallback: {st}")
    elif fused is None:
        check(rec["fused_mixed"] and st["ragged_mixed_dispatches"] > 0
              and st["padded_prefill_dispatches"] == 0,
              f"{phase}: mixed plans did not ride the ragged step: {st}")
    else:
        check(not rec["fused_mixed"] and launches["ragged_paged_attention"] == 0,
              f"{phase}: DYN_FUSED_MIXED=0 did not hold")
    reps = runner.rank_reports()
    rec.update(tp_check_ranks(phase, runner, cfg.n_layers, reps, heads=heads))
    rec["streams"] = [t for t, _, _ in results]
    return rec, launches


def tp_pull(tp1, tp2, prompt, table, smi):
    """One TP 1 -> TP 2 pull: the prompt's pages exported from the TP 1
    runner, imported into other pages of the TP 2 runner (each rank keeps
    its heads: scatter_pages_sharded), exported back from the TP 2 runner
    (each rank gathers its heads, gather_pages_sharded, and the ranks'
    slices are all-gathered): bit for bit the TP 1 export. Each rank's
    copies counted from 0 just before the TP 2 runner's import (the TP 1
    export, in this process too, before it)."""
    pages = table[:-(-len(prompt) // 16)]
    dst = list(range(1500, 1500 + len(pages)))
    payload = tp1.export_pages(pages)
    tp2.reset_counters()
    t0 = time.monotonic()
    tp2.import_pages(dst, 0, payload)
    back = tp2.export_pages(dst)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    check(back["tp"] == 2 and payload["tp"] == 1, "tp pull: the payloads' tp degrees")
    check(back["k"] == payload["k"] and back["v"] == payload["v"],
          "tp pull: the TP 2 runner's export of the imported pages is not the TP 1 export")
    reps = tp2.rank_reports()
    per = tp_check_ranks("tp_pull", tp2, TP_L, reps, {
        "gather_pages_sharded": 2, "scatter_pages_sharded": 2})
    rec = {"phase": "tp_pull", "pages": len(pages), "bytes": 2 * len(payload["k"]),
           "seconds": seconds, **per, "nvidia_smi": smi}
    emit(rec)
    return {name: reps[0]["launches"][name] for name in
            ("gather_pages_sharded", "scatter_pages_sharded")}


class route_tape:
    """Within it, every moe_block's routing (weights, top-k ids) in this
    process is kept in call order (a TP 2 runner's rank 0 runs here: every
    rank routes the same tokens alike on the same all-reduced h). With
    `replay`, each call takes the next recorded routing instead of its own
    (its shape checked), so a TP 1 runner computes the TP 2 run's experts
    and the two differ only in arithmetic."""

    def __init__(self, replay=None):
        self.replay = replay
        self.routes = []

    def __enter__(self):
        self._orig = moe_model.router_topk

        def hook(*a, **kw):
            weights, sel = self._orig(*a, **kw)
            if self.replay is not None:
                check(len(self.routes) < len(self.replay),
                      f"route_tape: more MoE blocks than the {len(self.replay)} recorded")
                rw, rs = self.replay[len(self.routes)]
                check(rs.shape == sel.shape, f"route_tape: {tuple(sel.shape)} against "
                      f"the recorded {tuple(rs.shape)}")
                weights, sel = rw, rs
            self.routes.append((weights, sel))
            return weights, sel

        moe_model.router_topk = hook
        return self

    def __exit__(self, *exc):
        moe_model.router_topk = self._orig
        if exc[0] is None and self.replay is not None:
            check(len(self.routes) == len(self.replay),
                  f"route_tape: {len(self.routes)} MoE blocks, {len(self.replay)} recorded")


def route_flips(a, b):
    """Top-k choices of routing tape `a` that tape `b` did not make."""
    choices = differ = 0
    for (_, sa), (_, sb) in zip(a, b):
        same = (sa[..., :, None] == sb[..., None, :]).any(-1)
        choices += sa.numel()
        differ += int((~same).sum())
    return {"choices": choices, "choices_differing": differ}


def tp_parity(tp1, tp2, smi, phase: str = "tp_parity", greedy_steps: int = 16,
              labels=("tp1", "tp2")):
    """TP 2 against TP 1 on the same seed-0 params: a 700-token prefill's
    logits and a fused step's chunk logits (a decode row beside a
    300-token chunk) within FORWARD_REL_TOL (rel L2); on a MoE model the
    TP 1 runner pinned to the TP 2 run's routing (route_tape), its free
    run reported beside it with the choices that differ; greedy agreement
    over `greedy_steps` decode steps after the fused step; then a decode
    step's ms at 8 rows over 700-token contexts for both, in turns (TP 1,
    TP 2, TP 2, TP 1; `labels` name the two). Returns the prompt and its
    pages."""
    moe = tp1.moe_layers > 0
    V = tp1.config.vocab_size
    gen = torch.Generator(device="cpu").manual_seed(26)
    prompt = torch.randint(0, V, (700,), generator=gen).tolist()
    chunk = torch.randint(0, V, (300,), generator=gen).tolist()
    table = list(range(1, 45))  # 44 pages of 16: room for the decode steps
    ctable = list(range(50, 70))
    greedy = {"temperature": [0.0], "top_k": [0], "top_p": [1.0], "seeds": [0]}

    def forwards(r, tok=None):
        """The prefill's and the fused step's logits, the prefill's token
        (`tok` if given: a pinned run takes the TP 2 run's) and the step's."""
        pre = r.prefill(prompt, 0, table, 0).float()
        tok = int(pre.argmax()) if tok is None else tok
        toks, mixed = r.decode_multi_with_prefill(
            1, [tok], [len(prompt)], [table], greedy, 0, chunk, 0, ctable, 0)
        return pre, mixed.float(), tok, int(toks[0, 0])

    with route_tape() as tape2:
        pre2, mix2, tok2, nxt2 = forwards(tp2)
    rec = {"phase": phase, "model": tp1.config.name, "n_layers": tp1.config.n_layers,
           "tol": FORWARD_REL_TOL}
    if moe:
        with route_tape() as tape1:
            pre1, mix1, tok1, nxt1 = forwards(tp1, tok2)
        rec["free"] = {"rel_l2_prefill": rel_l2(pre2, pre1), "rel_l2_mixed": rel_l2(mix2, mix1),
                       **route_flips(tape2.routes, tape1.routes)}
        with route_tape(replay=tape2.routes):
            pre1, mix1, tok1, nxt1 = forwards(tp1, tok2)
        rec["pinned_moe_blocks"] = len(tape2.routes)
    else:
        pre1, mix1, tok1, nxt1 = forwards(tp1)
    rec["rel_l2_prefill"], rec["rel_l2_mixed"] = rel_l2(pre2, pre1), rel_l2(mix2, mix1)
    check(rec["rel_l2_prefill"] <= FORWARD_REL_TOL and rec["rel_l2_mixed"] <= FORWARD_REL_TOL,
          f"{phase}: rel L2 prefill {rec['rel_l2_prefill']}, mixed {rec['rel_l2_mixed']} "
          f"> {FORWARD_REL_TOL}")
    if greedy_steps:
        a, b = ([t, n] + r.decode_multi(greedy_steps, [n], [len(prompt) + 1], [table],
                                        greedy, 1)[0].tolist()
                for r, t, n in ((tp1, tok1, nxt1), (tp2, tok2, nxt2)))
        rec["greedy_tokens"] = len(a)
        rec["greedy_agree_prefix"] = next(
            (i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
        rec["greedy_agree_frac"] = sum(x == y for x, y in zip(a, b)) / len(a)
    rows = [list(range(100 + 45 * i, 145 + 45 * i)) for i in range(8)]
    eight = {k: v * 8 for k, v in greedy.items()}
    eight["seeds"] = list(range(8))

    def step_ms(r, n=8):
        r.decode_multi(n, [1] * 8, [700] * 8, rows, eight, 0)  # warm
        torch.cuda.synchronize()
        t0 = time.monotonic()
        r.decode_multi(n, [1] * 8, [700] * 8, rows, eight, 0)
        torch.cuda.synchronize()
        return (time.monotonic() - t0) * 1e3 / n

    a, b = labels
    rec["decode_step_ms_8_rows"] = [(a, step_ms(tp1)), (b, step_ms(tp2)),
                                    (b, step_ms(tp2)), (a, step_ms(tp1))]
    rec["nvidia_smi"] = smi
    emit(rec)
    return prompt, table


def tp_model_phase(group, procs, phase: str, cfg, base_args, heads: int, smi,
                   int8_turn: bool = False):
    """`cfg` at TP 2 on the ranks engine_tp spawned (each rank drawing its
    seed-0 slices), beside a TP 1 runner on the same params in this
    process: tp_parity, the TP 1 runner freed, then one fused turn
    of the 3B's traffic (`engine_<phase>`) with every rank's launch
    identities on the rank's `heads`, the ranks' counters and digests
    equal and each rank's peak memory; with `int8_turn` (MLA), a second
    turn over int8 pools on the same ranks (`engine_<phase>_int8`: every
    decode launch on the int8 latent body of each rank's aligned pool,
    prefill gathering). Returns rank 0's launches of the first turn."""
    from dynamo_tpu_torch.parallel.group import MirroredRunner

    kw = dict(config=cfg, num_pages=2048, page_size=PAGE_SIZE,
              max_pages_per_seq=4096 // PAGE_SIZE)
    t0 = time.monotonic()
    tp2 = MirroredRunner(group, procs, device=group.devices[0], **kw)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    tp1 = ModelRunner(device=group.devices[0], **kw)
    tp_parity(tp1, tp2, smi, f"tp_parity_{phase}", greedy_steps=0)
    free(tp1)
    del tp1
    rec, _ = tp_turn(tp2, phase, None, build_s, base_args=base_args, heads=heads)
    rec["config"] = {k: getattr(cfg, k) for k in CONFIG_FIELDS if hasattr(cfg, k)}
    rec["transport"] = group.transport
    rec["nvidia_smi"] = smi
    emit(rec)
    tp2.close()
    gc.collect()
    torch.cuda.empty_cache()
    if int8_turn:
        tp8 = MirroredRunner(group, procs, device=group.devices[0], kv_quantize="int8", **kw)
        rec8, _ = tp_turn(tp8, f"{phase}_int8", None, base_args=base_args, heads=heads)
        for r, b in enumerate(rec8["bodies"]):
            n = rec8["per_rank"][r]["launches"]["decode_mla_attention"]
            check(n > 0 and b["decode_mla_attention"] == {"int8": n},
                  f"engine_{phase}_int8: rank {r} decode bodies {b['decode_mla_attention']}")
        rec8["nvidia_smi"] = smi
        emit(rec8)
        tp8.close()
        gc.collect()
        torch.cuda.empty_cache()
    return rec["per_rank"][0]["launches"]


def engine_tp_phase(smi):
    """llama-3.1-8b at full width and depth served at TP 2, two rank
    processes on the card (`--tensor-parallel 2`: the kernels built once
    here, the follower spawned): its parity with a TP 1 runner on the same
    seed-0 params (tp_parity), one TP 1 -> TP 2 pull (tp_pull), then the
    3B's traffic fused (`engine_tp`, the main path) and unfused
    (`engine_tp_unfused`), and a fused turn over int8 pools
    (`engine_tp_int8`, a TP 2 runner on the same ranks); each turn with
    every rank's launch identities, the followers' tokens equal to rank
    0's, each rank's peak memory. Last, llama-3.1-70b at TP 2 is refused
    by the fit check before anything is spawned or drawn. Returns the
    sharded wrappers' launches (the fused turn's; the copies' from the
    pull) and the turns' bodies."""
    t0 = time.monotonic()
    tp2, cfg = build_runner(parse_args(TP_ARGS))
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    group = tp2.group
    emit({"phase": "tp_ranks", "transport": group.transport,
          "devices": [str(d) for d in group.devices],
          "follower_pids": [p.pid for p in tp2._procs], "build_s": build_s,
          "nvidia_smi": smi})
    check(cfg.n_layers == TP_L and cfg.n_kv_heads // 2 == TP_HK,
          f"engine_tp: {cfg.name} has {cfg.n_layers} layers, {cfg.n_kv_heads} KV heads")
    tp1, _, _ = timed_runner(model_args("llama-3.1-8b"))
    prompt, table = tp_parity(tp1, tp2, smi)
    launches = tp_pull(tp1, tp2, prompt, table, smi)
    free(tp1)
    del tp1
    found = {}
    for phase, fused in (("tp", None), ("tp_unfused", False)):
        rec, l0 = tp_turn(tp2, phase, fused, build_s if fused is None else None)
        rec["transport"] = group.transport
        rec["nvidia_smi"] = smi
        found[phase] = rec["bodies"][0]
        if fused is None:
            for name in ("decode_paged_attention_sharded", "prefill_paged_attention_sharded",
                         "ragged_paged_attention_sharded"):
                launches[name] = rec["per_rank"][0]["launches"][name]
        emit(rec)
    tp2.close()
    gc.collect()
    torch.cuda.empty_cache()
    # int8 pools on the same ranks
    kw = dict(config=cfg, num_pages=2048, page_size=16, max_pages_per_seq=256,
              device=group.devices[0], kv_quantize="int8")
    from dynamo_tpu_torch.parallel.group import MirroredRunner, shutdown_followers
    tp8 = MirroredRunner(group, tp2._procs, **kw)
    rec, _ = tp_turn(tp8, "tp_int8", None)
    check(all(set(b["ragged_paged_attention"]) <= {"D128_int8"} for b in rec["bodies"]),
          f"engine_tp_int8: bodies {rec['bodies']}")
    rec["nvidia_smi"] = smi
    found["tp_int8"] = rec["bodies"][0]
    emit(rec)
    tp8.close()
    del tp8
    gc.collect()
    torch.cuda.empty_cache()
    # MLA and MoE on the same ranks: DeepSeek-V3's three dense layers (the
    # sharded MLA pair on 64 heads a rank) and qwen3-30b-a3b cut to 8 layers
    # (the GQA wrappers at Hk 2, G 8; each expert's F / 2)
    t_new = time.monotonic()
    mla = timed("engine_tp_mla", tp_model_phase, group, tp2._procs, "tp_mla", MLA_CONFIG,
                model_args("deepseek-v3"), TP_MLA_H, smi, True)
    for name in ("decode_mla_attention_sharded", "prefill_mla_attention_sharded"):
        launches[name] = mla[name]
    moe_cfg = get_config(TP_MOE_MODEL).with_(n_layers=DEPTH_CUTS[TP_MOE_MODEL])
    timed("engine_tp_moe", tp_model_phase, group, tp2._procs, "tp_moe", moe_cfg,
          model_args(TP_MOE_MODEL), TP_MOE_HK, smi)
    emit({"phase": "tp_mla_moe_seconds", "seconds": time.monotonic() - t_new})
    codes = shutdown_followers(group, tp2._procs)
    check(codes == [0], f"engine_tp: the follower exited {codes}")
    del tp2
    gc.collect()
    torch.cuda.empty_cache()
    # llama-3.1-70b over two ranks on this one card: refused by the fit
    # check before any follower is spawned or any tensor drawn
    before = torch.cuda.memory_allocated()
    try:
        build_runner(parse_args(model_args("llama-3.1-70b") + ["--tensor-parallel", "2"]))
        refused = None
    except MemoryError as e:
        refused = str(e)
    check(refused is not None and "2 rank(s) on this device" in refused,
          f"engine_tp_70b: not refused by the fit check: {refused}")
    check(torch.cuda.memory_allocated() == before, "engine_tp_70b: memory was allocated")
    emit({"phase": "engine_tp_70b", "refused": refused, "nvidia_smi": smi})
    # DeepSeek-V3 at full depth (61 layers, 256 experts) over two ranks:
    # refused the same way
    try:
        build_runner(parse_args(model_args("deepseek-v3") + ["--tensor-parallel", "2"]))
        refused = None
    except MemoryError as e:
        refused = str(e)
    check(refused is not None and "2 rank(s) on this device" in refused,
          f"engine_tp_v3: not refused by the fit check: {refused}")
    check(torch.cuda.memory_allocated() == before, "engine_tp_v3: memory was allocated")
    emit({"phase": "engine_tp_v3", "refused": refused, "nvidia_smi": smi})
    return launches, found


# -- expert and data parallelism (ROADMAP A.14 (b)) ----------------------------

EP_MOE_MODEL = "qwen3-30b-a3b"
# the qwen3-30b-a3b meshes: (phase, worker flags)
EP_MESHES = (("ep_moe", ("--expert-parallel", "2")),
             ("ep_tp", ("--expert-parallel", "2", "--tensor-parallel", "2")),
             ("dp_ep", ("--data-parallel", "2", "--expert-parallel", "2")))


def set_router_bias(group, seed: int) -> float:
    """DeepSeek-V3's selection bias drawn away from 0 (as mla_moe_phases
    draws it) into the runner's params on every rank alike (run through
    TPGroup.run_on_ranks; a SimpleNamespace(runner=...) for one runner).
    Returns the bias's abs sum."""
    bias = group.runner.params["layers"]["router_bias"]
    g = torch.Generator(device=bias.device).manual_seed(seed)
    bias.copy_(torch.randn(bias.shape, generator=g, device=bias.device) * 0.01)
    return float(bias.abs().sum())


def passes_of(st) -> int:
    """Forward passes a runner's counters show (each runs every layer)."""
    return (st["prefill_chunks"] + st["padded_prefill_dispatches"] + st["decode_steps"]
            + st["ragged_mixed_dispatches"] + st["ragged_verify_dispatches"]
            + st["spec_verify_passes"])


def collective_totals(rep):
    """A rank report's collectives: calls, host seconds and bytes over its
    axis groups."""
    out = {"calls": 0, "seconds": 0.0, "bytes": 0}
    for stats in rep["collectives"].values():
        for key, v in stats.items():
            for what in out:
                if key.endswith(f"_{what}"):
                    out[what] += v
    return out


def ep_check_ranks(phase: str, runner, reps, heads: int):
    """Every rank's report after a run on an expert mesh: under `model` > 1
    tp_check_ranks' identities (the sharded wrappers on the rank's
    `heads`); else every rank's launches rank 0's (the whole-head kernels,
    no sharded launch), counters and digests equal. Then the MoE blocks:
    dispatched plus fallen back = passes x the MoE layers on every rank,
    the dispatches alike across ranks, three all_to_alls a dispatch."""
    mc = runner.mesh_config
    if mc.model > 1:
        out = tp_check_ranks(phase, runner, runner.config.n_layers, reps, heads=heads)
    else:
        for rep in reps:
            r = rep["rank"]
            check(rep["stats"] == reps[0]["stats"],
                  f"{phase}: rank {r} counters {rep['stats']} != rank 0's")
            check(rep["digest"] == reps[0]["digest"] and rep["outputs"] == reps[0]["outputs"],
                  f"{phase}: rank {r}'s returned tokens differ from rank 0's")
            check(rep["launches"] == reps[0]["launches"],
                  f"{phase}: rank {r} launches {rep['launches']} != rank 0's")
            check(all(rep["launches"][name] == 0 for name in TP_INNER),
                  f"{phase}: rank {r} launched a sharded wrapper at model 1")
        out = {"per_rank": [{k: rep.get(k) for k in ("rank", "pid", "device", "launches",
                                                     "peak_bytes", "digest", "outputs")}
                            for rep in reps],
               "bodies": [rep["bodies"] for rep in reps]}
    passes = passes_of(reps[0]["stats"])
    blocks = passes * runner.moe_layers
    for rep in reps:
        r, ep = rep["rank"], rep["ep"]
        check(ep["dispatches"] + ep["fallbacks"] == blocks,
              f"{phase}: rank {r} {ep} against {passes} passes x {runner.moe_layers} MoE layers")
        check(ep["dispatches"] == reps[0]["ep"]["dispatches"],
              f"{phase}: rank {r} dispatched {ep['dispatches']} blocks, rank 0 "
              f"{reps[0]['ep']['dispatches']}")
        check(rep["collectives"]["expert"]["all_to_all_calls"] == 3 * ep["dispatches"],
              f"{phase}: rank {r} all_to_alls {rep['collectives']['expert']}")
        check(rep["coords"] == mc.coords(r), f"{phase}: rank {r} at {rep['coords']}")
    tot = collective_totals(reps[0])
    out.update({
        "mesh": list(mc.shape), "passes": passes, "ep": [rep["ep"] for rep in reps],
        "coords": [rep["coords"] for rep in reps],
        "collectives": [rep["collectives"] for rep in reps],
        "collectives_per_pass_rank0": tot["calls"] / max(1, passes),
        "collective_host_s_rank0": tot["seconds"],
        "rows_sent_per_dispatch_rank0": (reps[0]["ep"]["rows_sent"]
                                         / max(1, reps[0]["ep"]["dispatches"])),
        "all_to_all_bytes_rank0": reps[0]["collectives"]["expert"]["all_to_all_bytes"],
        "peak_gb": [rep.get("peak_bytes", 0) / 1e9 for rep in reps]})
    return out


def ep_buckets(runner, phase: str, table, smi):
    """The reference's path choice on every rank: two decode steps at one
    row (B S 1 does not split over the expert ranks: the dense fallback,
    one all-reduce a block) and two at eight rows (bucket 8: dispatched),
    each with every rank's counters zeroed just before."""
    greedy = {"temperature": [0.0], "top_k": [0], "top_p": [1.0], "seeds": [0]}
    rec = {"phase": f"ep_buckets_{phase}"}
    L = runner.moe_layers
    for rows, want in ((1, "fallbacks"), (8, "dispatches")):
        runner.reset_counters()
        samp = {k: v * rows for k, v in greedy.items()}
        samp["seeds"] = list(range(rows))
        runner.decode_multi(2, [1] * rows, [700] * rows, [table] * rows, samp, 0)
        reps = runner.rank_reports()
        other = "dispatches" if want == "fallbacks" else "fallbacks"
        for rep in reps:
            check(rep["ep"][want] == 2 * L and rep["ep"][other] == 0,
                  f"ep_buckets_{phase}: rank {rep['rank']} at {rows} row(s): {rep['ep']}")
        rec[f"rows_{rows}"] = {"ep": reps[0]["ep"], "collectives": reps[0]["collectives"]}
    rec["nvidia_smi"] = smi
    emit(rec)
    return rec


def ep_turn(runner, phase: str, build_s, base_args, heads: int, smi):
    """One engine turn of the 3B's traffic on an expert mesh, every rank's
    counters zeroed just before and read just after: rank 0's launch
    identities as every turn's (engine_phase), then every rank's
    (ep_check_ranks)."""
    cfg = runner.config
    rec, _, results = engine_phase(runner, phase, build_s=build_s, base_args=base_args,
                                   probe=lambda engine: runner.reset_counters())
    check(all(f == "length" and len(t) == N_OUT for t, f, _ in results),
          f"{phase}: a request did not finish `length` with {N_OUT} tokens")
    st = rec["stats"]
    mixed = "padded_prefill_dispatches" if cfg.is_mla else "ragged_mixed_dispatches"
    check(rec["fused_mixed"] and st[mixed] > 0, f"{phase}: no fused mixed plan: {st}")
    rec.update(ep_check_ranks(phase, runner, runner.rank_reports(), heads))
    rec["collective_host_share_rank0"] = rec["collective_host_s_rank0"] / rec["wall_s"]
    rec["transport"] = runner.group.transport
    rec["nvidia_smi"] = smi
    emit(rec)
    return rec


def ep_mesh_phase(ep1, phase: str, flags, smi, layers: int = 0, bias_seed=None):
    """One mesh of the MoE model: built through the worker's build_runner
    (`flags`, the preset at its DEPTH_CUTS depth or `layers`), its parity
    against `ep1` on the same seed-0 params (pinned to the mesh's routing,
    the free run beside it), the bucket probe, one fused turn; the ranks
    stopped after. `bias_seed`: DeepSeek-V3's selection bias drawn on
    every rank as on ep1."""
    from dynamo_tpu_torch.parallel.group import shutdown_followers

    model = ep1.config.name
    args = model_args(model) + list(flags)
    runner, cfg, build_s = timed_runner(args, cut=not layers, layers=layers)
    group, procs = runner.group, runner._procs
    try:
        check(runner.mesh_config.n_devices == group.size and cfg == ep1.config,
              f"engine_{phase}: mesh {runner.mesh_config} over {group.size} ranks, {cfg.name}")
        emit({"phase": f"{phase}_ranks", "mesh": list(runner.mesh_config.shape),
              "describe": runner.mesh_config.describe(), "transport": group.transport,
              "follower_pids": [p.pid for p in procs], "build_s": build_s, "nvidia_smi": smi})
        if bias_seed is not None:
            sums = group.run_on_ranks(set_router_bias, bias_seed)
            check(len(set(sums)) == 1, f"engine_{phase}: selection biases differ {sums}")
        _, table = tp_parity(ep1, runner, smi, f"ep_parity_{phase}", greedy_steps=0,
                             labels=("ep1", phase))
        ep_buckets(runner, phase, table, smi)
        heads = cfg.n_kv_heads // runner.mesh_config.model
        return ep_turn(runner, phase, build_s, args, heads, smi)
    finally:
        runner.close()
        codes = shutdown_followers(group, procs)
        gc.collect()
        torch.cuda.empty_cache()
        check(codes == [0] * len(procs), f"engine_{phase}: followers exited {codes}")


def ep_fit_phase(smi):
    """The fit check's verdicts with nothing drawn: qwen3-30b-a3b at its 48
    layers at EP 2 (each rank ~35 GB with 2048 pages) against this card,
    and DeepSeek-V3 at 61 layers at EP 2, refused before any spawn."""
    from dynamo_tpu_torch.parallel.group import tp_check_fits
    from dynamo_tpu_torch.parallel.mesh import MeshConfig

    dev = torch.device("cuda", 0)
    before = torch.cuda.memory_allocated()
    cfg = get_config(EP_MOE_MODEL)
    kw = dict(config=cfg, num_pages=2048, page_size=PAGE_SIZE, dtype=torch.bfloat16)
    try:
        tp_check_fits(MeshConfig(expert=2), dev, kw)
        verdict = "fits"
    except MemoryError as e:
        verdict = str(e)
    try:
        build_runner(parse_args(model_args("deepseek-v3") + ["--expert-parallel", "2"]))
        refused = None
    except MemoryError as e:
        refused = str(e)
    check(refused is not None and "2 rank(s) on this device" in refused,
          f"ep_fit: DeepSeek-V3 at EP 2 not refused by the fit check: {refused}")
    check(torch.cuda.memory_allocated() == before, "ep_fit: memory was allocated")
    rec = {"phase": "ep_fit", "qwen3_30b_a3b_48_layers_ep2": verdict,
           "qwen3_rank_gb": weights.serving_bytes(cfg, 2048, PAGE_SIZE, ep=2) / 1e9,
           "free_gb": torch.cuda.mem_get_info(dev)[0] / 1e9,
           "deepseek_v3_ep2": refused, "nvidia_smi": smi}
    emit(rec)
    return rec


def engine_ep_phases(smi):
    """Expert and data parallelism on the card, with nothing else on it:
    qwen3-30b-a3b at 8 layers at EP 2, EP 2 x TP 2 and DP 2 x EP 2 beside
    one EP 1 runner on the same seed-0 params; then DeepSeek-V3's first
    MoE layer (MLA_MOE_CONFIG) at EP 2 beside its EP 1 runner; then the
    fit verdicts. Returns the phases' seconds."""
    from types import SimpleNamespace

    t0 = time.monotonic()
    ep1, cfg, _ = timed_runner(model_args(EP_MOE_MODEL), cut=True)
    check(cfg.n_layers == DEPTH_CUTS[EP_MOE_MODEL] and ep1.moe_layers == cfg.n_layers,
          f"engine_ep: {cfg.name} at {cfg.n_layers} layers")
    for phase, flags in EP_MESHES:
        timed(f"engine_{phase}", ep_mesh_phase, ep1, phase, flags, smi)
    free(ep1)
    del ep1
    # DeepSeek-V3's three dense layers and first MoE layer: the EP 1
    # runner (30 GB) stays on the card, and the ranks' fit check counts it
    ep1 = ModelRunner(MLA_MOE_CONFIG, num_pages=2048, page_size=PAGE_SIZE,
                      max_pages_per_seq=4096 // PAGE_SIZE)
    set_router_bias(SimpleNamespace(runner=ep1), 6)
    timed("engine_ep_mla_moe", ep_mesh_phase, ep1, "ep_mla_moe",
          ("--expert-parallel", "2"), smi, MLA_MOE_CONFIG.n_layers, 6)
    free(ep1)
    del ep1
    ep_fit_phase(smi)
    seconds = time.monotonic() - t0
    emit({"phase": "ep_seconds", "seconds": seconds})
    return seconds


def main() -> int:
    only = []
    if sys.argv[1:2] == ["--only"]:
        only = sys.argv[2].split(",")
        if only != ["tp"]:
            print(f"chip_smoke: --only takes `tp`, not {only}", file=sys.stderr)
            return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.monotonic()
    _build.load()
    ptxas = {stem: ptxas_lines(log) for stem, log in _build.build_log.items()}
    # the GQA kernels' instantiations (D 64 / 96 / 128 / 256, soft cap 0 / 1)
    gqa_ptxas = {stem: ptxas_entries(_build.build_log[stem])
                 for stem in GQA_STEMS if stem in _build.build_log}
    # the int8 decode kernel's instantiations (D x soft cap)
    int8_decode = {k: v for k, v in gqa_ptxas.get("paged_attention", {}).items()
                   if k.startswith("decode_codes_kernel")}
    # the MLA kernels (int8 decode: mla_decode_codes_kernel), and ptxas's
    # notes on their wgmma products
    mla_log = _build.build_log.get("mla_attention", "")
    mla_ptxas = ptxas_entries(mla_log)
    wgmma_notes = [ln.strip() for ln in mla_log.splitlines() if "wgmma" in ln]
    emit({"phase": "build", "seconds": time.monotonic() - t0, "ptxas": ptxas,
          "gqa_kernels": gqa_ptxas, "int8_decode_kernels": int8_decode,
          "mla_kernels": mla_ptxas, "mla_wgmma_notes": wgmma_notes})

    try:
        # the MLA kernels sit at the register cap of one block an SM
        spills = [ln for ln in ptxas.get("mla_attention", [])
                  if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
        check(not spills, f"MLA kernels spill: {spills}")
        # int8 MLA decode is a kernel of its own
        check(any("mla_decode_codes_kernel" in k for k in mla_ptxas) or not mla_log,
              f"no int8 MLA decode kernel among {sorted(mla_ptxas)}")
        # nor may the grouped GEMM's entries (a spilled accumulator would
        # leave the wgmma registers for local memory)
        spills = [ln for ln in ptxas.get("moe_grouped_gemm", [])
                  if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
        check(not spills, f"grouped GEMM spills: {spills}")
        # nor the weight-only GEMM's (its accumulators would leave registers)
        spills = [ln for ln in ptxas.get("quant_gemm", [])
                  if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
        check(not spills, f"weight-only GEMM spills: {spills}")
        # nor the int8 decode kernel at any head dim (8 instantiations)
        check(len(int8_decode) == 8 or "paged_attention" not in gqa_ptxas,
              f"int8 decode instantiations: {sorted(int8_decode)}")
        check(all(v.get("spill_stores", 1) == 0 and v.get("spill_loads", 1) == 0
                  for v in int8_decode.values()), f"int8 decode kernels spill: {int8_decode}")
        # ptxas keeps the ragged bodies at 128-211 registers (three or four
        # 128-thread blocks an SM), and a few int8 ones (D 64, D 128
        # plain) spill 8-16 bytes; builds that do not spill ran 10-25%
        # slower (scripts/int8_body_variants.py --min-blocks, PERF.md)
        # D 256: O alone is 128 registers a thread; no instantiation spills
        # (decode 4 bodies + the bf16 and int8 merges, prefill 8, ragged 8 +
        # merge: bf16 and int8 each)
        d256 = {f"{stem}:{k}": v for stem, ents in gqa_ptxas.items()
                for k, v in ents.items() if "<256" in k}
        check(len(d256) == 23 or len(gqa_ptxas) < len(GQA_STEMS),
              f"GQA D 256 instantiations: {sorted(d256)}")
        check(all(v.get("spill_stores", 1) == 0 and v.get("spill_loads", 1) == 0
                  for v in d256.values()), f"GQA D 256 kernels spill: {d256}")
        if only == ["tp"]:  # tensor parallelism alone (a quicker check)
            kern = timed("tp_kernels_phase", tp_kernels_phase, dev)
            launches, _ = timed("engine_tp_phase", engine_tp_phase, smi)
            gc.collect()
            torch.cuda.empty_cache()
            timed("engine_ep_phases", engine_ep_phases, smi)
            return finish(t0, kern, launches, {}, TP_SHARDED, smi, kind, count)
        kern = timed("kernel_phase", kernel_phase, dev)
        timed("shapes_phase", shapes_phase, dev)
        kern.update(timed("copy_kernel_phase", copy_kernel_phase, dev))
        kern.update(timed("tier_codec_phase", tier_codec_phase, dev))
        kern.update(timed("mla_kernel_phase", mla_kernel_phase, dev))
        timed("decode_split_edges_phase", decode_split_edges_phase, dev)
        gem = timed("gemma_kernels_phase", gemma_kernels_phase, dev)
        kern.update(timed(
            "int8_kernels_phase", int8_kernels_phase, dev,
            {name: kern[name]["device_ms"]
             for name in GQA_KERNELS + ("decode_mla_attention",)},
            gem["D256_G2"]["cases"]["gemma2"]))
        del gem
        head = timed("head_shape_kernels_phase", head_shape_kernels_phase, dev)
        kern.update(timed("moe_kernels_phase", moe_kernels_phase, dev))
        kern.update(timed("quant_kernels_phase", quant_kernels_phase, dev))
        # this slice's kernels: the sharded wrappers at a TP 2 rank's shapes
        kern.update(timed("tp_kernels_phase", tp_kernels_phase, dev))
        gc.collect()
        torch.cuda.empty_cache()
        verify_rec = timed("verify_shape_phase", verify_shape_phase, dev)
        runner, launches, bodies, fused_rec, streams = timed("engine_phases", engine_phases, dev)
        variants = {name: {"engine_fused": bodies[name]} for name in GQA_KERNELS}
        variants["prefill_paged_attention"]["verify_B8_S5"] = verify_rec
        # this slice's paths: the device ring against the host scan, tree
        # speculation, and draft-model speculation on the 3B's params
        timed("draft_ring_phase", draft_ring_phase, runner, streams)
        timed("tree_phase", tree_phase, runner)
        draft_self = timed("draft_phases", draft_phases, runner, streams, fused_rec)
        # this slice's paths: the 3B's params as an HF checkpoint served
        # through --checkpoint (and a self-draft from --draft-checkpoint),
        # the three restart tiers as worker processes, rl update_weights
        timed("checkpoint_phases", checkpoint_phases, runner, streams["fused"], fused_rec, draft_self, smi)
        del streams
        # each copy kernel's launches from the phase that runs it
        disagg, disagg_rec = timed("disagg_phase", disagg_phase, runner.params)
        launches["gather_pages"] = disagg["gather_pages"]
        launches["scatter_pages"] = disagg["scatter_pages"]
        tier_launches = timed("tiers_phase", tiers_phase, runner.params)
        for name in ("scatter_pages_layers", "tier_quantize", "tier_dequantize"):
            launches[name] = tier_launches[name]
        timed("parity_phase", parity_phase, runner, dev)
        # this slice's paths: the sync guard, the anomaly trigger and its
        # profile window, the hooks' costs, and the hardware sweep
        timed("observability_engine_phase", observability_engine_phase, runner, dev, smi)
        timed("hw_profile_phase", hw_profile_phase, runner, smi)
        # earlier slices' paths: sampling extras, guided decoding, branches
        timed("extras_phases", extras_phases, runner, smi)
        # multi-LoRA on the 3B's params: the padded path with adapters
        timed("lora_phases", lora_phases, runner, dev, smi)
        # the request plane: the in-process streams served one at a time,
        # the disaggregated pair over TCP, then (this process's runners
        # freed) the worker as a process of its own
        in_process = timed("alone_phase", alone_phase, runner)
        timed("served_disagg_phase", served_disagg_phase, runner.params, disagg_rec)
        V = runner.config.vocab_size
        del runner, disagg
        gc.collect()
        torch.cuda.empty_cache()
        served_rec = timed("served_phase", served_phase, in_process, fused_rec, V)
        # the frontend: two worker processes behind the HTTP frontend
        timed("frontend_phase", frontend_phase, in_process, V, served_rec, smi)
        # LoRA adapters served as models, filtered routing, a runtime load
        timed("lora_served_phase", lora_served_phase, smi)
        # this slice's path: llama-3.1-8b at TP 2, two rank processes on the
        # card, with nothing else on it
        tp_launches, tp_bodies = timed("engine_tp_phase", engine_tp_phase, smi)
        launches.update(tp_launches)
        for name in ("decode_paged_attention_sharded", "prefill_paged_attention_sharded",
                     "ragged_paged_attention_sharded"):
            variants[name] = {f"engine_{ph}": b[TP_INNER[name]]
                              for ph, b in tp_bodies.items()}
        gc.collect()
        torch.cuda.empty_cache()
        # this slice's paths: MoE models over expert, tensor and data ranks
        timed("engine_ep_phases", engine_ep_phases, smi)
        gc.collect()
        torch.cuda.empty_cache()
        # the slice's main path: llama-3.1-8b over int8 pools; each int8
        # entry's launches are the fused phase's (all on its int8 body)
        int8_launches, int8_bodies = timed("int8kv_phases", int8kv_phases, dev, smi)
        for name in GQA_KERNELS:
            launches[f"{name}_int8"] = int8_launches[name]
            variants[f"{name}_int8"] = {f"engine_{phase}": b[name]
                                        for phase, b in int8_bodies.items()}
        del int8_launches
        gc.collect()
        torch.cuda.empty_cache()
        # weight-only quantization: llama-3.1-8b int8, llama-3.2-3b fp8
        launches.update(timed("quant_phases", quant_phases, dev, smi))
        gc.collect()
        torch.cuda.empty_cache()
        mla, mla8 = timed("mla_phases", mla_phases, dev)
        for name in MLA_KERNELS:
            launches[name] = mla[name]
        launches["decode_mla_attention_int8"] = mla8["decode_mla_attention"]
        del mla, mla8
        gc.collect()
        torch.cuda.empty_cache()
        found = timed("gemma_phases", gemma_phases, dev, smi)
        gc.collect()
        torch.cuda.empty_cache()
        # this slice's paths: qwen2.5-7b (G 7), phi-3 (D 96, window 2047,
        # bf16 and int8) and the other families; the head-shape entries'
        # launches are their engines' fused phases'
        q_launches, q_bodies = timed("qwen2_phases", qwen2_phases, dev, smi)
        p_launches, p8_launches, p_bodies = timed("phi3_phases", phi3_phases, dev, smi)
        found.update(q_bodies)
        found.update(p_bodies)
        found.update(timed("families_phase", families_phase, dev, smi))
        gc.collect()
        torch.cuda.empty_cache()
        # MoE, with nothing else on the card (qwen3-30b-a3b: 57 GiB of
        # weights); the grouped GEMM's launches are engine_qwen3moe's
        moe_launches, moe_bodies = timed("qwen3moe_phases", qwen3moe_phases, dev, smi)
        found.update(moe_bodies)
        for name in MOE_KERNELS:
            launches[name] = moe_launches[name]
        gc.collect()
        torch.cuda.empty_cache()
        timed("mla_moe_phases", mla_moe_phases, dev, smi)
        gc.collect()
        torch.cuda.empty_cache()
        # mixtral-8x7b at 8 layers on int8 weights, with nothing else on
        # the card; the grouped GEMM's int8 entries' launches are its
        mix_launches = timed("mixtral_phases", mixtral_phases, dev, smi)
        for name in MOE_KERNELS:
            launches[f"{name}_int8"] = mix_launches[name]
        for phase, b in found.items():
            for name in GQA_KERNELS:
                key = f"{name}_int8" if "int8" in phase else name
                variants[key][f"engine_{phase}"] = b[name]
        short = dict(zip(GQA_KERNELS, ("decode", "prefill", "ragged")))
        for name in GQA_KERNELS:
            for key, shape, pools, n in (
                    (f"{name}_G7", "qwen2_G7_D128", "bf16", q_launches),
                    (f"{name}_D96_window", "phi3_G1_D96", "bf16", p_launches),
                    (f"{name}_D96_int8_window", "phi3_G1_D96", "int8", p8_launches)):
                kern[key] = head[shape][pools][short[name]]
                launches[key] = n[name]
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    # the head-shape entries: qwen2.5-7b's G 7 and phi-3's D 96 bodies
    head_sources = {}
    for name in GQA_KERNELS:
        head_sources[f"{name}_G7"] = SOURCES[name]
        head_sources[f"{name}_D96_window"] = SOURCES[name]
        head_sources[f"{name}_D96_int8_window"] = INT8_SOURCES[f"{name}_int8"]
    sources = {**SOURCES, **INT8_SOURCES, **head_sources, **QUANT_SOURCES,
               **TIER_CODEC_SOURCES, **TP_SHARDED}
    return finish(t0, kern, launches, variants, sources, smi, kind, count)


def finish(t0, kern, launches, variants, sources, smi, kind, count) -> int:
    """The total, the kernels line, the card's name and power limit, and
    the last line."""
    emit({"phase": "total", "seconds": time.monotonic() - t0})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         **{k: kern[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")},
         **({"variants": variants[name]} if name in variants else {})}
        for name in sources
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
