#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hirest_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # needs one CUDA GPU and nvcc
    python3 chip_smoke.py --kernels-only  # build and kernels phases only
    python3 chip_smoke.py --parallel-only  # the parallel phase alone
    python3 chip_smoke.py --time-attention  # K1, K3, K6-K9 ms alone
    python3 chip_smoke.py --time-mlp        # K4 and its _int_mm pair alone
    python3 chip_smoke.py --time-rows       # K2, K5, K10 ms alone
    python3 chip_smoke.py --time-f32        # the f32 forms ms alone
    python3 chip_smoke.py --time-epilogue   # E1, E2 and six forwards alone
    python3 chip_smoke.py --time-int8-gemm  # G1 and six int8 forwards alone

--time-attention times K1 and K3 (head widths 88 and 128; K1 also at 192
tokens, one 192-row query tile a head), K9 (bf16 and int8 out, int8 also at
128), K6 (also at ViT-B/32's d = 64), K7 and K8 (bf16 and int8 out),
beside scaled_dot_product_attention; where K3 has its cluster epilogue,
also K3's two-step epilogue and each cluster variant forced, with
cudaOccupancyMaxActiveClusters and the variant the launch takes; where K8
runs on attention_qkv3.cu's v1 form, the same for K8 int8; then each head
width's bounds and the six forwards K6, K7 and K8 run in (ladder bf16,
int8 dyn and int8+fq; the unrolled, padded unrolled and unrolled int8
towers: frames/s and one profiled forward each); and nothing else, so a
copy of this file run from a `git archive` of an earlier commit times
that commit's kernels: run parent, change, change, parent in one call to
compare two trees on one card. --time-mlp does the same
for K4 at B=128 (through fused_mlp_int8, which every version of the port
has), beside its two products as torch._int_mm; where the checkout splits
K4 into two kernels it also times the first alone. --time-rows does the
same for K2, K5 (gelu_bf16_poly at 6144, none at 1408) and K10 beside
F.layer_norm and a clone of K10's bytes, E4 (row_quant) at [M, 1408],
[M, 6144], the patch rows and the head rows beside its bound and K5 none,
and K5 on the fc1 outputs of an
int8+fq+v3 forward; it first runs row_checks (each case's codes that
differ from the plain version), then measures where K2's time spreads
(the clocks, the kernel's own time against the host's, x in L2 or
not) and prints the row kernels' SASS counts. --time-f32 does the same
for the f32 forms (the f32 attention body in each wrapper, its int8-out
forms, K2, K5 and K10 on f32 rows, K4 with an f32 residual) beside SDPA
in f32, a form the checkout lacks printed as such, with the f32 body's and
the f32 row forms' registers, the body's wgmma serialisations and TF32
HGMMA count in its SASS, K3 f32's device time split into the body and the
row pass, and the body's per-tile trace (a -DHIREST_F32_TRACE=1 build).
--time-epilogue times E1 and E2 (ops/epilogue.py, csrc/epilogue.cu) at
B=128 in bf16 and f32 beside their plain chains, their bounds and F.gelu
on the same bytes, then six full-width forwards (production bf16 and
int8, padded scanned, ladder bf16, int8 dyn, bf16+v3+lnk in f32): frames/s
and one profiled forward's groups each. In a checkout without
ops/epilogue.py it says so and times the plain chains alone, so parent,
change, change, parent in one call compares the two trees.
--time-int8-gemm prints G1's registers and spills (ptxas), each variant's
shared memory, ring stages and the clusters the card holds at once
(cudaOccupancyMaxActiveClusters), holds every variant bit for bit against
int8_mm_ref (as the kernels phase does), then times G1 at every product
it takes over beside its bound, torch._int_mm alone, torch._int_mm + E3
(the chain before G1) and the plain version, each variant forced in
turns (every variant, then every variant again in reverse order), then
the short products (the head at B = 128 and 2, one frame's qkv and fc2)
in CUDA graphs (device time without the host's enqueue) in each variant,
then six full-width int8 forwards (production int8, the ladder's int8
dyn, int8+fq and int8+fq+v3, int8+fq+v3 in f32, the unrolled int8
tower): frames/s and one profiled forward's groups each. In a checkout
without csrc/int8_gemm.cu it says so and times torch._int_mm + E3 and
the forwards, and in one with an earlier G1 it times that G1's variants
unchecked, so parent, change, change, parent in one call compares the two
trees. tools/g1_probe.py probes the first G1 design (the epilogue in
series with the products) on the card.
The flags combine: one process runs each asked for.

Phases; any failure exits non-zero before the result line is printed:

1. build    compile every CUDA kernel of the port from this checkout, and
            attention_qkv3.cu again with -DHIREST_QKV3_TWO_STEP=1 (set-up);
            K4's two kernels', K1/K3's and K6/K7/K8's (attention_qkv3.cu's
            v3 and v1 forms), the f32 body's, K5's, K2/K10's,
            E1's and E2's, E3's and E4's, and G1's instantiations'
            registers, spills and shared memory.
2. kernels  each kernel's wrapper against its plain PyTorch version on the
            card, at the main paths' shapes: K1 and K3 (attention qkv
            [B, S, 4224] bf16; K3 also padded to S = 264 with n_real = 257;
            both again at the padded head width, [B, 257, 6144]; and both,
            at both widths, at the tiles' edges, their errors printed
            apart: 33 and 65 tokens, 592 (d = 88) and 432 (d = 128)
            tokens, 264 with n_real = 257 at B = 2 and 128), K4
            (fused_mlp_int8, [M, 1408] x 6144,
            both activations; its first kernel's codes and scales also
            against mlp_int8_hidden_ref, equal, at M = 1, 257, 2 x 257,
            64 x 257 and 128 x 257 with rows whose chunk maximum lies in
            each block of a cluster and all-zero rows), K6 (split heads
            [B, 16, 257, 88] as views of one qkv projection, and a masked
            [2, 12, 48, 64] over 20 keys)
            and K7 (packed [B, 257, 16 * 128], and a masked 48 x 20-key
            shape), each also with one batch row's keys all masked and
            with 33 queries over 600 keys (d = 88 masked, d = 128), K8
            (v1, [B, 257, 4224] with nonzero q/v biases, bf16 and
            int8 out; also [2, 257, 6144] at d = 128, [2, 600, 4224] and
            12 heads of 64, [2, 50, 2304], whose int8 epilogue is
            two-step), K9
            (v2, bf16 and int8 out, and int8 padded to S = 264 with
            n_real = 257), B = 2 and 128, M = 257 B; K3's cluster
            epilogue (16 heads: the heads of a row on one thread-block
            cluster) bit for bit, codes and scales, against the two-step
            epilogue of the same body (the -DHIREST_QKV3_TWO_STEP=1 build)
            through K3, K9 int8 and each cluster variant forced, at d = 88
            and 128, B = 2 and 128, 257 tokens, 264 with n_real = 257,
            and 33, 65 and 592 (d = 88) / 432 (d = 128) tokens, the
            counts of differing values printed, with what
            cudaOccupancyMaxActiveClusters gives each variant; K8 int8's
            cluster epilogue (the v1 form at 16 heads, nonzero biases) the
            same way through fused_attention_qkv and each variant forced,
            at d = 88 and 128, B = 2 and 128, 257 tokens, and 33, 65 and
            600 tokens; then
            row_checks: K2
            (ln_quant, [2 * 257 and M, 1408]), K5 (act_quant, [M, 6144]
            with both GELUs, [M, 1408] without one) and K10 (ln_bf16,
            [M, 1408]), each also at M = 1, 2, 257 and 5000 (not a
            multiple of the persistent grid's rows) with a row of zeros,
            K5 on rows whose quotients land on k + 1/2, and the row
            kernels' quotients y / s against PyTorch's IEEE division on every
            element; K5's and K10's f32 forms on f32 rows at the same shapes,
            edges, zero rows and k + 1/2 rows (K5 at K5's bars, K10 within
            1e-5 of each row's largest value) and at other widths. The f32
            body (attention_f32.cu, 3xTF32 on wgmma) through every
            wrapper, within 1e-5 of the largest output with TF32 off: K6
            at ViT-B/32's [B, 12, 50, 64] and EVA-g's [B, 16, 257, 88],
            K7 packed at d = 128, K1/K9's layout with n_real = 257 of 264
            (d = 88 and 128), K8's with nonzero biases, B = 2 and 128, one
            batch row's keys all masked, 33 queries over 600 keys, and its
            tiles' tails at d = 88 and 128 (65 rows and keys: one row in
            the second query tile, one key in the last key tile; K1/K9
            also 72 rows with n_real = 65); and bf16 K6 at ViT-B/32's
            [B, 12, 50, 64]. The f32 int8 factory's kernels at K3's and
            K2's bars: K3, K9 int8 and K8 int8 on f32 activations (the f32
            body with the int8 epilogue) at [B, 257, 3 * 16 * 88] and
            d = 128, K3/K9 also over 264 tokens with n_real = 257, K8
            biased, each also at the tails; K2 on f32 rows; K4 with an f32
            residual within 1e-6 of its contribution plus one f32 ulp.
            The projection epilogues (csrc/epilogue.cu), bf16 and f32, at
            [M, 6144], [M, 4224] and [M, 1408] for M = 32896, 1, 257 and
            5000: E1 with its bias and gelu_bf16_poly, exact GELU or no
            activation, E1 without a bias (int8 dyn's GELU) and E2, bit
            for bit against their plain versions, the exact GELU within
            one bf16 ulp of the largest value (f32: 1e-6 of it), the
            share of elements that differ printed; and the wrappers
            refusing f16 and non-contiguous tensors. The int8 products'
            epilogue and row quantizer (csrc/int8_epilogue.cu), bf16 and
            f32, bit for bit against their plain versions: E3 on the qkv
            projection [M, 4224] with and without its bias, out / fc2
            [M, 1408] with bias and residual, fc1 [M, 6144] and the head
            [M, 1024], for M = 32896, 1, 257 and 5000; E4 on rows of
            1408 and 6144 at those M and 257 rows into [300, C + 32]
            (codes wider than the row, rows past M), the unrolled tower's
            patch rows [B * 256, 588] into 592-wide codes and its head
            rows (the class tokens, 257 x 1408 apart), B = 128 and 2, with
            k + 1/2 quotients and a zero row, each on the kernel
            row_quant_route names (bf16: the ring, bar the patch rows;
            f32: row_quant_kernel) and counted there; K5 without
            an activation (what dyn_quant_rows launches) bit for bit
            against dyn_quant_rows' plain version at 1408 and 6144; and
            E3/E4 refusing what they do not take. G1 (int8_mm, the int8
            projections whole, csrc/int8_gemm.cu) bit for bit against
            int8_mm_ref in bf16 and f32 out: qkv with and without its bias
            [M, 1408] x 4224 and, at padded heads, x 6144; out with its
            residual (K = 1408 and 2048), fc1 (x 6144), fc2 (K = 6144) with
            its residual, the patch embedding [B * 256, 592] x 1408, for
            M = 32896 (an odd count of row tiles: the last cluster pair
            has one), 32768 (even), 1, 17, 257 and 5000; the head x 1024
            on class-token rows 257 x 1408 apart at B = 2 and 128; each
            in int8_gemm_config's choice and in every variant forced
            (clusters of two 128 x 256 tiles; split K, also at 2, 3, 5
            and 8 blocks on the head; f32 only, 128-wide tiles two blocks
            an SM), with each variant's shared memory, ring and the
            clusters the card holds printed first; and G1 refusing what
            its shape rule refuses.
3. main     the extraction encoder at full EVA-g width (40 layers, 1408 wide,
            seeded random weights): make_eva_encoder(device="cuda"), bf16 and
            int8=True, each with the float and the uint8 front end, a few
            synthetic videos through the per-video finish of
            extract_video_features. Every launch count is zeroed before each
            precision's run and read after it: per forward, the bf16 path
            launches K1 40 times and E1 and E2 80 times each (the qkv
            bias and fc1's bias + GELU; proj's and fc2's bias + residual)
            and no other kernel; the int8 path launches K2 and G1 (the qkv
            and out products) 80 times each, K3 and K4 40 times each,
            and no other. torch._int_mm is counted too: 0 calls on CUDA
            tensors in every forward of every phase (count_int_mm).
4. factory  build_eva_model_and_transforms(device="cuda") at full width
            (text 12 x 768, vision 40 x 1408; one draw of seeded random
            weights shared by every build): encode_text on 512 prompts, and
            encode_image at B = 128 unrolled (scan=False: 40 K6 a forward),
            padded unrolled (40 K7), padded scanned (40 K1 at head width
            128, 80 E1, 80 E2) and padded scanned int8 (80 K2, 40 K3 at
            128, 40 K4, 80 G1), each with the counts zeroed before and
            read after, and no other
            kernel launched; then the unrolled int8 tower
            (models/eva_quant.py::build_int8_vision_apply, every dense
            layer int8, with and without quant_attention) on the same
            weights and frames: 40 K6, 162 G1 and 162 E4 a forward (82
            without quant_attention; E4 on the ring but for the patch
            rows, one row_quant_kernel) and nothing else, cosine >= 0.98 to
            the float unrolled tower at full depth.
5. ladder   the kernel flag configurations of build_scanned_vision_apply
            (bench.py's ladder without its TPU layout flags) at full width
            on one staged bf16 and one staged int8 tower: bf16 (v1, K8;
            E1 once and E2 twice a layer), bf16+v2 (K9), bf16+v3+lnk (K1,
            K10; E1 and E2 twice a layer each), int8 dyn (K8, E1 once a
            layer, K5 without an activation four times), int8+fq (K2, K5,
            K8 int8), int8+fq+v2 (K2, K5, K9 int8) and int8+fq+v3 (K2,
            K3, K5), the int8 ones with G1 four times a layer, two
            forwards each with the counts zeroed before
            and read after; each one's 2-layer cut on the card against the
            CPU f32 path with the same flags.
6. depth    the same weights cut to 2 layers, on the card in bf16 against the
            plain path on the CPU in f32: bf16 vs float at cosine >= 0.99;
            int8 vs int8 at >= 0.99 and int8 vs float at >= 0.98; the text
            tower, the unrolled tower, and the padded unrolled and padded
            scanned towers against the unpadded CPU paths at >= 0.99; the
            unrolled int8 tower (both quant_attention) against its own CPU
            f32 path at >= 0.99 and the float unrolled one at >= 0.98, and
            with quant_attention in f32 on the card (2 K6, 10 G1 and 10 E4
            f32) at the same bars. Then the f32 paths, 2 layers, card against CPU within 1e-5 of
            the largest value: build_eva_model_and_transforms(dtype=
            torch.float32) scanned (2 K1 f32; E1 and E2 f32 where the
            bf16 block runs them) and unrolled (2 K6 f32),
            padded unrolled (K7 f32) and padded scanned (K1 f32 at
            d = 128), the scanned forward's v1 (K8 f32) and v2 (K9 f32),
            each with its launch counts, and the text tower. Then the f32
            int8 paths, 2 layers, against the CPU's f32 int8 path with
            the same flags at cosine >= 0.99 and its f32 float path at
            >= 0.98: build_eva_model_and_transforms(int8=True, dtype=
            torch.float32) (2 K2, 1 K3, 1 K4, 2 G1 f32 a layer) and the
            scanned
            forward's int8 + fused_quant + fused_mlp with v1 (K8 int8 f32)
            and v2 (K9 int8 f32), 2 G1 f32 a layer. Then five ladder
            configurations in f32, 2 layers, against the CPU's f32 path
            with the same flags: bf16+v3+lnk (K1 f32, 2 K10 f32 a layer)
            within 1e-5; int8 dyn (K8 f32, 4 K5 f32), int8+fq (2 K2, K5,
            K8 int8 f32), int8+fq+v2 (K9 int8) and int8+fq+v3 (K3), 4 G1
            f32 a layer each, at cosine >= 0.99, and >= 0.98 against the
            f32 float path; launch counts exact. After the ladder's cuts,
            bf16+v3+lnk and int8+fq+v3 in f32 at full width and depth on
            one staged f32 tower each: a warm-up and two timed forwards of
            B = 128, launch counts exact, frames/s, one profiled forward's
            device time by group of kernels (K5 f32 and K10 f32 their own),
            int8 at cosine >= 0.98 to float; each f32 phase's seconds.
            Then the production int8 encoder (int8+fq+v3+fm), the
            ladder's int8 dyn, int8+fq and int8+fq+v3, and the unrolled
            int8 tower at full width and depth, each twice on the same
            frames: as built, and with the plain versions of G1, E4 and
            dyn_quant_rows patched in (plain_int8_kernels): the outputs
            bit for bit equal, torch._int_mm called only by the plain
            versions.
7. timing   frames/s at B=128 for every encoder, factory and ladder
            forward, text prompts/s, and each kernel's ms per call beside
            its plain version, one library call computing the same function
            (or its int8 products, for K4; SDPA in f32 for the f32 body),
            and the card's bound (E3 and E4 also beside a same-bytes
            reference: acc.to(dtype), a clone of the rows; G1 at every
            product it takes over, beside torch._int_mm alone and
            torch._int_mm + E3); the
            unrolled int8 tower's frames/s and one profiled forward of
            each.
8. profile  where one forward's device time goes, by group of kernels, and
            the device's idle share, for each precision, the unrolled
            towers and the ladder's bf16, int8 and int8+fq (K8) and
            int8+fq+v3 (K5) forwards, G1 and E4 groups of their own; the
            production int8, int8+fq and int8+fq+v3 forwards must run no
            quant_rows_kernel and no memset (K3's and K8's epilogues in
            the kernel);
            each plain per-layer op timed alone.
9. serving  the serving path at full width over phase 3's int8 features
            (written as .npy): the engine as `python -m
            hirest_tpu_torch.serve` builds it on the card (EVA-CLIP-g text
            tower 12 x 768, MomentModel at JointModelConfig(), seeded
            random weights, 5 beams of 48 words, f32), warmup, then
            retrieve and analyze on every video, directly and through the
            HTTP server on 127.0.0.1, port 0, and analyze again with
            fused_segmentation, with every launch count 0 during the
            requests (the serving path runs no kernel of the port, as the
            JAX one runs no Pallas kernel); bounds inside the video, steps
            sorted; p50/p95 of retrieve and analyze over 20 rounds (each
            prompt retrieved, each video analyzed in both segmentation
            modes, one after the other), pooled and per video; analyze's
            split (text encode, moment retrieval, segmentation iterations,
            beam decode, host rest) over 5 requests a video, and one
            request's device time and idle share from the profiler, in
            each mode. Then one analyze request a video and prompt against
            the port's CPU f32 engine, within 1e-5 of the CPU value's
            largest magnitude: moment-retrieval and segmentation logits,
            the served captioning batch's caption_encode, and each
            decode_step of the CPU's beam replayed on the card from the
            CPU's inputs; bounds equal; the two beams make the same choice
            at every step (a choice may differ only where the CPU's
            candidates lie closer than the measured differences can move
            them, and then the caption is not held), and end on the same
            captions. The served (cached) beam against the full re-decode
            beam on the card: the full decoder's logits at the served
            prefixes within 1e-5, and the same choices and captions.
10. asr      the ASR path at full width (Whisper small.en: 12 + 12 layers
            x 768, 12 heads, vocabulary 51864; MiniLM-L6: 6 x 384; seeded
            random weights, f32, TF32 off) on 45 s of seeded 16 kHz audio
            written as a .wav (two 30 s windows), with a made-up byte-level
            vocab.json/merges.txt over ids 0-50256: transcribe_audio_dir_torch
            under the default DecodeOptions (5 temperatures, best_of 5,
            224 steps), then embed_srt_dir with MiniLM; each window's encoder
            output against the CPU f32 encoder, and every decode_step of
            the first window against the CPU f32 decoder fed the card's
            inputs (its encoder output and tokens; one uncached CPU forward
            a decode), logits within 1e-5 of the largest; the greedy mode
            end to end,
            and its greedy_decode tokens against the CPU's wherever the top-2
            margin exceeds the measured error; MiniLM's embeddings against
            the CPU's within 1e-5; the SRT and [n_segments, 384] .npy well
            formed; those features beside phase 3's int8 ones into a Trainer
            with JointModelConfig(asr_dim=384) and run_end_to_end, its JSON
            well formed; no port kernel launched throughout; readings (the
            real-time factor, encoder ms a window, ms a step split into the
            step and the host rules, steps and temperatures a window, one
            decode_segment's device time and idle share, MiniLM
            sentences/s); then the custom-video EVA step as run_custom_video
            chains it (make_eva_encoder(uint8_frontend=True), batches of 64
            uint8 frames): 40 K1, 80 E1 and 80 E2 a forward, [45, 1024]
            unit-norm features.
            It names the host decoders (cv2, Pillow, ffmpeg, openai-whisper)
            the machine lacks; it decodes no mp4.
11. training the training path at JointModelConfig()'s width (768 hidden,
            2 + 2 layers, vocabulary 30522, 48 words, train_batch_size 32)
            on a synthetic split written to a temp dir (the reference JSON
            schema, all three tasks, train/val/test, seeded random
            features, a made-up 30522-entry vocab.txt): (a) one step a task
            in f32, dropout and TF32 off, on the card against the port's
            CPU trainer on the same batch: the loss within 1e-5 relative,
            every gradient within 1e-5 of its tensor's largest magnitude
            (those zero in exact arithmetic, the key biases and what the
            segmentation softmax ignores, at noise: <= 1e-6 of the largest
            gradient), and the optimizer fed the CPU's gradients giving
            the CPU's parameters within 1e-6; (b) `python -m
            hirest_tpu_torch.run --train`'s function for 2 epochs with
            dropout live: finite losses, BEST.pt and LAST.pt, well-formed
            test JSONs; (c) a fresh trainer loaded from a mid-run LAST:
            step, epoch, model and optimizer state bit for bit, the next
            step (dropout off) within 1e-6 of the unbroken run's; (d) 30
            steps on one fixed batch lower each task's loss; (e) no port
            kernel launched; (f) steps/s a task, one step's device time
            and idle share, peak memory.
12. eval     the evaluation and zero-shot retrieval entry points at full
            width on seeded random weights, in a temp directory laid out as
            a user's (pretrained_weights/ViT-B-32.pt, eva_clip_psz14.pt
            from the factory's weights, bertscore.bin at bert-base width,
            nli/ at bert-base width as model.safetensors; a split of 8
            prompts, 16 test and 16 negative videos with JPEG frames and
            features): inference_video_retrieval's flow for clip --raw_frame
            (f32: 12 K6 f32 a forward; --fp16: 12 K6), clip_g from
            features (no kernel), clip_g --raw_frame (bf16: 40 K6; f32 on
            a 2-prompt split: 40 K6 f32), every other count 0, and its
            main(argv) once; ViT-B/32 embeddings and scores and the EVA
            text tower at full depth against the CPU f32 port within 1e-5;
            bf16 embeddings at cosine >= 0.99 to f32; then `python -m
            hirest_tpu_torch.evaluate`'s main for the four tasks on the
            card and with --device cpu (moment segmentation with
            --preprocess_moment_bounds; step captioning with CLIPScore,
            BERTScore and the NLI cross-encoder): host metrics equal,
            CLIPScore and BERTScore within 1e-5, NLI labels equal wherever
            the CPU's top-2 margin exceeds the measured error; readings:
            videos/s a run, CLIPScore ms a step and one step's idle share,
            BERTScore and NLI pairs/s. (The EVA-g vision tower's f32
            card-vs-CPU check is phase 6's 2-layer cut.)
13. parallel data and tensor parallelism (parallel/, Trainer under
            mesh_shape) at JointModelConfig()'s width, f32, TF32 off, on
            phase 11's synthetic split (a deterministic text feature
            instead of the text tower): 3 training steps a task with
            dropout live (lr 1e-4, no warmup, clipping at 1.0), then the
            test split's predictions, on the card in one process and on
            two ranks on the one card over gloo (CUDA tensors; a file
            init_method), as data:2 and as model:2: each step's loss and
            gradient norm within 1e-6 relative, the parameters within
            1e-5 of each tensor's largest magnitude (bar those zero in
            exact arithmetic), bounds and segmentations equal, captions
            equal or a tie (same_selections); then `python -m
            torch.distributed.run --standalone --nproc_per_node=1 -m
            hirest_tpu_torch.run --train --mesh_shape data:1` over NCCL,
            its checkpoints and test JSONs; where the machine has two
            cards, the two-rank check over NCCL, one card a rank, and on
            four cards data:2,model:2 over NCCL.
            Readings: steps/s and all-reduce ms a step (gloo stages CUDA
            tensors through the host: no NCCL time).
14. bench    `python -m hirest_tpu_torch.bench` in six processes, one after
            the other: the ladder (eight configurations at B = 128),
            --latency, --vr, --e2e, --unrolled --bf16 and --unrolled
            --int8. Each must exit 0 and end in its metric's line with
            its unit and a value > 0; a frames/s line's mfu in (0, 1] and
            equal to value x the useful FLOP a frame over the card's peak,
            and its tag one the bench names. The ladder must print all
            eight tags' frames/s, bf16+v3 and int8+fq+v3+fm within 15 %
            of the timing phase's production bf16 and int8 encoders on
            float frames; the other tags are printed beside the timing
            phase's ladder readings.

Then it prints the card's name and power limit, one JSON line of kernels and,
last, {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH = 128  # frames per forward on the main path
TOKENS = 257  # EVA-g tokens per frame (16 x 16 patches and the class token)
PADDED_HD = 16 * 128  # the padded heads' width (models/eva_pad.py)
PROMPTS = 512  # text prompts through encode_text, in batches of BATCH
TEXT_BATCH = 256  # prompts per encode_text call when timed
FACTORY_FORWARDS = 2  # image forwards of B=128 per factory configuration
# synthetic videos: frame count and duration in seconds (truncation target)
VIDEOS = {"vid_a": (200, 199.6), "vid_b": (90, 88.4), "vid_c": (17, 17.0)}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
INT8_OP_PER_S = 1979e12  # dense int8 tensor-core peak
TF32_FLOP_PER_S = 494.7e12  # dense TF32 tensor-core peak
F32_TOL = 1e-5  # the f32 attention body and f32 paths: of the largest |value|
# f32 issue slots: 132 SMs x 4 schedulers x 32 lanes at the 1.98 GHz boost
# clock. __fmul_rn / __fadd_rn issue one slot each, never paired as FMAs.
ISSUE_SLOTS_PER_S = 132 * 4 * 32 * 1.98e9
# The issue slots a value that each row kernel's function needs (K2, K5,
# K10; PERF.md §2), counted from the arithmetic, not from a build: the bf16
# widening 1; gelu_bf16_poly 22 (gelu.cuh: 11 FMUL, 7 FADD, 4 FMNMX); the
# LayerNorm 7 (the sum, the centring, the square and its sum, x r g + b);
# the int8 quantization 5.75 (|y|'s max, y / s in three instructions, the
# rounding, four codes packed by three); bf16 out 0.5 (two values a
# pack). A row's reductions and scale, once a row, are left out.
ROW_SLOTS = {"K5 gelu_poly": 1 + 22 + 5.75, "K5 none": 1 + 5.75,
             "K2": 1 + 7 + 5.75, "K10": 1 + 7 + 0.5}
COS_MIN = 0.99
COS_INT8_VS_FLOAT = 0.98  # the JAX package's int8 bar (test_eva_scan.py:57)
EPS = 1e-6


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def gpu_name_and_power() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms, its `iters` calls captured in one
    CUDA graph and replayed (after a warm-up call): launches back to back,
    without the host's enqueue time between them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def bound(moved_bytes: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    bytes_ms = moved_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def tf32x3_bound(moved_bytes: float, flops: float) -> dict:
    """The f32 attention body's bound: each of its f32 products is three
    TF32 products on the tensor cores (3xTF32), so 3 x the f32 FLOP at the
    TF32 rate, or the bytes, whichever takes longer."""
    return bound(moved_bytes, 3 * flops, TF32_FLOP_PER_S)


def cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                * np.linalg.norm(b, axis=-1))


def normalize_frames(u8: np.ndarray) -> np.ndarray:
    """What preprocess_image makes of a 224x224 frame (no resize needed)."""
    from hirest_tpu_torch.models.eva_clip import CLIP_MEAN, CLIP_STD

    return ((u8.astype(np.float32) / 255.0) - CLIP_MEAN) / CLIP_STD


def counters() -> dict:
    """Kernel -> (wrapper, attribute) of its launch count."""
    from hirest_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_packed,
                                                fused_attention_qkv,
                                                fused_attention_qkv2,
                                                fused_attention_qkv3)
    from hirest_tpu_torch.ops.epilogue import bias_act, bias_residual
    from hirest_tpu_torch.ops.quant import (act_quant, fused_mlp_int8,
                                            int8_epilogue, int8_mm, ln_bf16,
                                            ln_quant, row_quant)

    return {"K1": (fused_attention_qkv3, "launches"),
            "K1f32": (fused_attention_qkv3, "launches_f32"),
            "K2": (ln_quant, "launches"),
            "K2f32": (ln_quant, "launches_f32"),
            "K3": (fused_attention_qkv3, "quant_launches"),
            "K3f32": (fused_attention_qkv3, "quant_launches_f32"),
            "K4": (fused_mlp_int8, "launches"),
            "K4f32": (fused_mlp_int8, "launches_f32"),
            "K5": (act_quant, "launches"),
            "K5f32": (act_quant, "launches_f32"),
            "K6": (fused_attention, "launches"),
            "K6f32": (fused_attention, "launches_f32"),
            "K7": (fused_attention_packed, "launches"),
            "K7f32": (fused_attention_packed, "launches_f32"),
            "K8": (fused_attention_qkv, "launches"),
            "K8f32": (fused_attention_qkv, "launches_f32"),
            "K8q": (fused_attention_qkv, "quant_launches"),
            "K8qf32": (fused_attention_qkv, "quant_launches_f32"),
            "K9": (fused_attention_qkv2, "launches"),
            "K9f32": (fused_attention_qkv2, "launches_f32"),
            "K9q": (fused_attention_qkv2, "quant_launches"),
            "K9qf32": (fused_attention_qkv2, "quant_launches_f32"),
            "K10": (ln_bf16, "launches"),
            "K10f32": (ln_bf16, "launches_f32"),
            "E1": (bias_act, "launches"),
            "E1f32": (bias_act, "launches_f32"),
            "E2": (bias_residual, "launches"),
            "E2f32": (bias_residual, "launches_f32"),
            "E3": (int8_epilogue, "launches"),
            "E3f32": (int8_epilogue, "launches_f32"),
            "E4": (row_quant, "launches"),
            "E4rows": (row_quant, "rows_launches"),
            "E4f32": (row_quant, "launches_f32"),
            "G1": (int8_mm, "launches"),
            "G1f32": (int8_mm, "launches_f32"),
            # not a kernel: torch._int_mm's calls on CUDA tensors, which
            # every forward of the port must leave at 0 (count_int_mm)
            "_int_mm": (int_mm_counted, "launches")}


_INT_MM = torch._int_mm  # the library product, the yardstick of G1


def int_mm_counted(a, b):
    """torch._int_mm, counting its calls on CUDA tensors (count_int_mm)."""
    if a.is_cuda:
        int_mm_counted.launches += 1
    return _INT_MM(a, b)


int_mm_counted.launches = 0


def count_int_mm() -> None:
    """From now on every torch._int_mm call on a CUDA tensor counts as
    read_counts()' "_int_mm", which expect() wants 0 in every forward: no
    CUDA path of the port calls it (G1 takes every int8 product). The
    plain versions call it, and chip_smoke's yardsticks call _INT_MM."""
    torch._int_mm = int_mm_counted


def expect(**per_forward) -> dict:
    """Every kernel's expected count: the given ones, and 0 for the rest."""
    return {k: per_forward.get(k, 0) for k in counters()}


def zero_counts() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def attention_inputs(batch: int, seed: int, tokens: int = TOKENS,
                     hd: int = 1408):
    # std 0.75: what the trunk's qkv projection gives with 0.02 weights
    return (torch.randn((batch, tokens, 3 * hd), generator=gen(seed),
                        device="cuda") * 0.75).to(torch.bfloat16)


def split_views(qkv, heads: int = 16):
    """q, k, v as the unrolled tower's split_heads gives them: [B, H, S, d]
    views of one [B, S, 3 H d] projection, no copy."""
    from hirest_tpu_torch.models.layers import split_heads

    return [split_heads(t, heads) for t in qkv.chunk(3, -1)]


def masked_inputs(seed: int, sq: int = 48, sk: int = 20,
                  valid: tuple = (15, 15), heads: int = 12, d: int = 64):
    """The caption decoder's cross-attention shape: q [B, H, sq, d] over
    k/v [B, H, sk, d], B = len(valid), batch row i's keys from valid[i] on
    masked."""
    g = gen(seed)
    q, k, v = (torch.randn((len(valid), heads, n, d), generator=g,
                           device="cuda").to(torch.bfloat16)
               for n in (sq, sk, sk))
    keys = torch.arange(sk, device="cuda")
    mask = torch.stack([keys < n for n in valid]).int()
    return q, k, v, mask


def ln_inputs(m: int, seed: int, c: int = 1408, dtype=torch.bfloat16):
    """A residual stream with a per-row spread and offset in dtype,
    LayerNorm params near (1, 0)."""
    g = gen(seed)
    x = (torch.randn((m, c), generator=g, device="cuda")
         * torch.rand((m, 1), generator=g, device="cuda").mul_(2.5).add_(0.5)
         + torch.randn((m, 1), generator=g, device="cuda")).to(dtype)
    w = 1 + 0.02 * torch.randn(c, generator=g, device="cuda")
    b = 0.02 * torch.randn(c, generator=g, device="cuda")
    return x, w, b


def mlp_inputs(m: int, seed: int, hidden: int = 6144):
    """What the trunk hands K4: row-quantized LayerNorm output, weights
    quantized from 0.02-scale floats, a bf16 residual."""
    from hirest_tpu_torch.ops.quant import dyn_quant_rows, quantize_weight

    g = gen(seed)
    h_q, h_s = dyn_quant_rows(torch.randn((m, 1408), generator=g,
                                          device="cuda"))
    w1_q, w1_s = quantize_weight(0.02 * torch.randn(
        (hidden, 1408), generator=g, device="cuda"))
    w2_q, w2_s = quantize_weight(0.02 * torch.randn(
        (1408, hidden), generator=g, device="cuda"))
    b1 = 0.02 * torch.randn(hidden, generator=g, device="cuda")
    b2 = 0.02 * torch.randn(1408, generator=g, device="cuda")
    x = torch.randn((m, 1408), generator=g, device="cuda").bfloat16()
    return h_q, h_s, w1_q, w1_s, b1, w2_q, w2_s, b2, x


# K4's first kernel is checked at one frame, the CLI's B = 64, the main
# path's B = 128 and two tails of its persistent walk
K4_STAGE_ROWS = (1, TOKENS, 2 * TOKENS, 64 * TOKENS, BATCH * TOKENS)


def k4_stage_inputs(m: int, seed: int, zero_row: bool = False):
    """mlp_inputs' first five (h_q, h_s, w1_q, w1_s, b1) with spikes: for k
    in 0..7, row k * (m // 8) has, in every 1024-unit chunk, one hidden unit
    in the chunk's k-th 128-unit slice whose w1 row follows the row's signs
    at full scale, so that the row's chunk maximum lies there; the slices
    cover each block of a cluster whatever its width. zero_row: b1 zero and
    the last row of h_q (and one in the middle) all zero, so that their
    chunks take the 1e-8 scale floor."""
    h_q, h_s, w1_q, w1_s, b1 = mlp_inputs(m, seed)[:5]
    f = w1_q.shape[0]
    for k in range(8):
        row = k * max(1, m // 8)
        if row >= m:
            break
        signs = torch.where(h_q[row] < 0, -127, 127).to(torch.int8)
        for c0 in range(0, f, 1024):
            w1_q[c0 + 128 * k + (37 * k + 11) % 128] = signs
    if zero_row:
        b1 = torch.zeros_like(b1)
        h_q[m - 1] = 0
        h_q[m // 2] = 0
    return h_q, h_s, w1_q, w1_s, b1


def check_codes(tag: str, got, want, min_equal: float, scale_rel: float,
                tally: dict | None = None, key: str = ""):
    """Quantized outputs (codes, scales) against the plain version's: codes
    within one and equal on min_equal of them, scales within scale_rel.
    Returns the largest error of the dequantized values; adds the count of
    differing codes to tally[key] where a tally is given."""
    (q, s), (rq, rs) = got, want
    torch.cuda.synchronize()
    diff = (q.int() - rq.int()).abs()
    n_diff = int((diff != 0).sum().item())
    equal = 1 - n_diff / diff.numel()
    rel = ((s - rs).abs() / rs.abs()).max().item()
    err = (q.float() * s - rq.float() * rs).abs().max().item()
    print(f"[kernels] {tag}: max|dcode|={diff.max().item()} "
          f"{n_diff} of {diff.numel()} codes differ, equal={equal:.6f} "
          f"(>= {min_equal}) scale rel={rel:.3e} (<= {scale_rel:.3e}) "
          f"max_abs_err={err}")
    require(bool(s.isfinite().all()) and diff.max().item() <= 1
            and equal >= min_equal and rel <= scale_rel,
            f"{tag} off its plain version")
    if tally is not None:
        tally[key] = tally.get(key, 0) + n_diff
    return err


def biases(hd: int, seed: int):
    """Nonzero q and v biases [hd], of the qkv values' size."""
    g = gen(seed)
    return [(torch.randn(hd, generator=g, device="cuda") * 0.5).bfloat16()
            for _ in range(2)]


def fc1_inputs(m: int, seed: int, c: int = 6144, dtype=torch.bfloat16):
    """What the int8 MLP hands act_quant: an fc1 output in dtype with a
    per-row spread (or, at c = 1408, an attention output)."""
    g = gen(seed)
    return (torch.randn((m, c), generator=g, device="cuda")
            * torch.rand((m, 1), generator=g, device="cuda").mul_(2.5)
            .add_(0.5)).to(dtype)


def check_close(tag: str, got, want) -> float:
    """A bf16 attention output against its plain version: within 2^-7 of
    the output's largest magnitude, one to two bf16 ulps there (p may round
    the other way at a bf16 boundary under another summation order, and the
    output rounds once to bf16). Returns the largest error."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    print(f"[kernels] {tag}: max_abs_err={err} max_err/max|ref|={err / top} "
          f"tol={2 ** -7 * top}")
    require(bool(got.isfinite().all()) and err <= 2 ** -7 * top,
            f"{tag} off its plain version")
    return err


def f32_inputs(batch: int, seed: int, tokens: int, hd: int):
    """An f32 [B, S, 3 hd] projection at the trunk's scale."""
    return torch.randn((batch, tokens, 3 * hd), generator=gen(seed),
                       device="cuda") * 0.75


def check_f32(tag: str, got, want) -> float:
    """The f32 body against its plain version (TF32 off): within 1e-5 of
    the output's largest magnitude. Returns the largest error."""
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    top = want.abs().max().item()
    print(f"[kernels] {tag}: max_abs_err={err} max_err/max|ref|={err / top} "
          f"tol={F32_TOL * top}")
    require(got.dtype == torch.float32 and bool(got.isfinite().all())
            and err <= F32_TOL * top, f"{tag} off its plain version")
    return err


def f32_checks() -> dict:
    """attention_f32.cu through each wrapper against its plain version:
    split heads at ViT-B/32's [B, 12, 50, 64] and EVA-g's
    [B, 16, 257, 88] (B = 2 and 128), packed heads at d = 128, K1/K9's
    layout with n_real = 257 of 264 (d = 88 and 128), K8's with nonzero
    biases, one batch row's keys all masked, 33 queries over 600 keys,
    and the tiles' tails (f32_tails); then bf16 K6 at ViT-B/32's shape.
    Returns the worst errors (K6: the bf16 ViT-B/32 shape's)."""
    from hirest_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_packed,
                                                fused_attention_packed_ref,
                                                fused_attention_qkv,
                                                fused_attention_qkv2,
                                                fused_attention_qkv2_ref,
                                                fused_attention_qkv3,
                                                fused_attention_qkv3_ref,
                                                fused_attention_qkv_ref,
                                                fused_attention_ref)

    worst = dict.fromkeys(("K1f32", "K6f32", "K7f32", "K8f32", "K9f32"),
                          0.0)

    def note(key, err):
        worst[key] = max(worst[key], err)

    for batch in (2, BATCH):
        for heads, tokens, d in ((12, 50, 64), (16, TOKENS, 88)):
            q, k, v = split_views(f32_inputs(batch, 200 + batch + d, tokens,
                                             heads * d), heads)
            note("K6f32", check_f32(
                f"K6 f32 fused_attention [{batch},{heads},{tokens},{d}]",
                fused_attention(q, k, v, d ** -0.5),
                fused_attention_ref(q, k, v, d ** -0.5)))
        q, k, v = f32_inputs(batch, 210 + batch, TOKENS, PADDED_HD).chunk(3,
                                                                          -1)
        note("K7f32", check_f32(
            f"K7 f32 fused_attention_packed [{batch},257,16*128]",
            fused_attention_packed(q, k, v, 128 ** -0.5, 16),
            fused_attention_packed_ref(q, k, v, 128 ** -0.5, 16)))
        for d in (88, 128):
            qkv = f32_inputs(batch, 220 + batch + d, 264, 16 * d)
            shape = f"[{batch},264,{3 * 16 * d}] n_real={TOKENS}"
            for key, fn, ref in (
                    ("K1f32", fused_attention_qkv3, fused_attention_qkv3_ref),
                    ("K9f32", fused_attention_qkv2, fused_attention_qkv2_ref)):
                note(key, check_f32(
                    f"{key[:2]} f32 {fn.__name__} {shape}",
                    fn(qkv, d ** -0.5, 16, n_real=TOKENS),
                    ref(qkv, d ** -0.5, 16, n_real=TOKENS)))
    for batch, d in ((2, 88), (BATCH, 88), (2, 128)):
        qkv = f32_inputs(batch, 230 + batch + d, TOKENS, 16 * d)
        g = gen(231 + d)
        qb, vb = (torch.randn(16 * d, generator=g, device="cuda") * 0.5
                  for _ in range(2))
        note("K8f32", check_f32(
            f"K8 f32 fused_attention_qkv [{batch},{TOKENS},{3 * 16 * d}] "
            f"biased", fused_attention_qkv(qkv, qb, vb, d ** -0.5, 16),
            fused_attention_qkv_ref(qkv, qb, vb, d ** -0.5, 16)))
    q, k, v, mask = masked_inputs(seed=240, valid=(15, 0))
    q, k, v = q.float(), k.float(), v.float()
    note("K6f32", check_f32(
        "K6 f32 fused_attention [2,12,48,64] over 20 keys, 15 and 0 valid",
        fused_attention(q, k, v, 0.125, mask),
        fused_attention_ref(q, k, v, 0.125, mask)))
    q, k, v, mask = masked_inputs(seed=241, sq=33, sk=600, valid=(590, 600),
                                  heads=16, d=88)
    q, k, v = q.float(), k.float(), v.float()
    note("K6f32", check_f32(
        "K6 f32 fused_attention [2,16,33,88] over 600 keys, 590 and 600 "
        "valid", fused_attention(q, k, v, 88 ** -0.5, mask),
        fused_attention_ref(q, k, v, 88 ** -0.5, mask)))
    for seed, sq, sk, valid in ((242, 33, 600, (600, 600)),
                                (243, 48, 20, (15, 0))):
        q, k, v, mask = masked_inputs(seed=seed, sq=sq, sk=sk, valid=valid,
                                      heads=16, d=128)
        packed = [t.float().transpose(1, 2).flatten(2) for t in (q, k, v)]
        note("K7f32", check_f32(
            f"K7 f32 fused_attention_packed [2,{sq},16*128] over {sk} keys, "
            f"{valid[0]} and {valid[1]} valid",
            fused_attention_packed(*packed, 128 ** -0.5, 16, mask),
            fused_attention_packed_ref(*packed, 128 ** -0.5, 16, mask)))
    for d in (88, 128):
        f32_tails(d, note)
    worst["K6"] = 0.0
    for batch in (2, BATCH):
        q, k, v = split_views(attention_inputs(batch, seed=250 + batch,
                                               tokens=50, hd=12 * 64), 12)
        worst["K6"] = max(worst["K6"], check_close(
            f"K6 fused_attention [{batch},12,50,64]",
            fused_attention(q, k, v, 0.125),
            fused_attention_ref(q, k, v, 0.125)))
    return worst


# The f32 body's tails: 65 rows put one row in the second query tile of
# 64 and 65 keys one live key in the last tile of 32; K1/K9 also over 72
# rows with n_real = 65
TAIL_TOKENS = 65
TAIL_PADDED = 72


def f32_tails(d: int, note) -> None:
    """The f32 body at its tiles' edges (TAIL_TOKENS) at head width d,
    B = 2, through K6, K7, K1/K9 (all keys, and n_real of TAIL_PADDED
    rows) and K8 (biased), each within F32_TOL; note(key, err) takes the
    errors."""
    from hirest_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_packed,
                                                fused_attention_packed_ref,
                                                fused_attention_qkv,
                                                fused_attention_qkv2,
                                                fused_attention_qkv2_ref,
                                                fused_attention_qkv3,
                                                fused_attention_qkv3_ref,
                                                fused_attention_qkv_ref,
                                                fused_attention_ref)

    t, scale = TAIL_TOKENS, d ** -0.5
    qkv = f32_inputs(2, 300 + d, t, 16 * d)
    q, k, v = split_views(qkv)
    note("K6f32", check_f32(f"K6 f32 fused_attention [2,16,{t},{d}]",
                            fused_attention(q, k, v, scale),
                            fused_attention_ref(q, k, v, scale)))
    pq, pk, pv = qkv.chunk(3, -1)
    note("K7f32", check_f32(
        f"K7 f32 fused_attention_packed [2,{t},16*{d}]",
        fused_attention_packed(pq, pk, pv, scale, 16),
        fused_attention_packed_ref(pq, pk, pv, scale, 16)))
    for tokens, n_real in ((t, 0), (TAIL_PADDED, t)):
        x = f32_inputs(2, 301 + d + tokens, tokens, 16 * d)
        for key, fn, ref in (
                ("K1f32", fused_attention_qkv3, fused_attention_qkv3_ref),
                ("K9f32", fused_attention_qkv2, fused_attention_qkv2_ref)):
            note(key, check_f32(
                f"{key[:2]} f32 {fn.__name__} [2,{tokens},{3 * 16 * d}] "
                f"n_real={n_real}", fn(x, scale, 16, n_real=n_real),
                ref(x, scale, 16, n_real=n_real)))
    g = gen(302 + d)
    qb, vb = (torch.randn(16 * d, generator=g, device="cuda") * 0.5
              for _ in range(2))
    note("K8f32", check_f32(
        f"K8 f32 fused_attention_qkv [2,{t},{3 * 16 * d}] biased",
        fused_attention_qkv(qkv, qb, vb, scale, 16),
        fused_attention_qkv_ref(qkv, qb, vb, scale, 16)))


def f32_int8_checks() -> dict:
    """The f32 int8 factory's kernels against their plain versions: the
    int8-out attention forms on f32 activations (attention_f32.cu with the
    int8 epilogue) at K3's bars (codes within one, equal on 99 %, scales
    within 2^-7), K3 and K9 int8 at EVA-g's [B, 257, 3 * 16 * 88] and the
    padded head width d = 128, both also over 264 tokens with n_real = 257,
    K8 int8 with nonzero biases at both widths, B = 2 and 128, and each at
    the f32 body's tails (TAIL_TOKENS, B = 2); K2 on f32 rows at K2's
    bars; K4 with an f32 residual, its output within 1e-6 of the MLP's
    largest contribution plus one f32 ulp (the second kernel rounds where
    the plain version rounds). Returns the worst errors."""
    from hirest_tpu_torch.ops.attention import (fused_attention_qkv,
                                                fused_attention_qkv2,
                                                fused_attention_qkv2_ref,
                                                fused_attention_qkv3,
                                                fused_attention_qkv3_ref,
                                                fused_attention_qkv_ref)
    from hirest_tpu_torch.ops.quant import (fused_mlp_int8,
                                            fused_mlp_int8_ref, ln_quant,
                                            ln_quant_ref)

    worst = dict.fromkeys(("K3f32", "K9qf32", "K8qf32", "K2f32", "K4f32"),
                          0.0)
    for batch, d, tokens, n_real in (
            [(batch, d, tokens, n_real) for batch in (2, BATCH)
             for d in (88, 128)
             for tokens, n_real in ((TOKENS, 0), (264, TOKENS))]
            + [(2, d, tokens, n_real) for d in (88, 128)
               for tokens, n_real in ((TAIL_TOKENS, 0),
                                      (TAIL_PADDED, TAIL_TOKENS))]):
        qkv = f32_inputs(batch, 270 + batch + d + tokens, tokens, 16 * d)
        shape = f"[{batch},{tokens},{3 * 16 * d}] n_real={n_real}"
        for key, fn, ref in (
                ("K3f32", fused_attention_qkv3, fused_attention_qkv3_ref),
                ("K9qf32", fused_attention_qkv2, fused_attention_qkv2_ref)):
            worst[key] = max(worst[key], check_codes(
                f"{key} f32 {fn.__name__} quant_out {shape}",
                fn(qkv, d ** -0.5, 16, quant_out=True, n_real=n_real),
                ref(qkv, d ** -0.5, 16, quant_out=True, n_real=n_real),
                0.99, 2 ** -7))
    for batch, d, tokens in ([(batch, d, TOKENS) for batch in (2, BATCH)
                              for d in (88, 128)]
                             + [(2, d, TAIL_TOKENS) for d in (88, 128)]):
        qkv = f32_inputs(batch, 280 + batch + d + tokens - TOKENS, tokens,
                         16 * d)
        g = gen(281 + d)
        qb, vb = (torch.randn(16 * d, generator=g, device="cuda") * 0.5
                  for _ in range(2))
        worst["K8qf32"] = max(worst["K8qf32"], check_codes(
            f"K8qf32 f32 fused_attention_qkv quant_out "
            f"[{batch},{tokens},{3 * 16 * d}] biased",
            fused_attention_qkv(qkv, qb, vb, d ** -0.5, 16, quant_out=True),
            fused_attention_qkv_ref(qkv, qb, vb, d ** -0.5, 16,
                                    quant_out=True), 0.99, 2 ** -7))
    for batch in (2, BATCH):
        rows = batch * TOKENS
        x, w, b = ln_inputs(rows, seed=290 + batch)
        x = x.float()
        worst["K2f32"] = max(worst["K2f32"], check_codes(
            f"K2f32 ln_quant f32 [{rows},1408]", ln_quant(x, w, b, EPS),
            ln_quant_ref(x, w, b, EPS), 0.999, 1e-6))
        args = list(mlp_inputs(rows, seed=295 + batch))
        args[-1] = args[-1].float() + 1e-3 * torch.randn(
            args[-1].shape, generator=gen(296), device="cuda")
        for act in ("gelu_poly", "gelu"):
            got = fused_mlp_int8(*args, act=act)
            want = fused_mlp_int8_ref(*args, act=act)
            torch.cuda.synchronize()
            contrib = (want - args[-1]).abs().max().item()
            ulp = torch.ldexp(torch.ones_like(want),
                              torch.frexp(want)[1] - 24)
            excess = (got - want).abs() - 1e-6 * contrib - ulp
            err = (got - want).abs().max().item()
            print(f"[kernels] K4f32 fused_mlp_int8 f32 residual "
                  f"[{rows},1408]x6144 act={act}: "
                  f"{int((got != want).sum().item())} of {got.numel()} "
                  f"outputs differ, max_abs_err={err} max|want-x|={contrib}")
            require(got.dtype == torch.float32 and bool(got.isfinite().all())
                    and excess.max().item() <= 0,
                    f"fused_mlp_int8 f32 [{rows}] {act} off its plain "
                    f"version")
            worst["K4f32"] = max(worst["K4f32"], err)
    return worst


ROW_EDGE_M = (1, 2, 257, 5000)  # 5000: not a multiple of any grid's rows


def ln_bf16_differ(tag: str, x, w, b) -> tuple:
    """K10 against its plain version: within one bf16 ulp of each output
    plus 1e-5 (the row reductions run in another order and rsqrtf is not
    correctly rounded, which moves the f32 LayerNorm by ~1e-6; where
    (x - mean) r g cancels against b, that is many bf16 ulps of an output
    near zero). Returns the largest error and the count of outputs more
    than one ulp off."""
    from hirest_tpu_torch.ops.quant import ln_bf16, ln_bf16_ref

    got, want = ln_bf16(x, w, b, EPS), ln_bf16_ref(x, w, b, EPS)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    ulp = torch.ldexp(torch.ones_like(diff),
                      torch.frexp(want.float())[1] - 8)
    off = diff > ulp
    n_off = int(off.sum().item())
    top = want.float().abs()[off].max().item() if n_off else 0.0
    err = diff.max().item()
    print(f"[kernels] {tag}: max_abs_err={err}; {n_off} of {diff.numel()} "
          f"outputs more than one bf16 ulp off, all with |want| <= {top}, "
          f"by at most {(diff - ulp).max().item()} over the ulp (<= 1e-5)")
    require(bool(got.isfinite().all()) and bool((diff <= ulp + 1e-5).all()),
            f"{tag} off its plain version")
    return err, n_off


def tie_rows(c: int = 1408) -> torch.Tensor:
    """[5, c] bf16 rows for act "none": two whose max |y| is 127 (scale 1)
    with every other value on k + 1/2 (-126.5 .. 126.5, which must round
    to even), a row of zeros (scale 1e-8, codes 0) and two random rows."""
    halves = torch.arange(c - 1, device="cuda") % 254 - 126.5
    rows = torch.zeros((5, c), device="cuda")
    rows[0, 0], rows[0, 1:] = 127.0, halves
    rows[1, 0], rows[1, 1:] = -127.0, -halves.flip(0)
    rows[3:] = torch.randn((2, c), generator=gen(400), device="cuda")
    return rows.bfloat16()


def quotients_differ(tag: str, y, s, tally: dict) -> None:
    """The row kernels' y / s (row_quotient, rowquant.cuh) against PyTorch's
    IEEE division on the card, on every element of the plain version's f32
    y [..., C] and scales s [..., 1]: they must be equal. Skipped in a
    checkout whose act_quant.cu has no hirest_row_quotients."""
    import ctypes

    from hirest_tpu_torch.ops import build

    lib = build.load("act_quant")
    if not hasattr(lib, "hirest_row_quotients"):
        return
    fn = lib.hirest_row_quotients
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    y = y.reshape(-1, y.shape[-1]).contiguous()
    s = s.reshape(-1, 1).contiguous()
    fast = torch.empty_like(y)
    build.check(lib, fn(y.data_ptr(), s.data_ptr(), fast.data_ptr(),
                        y.shape[0], y.shape[1],
                        torch.cuda.current_stream().cuda_stream),
                "row_quotients launch")
    n = int((fast != y / s).sum().item())
    tally["quotients"] = tally.get("quotients", 0) + n
    print(f"[kernels] {tag}: {n} of {y.numel()} quotients y / s differ "
          f"from PyTorch's IEEE division (bar 0)")
    require(n == 0, f"{tag}: row_quotient off the IEEE quotient")


def row_checks(tag: str = "kernels") -> tuple:
    """K2, K5 and K10 against their plain versions: at the main paths'
    shapes (K2 [2 * 257 and M, 1408]; K5 [M, 6144] with each GELU and
    [M, 1408] with none; K10 [M, 1408]; M = 128 * 257), then at the
    persistent grid's edges, M in ROW_EDGE_M (a row of zeros in the
    257-row inputs: scale 1e-8, codes 0, and for K2 with b = 0), and K5 on
    rows whose quotients land on k + 1/2 (equal to the plain version and
    to half-even rounding), and the general instantiations at widths
    1024 to 8192. K2 and K5: codes within one, equal on 99.9 %,
    scales within 1e-6; K10: ln_bf16_differ's bar. Prints each case and a
    total a kernel of the codes (K10: outputs beyond one ulp) that differ
    from the plain version, which this file copied into an earlier
    checkout prints for that checkout's kernels on the same inputs.
    Returns (the main shapes' largest errors, the totals)."""
    from hirest_tpu_torch.ops.quant import (QUANT_ACTS, _act, _ln_f32,
                                            act_quant, act_quant_ref,
                                            ln_quant, ln_quant_ref)

    m = BATCH * TOKENS
    worst = {"K2": 0.0, "K5": 0.0, "K10": 0.0}
    tally: dict = {}
    tiny = torch.tensor(1e-8, dtype=torch.float32).item()
    for rows in (2 * TOKENS, m, *ROW_EDGE_M):
        main = rows in (2 * TOKENS, m)
        x, w, b = ln_inputs(rows, seed=20 + rows // TOKENS if main
                            else 300 + rows)
        if rows == TOKENS:
            x[5], b = 0, torch.zeros_like(b)
        got, want = ln_quant(x, w, b, EPS), ln_quant_ref(x, w, b, EPS)
        err = check_codes(f"K2 ln_quant [{rows},1408]", got, want, 0.999,
                          1e-6, tally, "K2")
        quotients_differ(f"K2 [{rows},1408]", _ln_f32(x, w, b, EPS),
                         want[1], tally)
        if rows == TOKENS:
            require(not got[0][5].any().item()
                    and got[1][5].item() == tiny, "K2 zero row")
        if main:
            worst["K2"] = max(worst["K2"], err)
    for c, acts in ((6144, ("gelu_poly", "gelu")), (1408, ("none",))):
        for rows in (m, *ROW_EDGE_M):
            x = fc1_inputs(rows, seed=70 + c if rows == m else 500 + rows,
                           c=c)
            if rows == TOKENS:
                x[7] = 0
            for act in acts:
                got, want = act_quant(x, act=act), act_quant_ref(x, act=act)
                err = check_codes(f"K5 act_quant [{rows},{c}] act={act}",
                                  got, want, 0.999, 1e-6, tally, f"K5 {act}")
                quotients_differ(f"K5 [{rows},{c}] act={act}",
                                 _act(act, QUANT_ACTS)(x.float()), want[1],
                                 tally)
                if rows == TOKENS:
                    require(not got[0][7].any().item()
                            and got[1][7].item() == tiny,
                            f"K5 {act} zero row")
                if rows == m:
                    worst["K5"] = max(worst["K5"], err)
    x = tie_rows()
    got, want = act_quant(x), act_quant_ref(x)
    check_codes("K5 act_quant [5,1408] act=none, halves", got, want, 0.999,
                1e-6, tally, "K5 none")
    halves = torch.round(x[:2, 1:].float()).to(torch.int8)
    quotients_differ("K5 [5,1408] act=none, halves", x.float(), want[1],
                     tally)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[0][:2, 1:], halves)
            and got[1][2].item() == tiny, "K5 halves off half-even")
    for rows in (m, *ROW_EDGE_M):
        x, w, b = ln_inputs(rows, seed=90 if rows == m else 600 + rows)
        err, n_off = ln_bf16_differ(f"K10 ln_bf16 [{rows},1408]", x, w, b)
        tally["K10"] = tally.get("K10", 0) + n_off
        if rows == m:
            worst["K10"] = err
    # the general instantiations, at widths other than EVA-g's (their own
    # total: the main paths' stay comparable across versions)
    for c in (1024, 2048):
        x, w, b = ln_inputs(TOKENS, seed=700 + c, c=c)
        check_codes(f"K2 ln_quant [{TOKENS},{c}]", ln_quant(x, w, b, EPS),
                    ln_quant_ref(x, w, b, EPS), 0.999, 1e-6, tally,
                    "other widths")
        tally["other widths"] += ln_bf16_differ(
            f"K10 ln_bf16 [{TOKENS},{c}]", x, w, b)[1]
    for c, act in ((1024, "none"), (2048, "gelu_poly"), (4096, "gelu"),
                   (8192, "gelu_poly")):
        x = fc1_inputs(TOKENS, seed=710 + c, c=c)
        check_codes(f"K5 act_quant [{TOKENS},{c}] act={act}",
                    act_quant(x, act=act), act_quant_ref(x, act=act), 0.999,
                    1e-6, tally, "other widths")
    worst.update(f32_row_checks(tally))
    print(f"[{tag}] differing from the plain version over these cases: "
          + ", ".join(f"{k} {n}" for k, n in tally.items())
          + " (K10: outputs beyond one bf16 ulp; K10f32: none may exceed "
          "its bar)")
    return worst, tally


def check_f32_rows(tag: str, got, want) -> float:
    """K10's f32 form against its plain version: within F32_TOL of each
    row's largest |value| (the kernel sums a row in another order, and its
    rsqrtf is not correctly rounded). Returns the largest error."""
    torch.cuda.synchronize()
    diff = (got - want).abs()
    tol = F32_TOL * want.abs().amax(-1, keepdim=True)
    err = diff.max().item()
    print(f"[kernels] {tag}: max_abs_err={err}, worst share of its row's "
          f"bar {(diff / tol.clamp_min(1e-30)).max().item():.4f} (<= 1)")
    require(got.dtype == torch.float32 and bool(got.isfinite().all())
            and bool((diff <= tol).all()), f"{tag} off its plain version")
    return err


def f32_row_checks(tally: dict) -> dict:
    """K5's and K10's f32 forms against their plain versions on f32 rows:
    K5 at [M, 6144] with each activation and [M, 1408] without one, K10 at
    [M, 1408] (M = 128 * 257), each also at M in ROW_EDGE_M with a row of
    zeros in the 257-row inputs (K5: scale 1e-8 and codes 0; K10: b), K5 on
    the k + 1/2 quotient rows (equal to the plain version and to half-even
    rounding), and the general instantiations at other widths. K5 at K5's
    bars (codes within one, equal on 99.9 %, scales within 1e-6), K10
    within F32_TOL of each row's largest |value|. Skipped, with a line, in
    a checkout whose wrappers have no f32 row forms. Returns the main
    shapes' largest errors."""
    from hirest_tpu_torch.ops.quant import (act_quant, act_quant_ref,
                                            ln_bf16, ln_bf16_ref)

    if not hasattr(ln_bf16, "launches_f32"):
        print("[kernels] K5 and K10 f32 forms: not in this tree")
        return {}
    t0 = time.perf_counter()
    m = BATCH * TOKENS
    worst = {"K5f32": 0.0, "K10f32": 0.0}
    tiny = torch.tensor(1e-8, dtype=torch.float32).item()
    for c, acts in ((6144, ("gelu_poly", "gelu", "none")), (1408, ("none",))):
        for rows in (m, *ROW_EDGE_M):
            x = fc1_inputs(rows, seed=170 + c if rows == m else 540 + rows,
                           c=c, dtype=torch.float32)
            if rows == TOKENS:
                x[7] = 0
            for act in acts:
                got = act_quant(x, act=act)
                err = check_codes(
                    f"K5f32 act_quant f32 [{rows},{c}] act={act}", got,
                    act_quant_ref(x, act=act), 0.999, 1e-6, tally, "K5f32")
                if rows == TOKENS:
                    require(not got[0][7].any().item()
                            and got[1][7].item() == tiny,
                            f"K5f32 {act} zero row")
                if rows == m:
                    worst["K5f32"] = max(worst["K5f32"], err)
    x = tie_rows().float()
    got, want = act_quant(x), act_quant_ref(x)
    check_codes("K5f32 act_quant f32 [5,1408] act=none, halves", got, want,
                0.999, 1e-6, tally, "K5f32")
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[0][:2, 1:],
                            torch.round(x[:2, 1:]).to(torch.int8))
            and got[1][2].item() == tiny, "K5f32 halves off half-even")
    for rows in (m, *ROW_EDGE_M):
        x, w, b = ln_inputs(rows, seed=190 if rows == m else 640 + rows,
                            dtype=torch.float32)
        if rows == TOKENS:
            x[5] = 0
        got = ln_bf16(x, w, b, EPS)
        err = check_f32_rows(f"K10f32 ln_bf16 f32 [{rows},1408]", got,
                             ln_bf16_ref(x, w, b, EPS))
        if rows == TOKENS:
            require(bool((got[5] - b).abs().max() <= F32_TOL
                         * b.abs().max()), "K10f32 zero row off b")
        if rows == m:
            worst["K10f32"] = err
    # the general instantiations: a warp a row (1412: a lane's last vector
    # only on some lanes), a warpgroup (4100), the widest rows
    for c, act in ((1412, "none"), (2048, "gelu_poly"), (4100, "gelu"),
                   (8192, "gelu_poly")):
        x = fc1_inputs(TOKENS, seed=740 + c, c=c, dtype=torch.float32)
        check_codes(f"K5f32 act_quant f32 [{TOKENS},{c}] act={act}",
                    act_quant(x, act=act), act_quant_ref(x, act=act), 0.999,
                    1e-6, tally, "other widths f32")
    for c in (1024, 1412, 2048):
        x, w, b = ln_inputs(TOKENS, seed=760 + c, c=c, dtype=torch.float32)
        check_f32_rows(f"K10f32 ln_bf16 f32 [{TOKENS},{c}]",
                       ln_bf16(x, w, b, EPS), ln_bf16_ref(x, w, b, EPS))
    print(f"[kernels] K5 and K10 f32 forms checked in "
          f"{time.perf_counter() - t0:.1f} s")
    return worst


# --- E1 and E2: the scanned block's projection epilogues ------------------

EPI_WIDTHS = (6144, 4224, 1408)  # fc1 (and padded qkv), qkv, proj / fc2 out
EPI_EDGE_M = (1, 257, 5000)  # a row, a frame, not a multiple of a grid step
# E1's forms on the main paths: (act, with a bias); without one, int8 dyn's
# GELU on int8_mm's output
E1_FORMS = (("gelu_poly", True), ("gelu", True), ("none", True),
            ("gelu_poly", False), ("gelu", False))
# The f32 issue slots a value E1's and E2's functions need, counted from
# the arithmetic as ROW_SLOTS is: each bf16 operand's widening 1, each sum
# 1, the bias sum's rounding to bf16 and back 2, gelu_bf16_poly 22 (the
# exact GELU's four explicit operations, erff not counted), bf16 out 0.5.
EPI_ACT_SLOTS = {"gelu_poly": 22, "gelu": 4, "none": 0}


def epilogue_bound(m: int, c: int, dtype, act=None,
                   residual: bool = False) -> dict:
    """E1's (act) or E2's (residual) bound on [m, c] in dtype: y read and
    written, x read for E2, the bias row read once; or the issue slots."""
    bf16 = dtype == torch.bfloat16
    size = 2 if bf16 else 4
    if residual:
        slots = 3 + 2 + 2 + 0.5 if bf16 else 2
    else:
        slots = EPI_ACT_SLOTS[act] + (2 + 1 + 2 + 0.5 if bf16 else 1)
    return bound(((3 if residual else 2) * m * c + c) * size, slots * m * c,
                 ISSUE_SLOTS_PER_S)


def epilogue_inputs(m: int, c: int, seed: int, dtype):
    """y [m, c], b [c], x [m, c] in dtype: y normal at 3 (a share past
    gelu_bf16_poly's clamp at 4.1 sqrt 2), b at 0.5, x at 2, the first 16
    columns of y zero and b zero on 8 of them (sums of exactly zero)."""
    g = gen(seed)
    y = torch.randn((m, c), generator=g, device="cuda") * 3
    b = torch.randn(c, generator=g, device="cuda") * 0.5
    x = torch.randn((m, c), generator=g, device="cuda") * 2
    y[:, :16] = 0.0
    b[8:16] = 0.0
    return y.to(dtype), b.to(dtype), x.to(dtype)


def epilogue_check(tag: str, got, want, exact: bool) -> tuple:
    """An epilogue's output against its plain version: bit for bit where
    exact, else (the exact GELU, erff against PyTorch's) within one bf16
    ulp of the largest value (f32: 1e-6 of it). Returns (the largest
    error, the share of elements that differ)."""
    torch.cuda.synchronize()
    g32, w32 = got.float(), want.float()
    require(got.dtype == want.dtype and got.shape == want.shape
            and bool(torch.isfinite(g32).all()), f"{tag}: output {got.dtype} "
                                                 f"{tuple(got.shape)}")
    err = (g32 - w32).abs().max().item()
    share = (g32 != w32).float().mean().item()
    if exact:
        ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
        ok = torch.equal(got.view(ints), want.view(ints))
    else:
        top = max(w32.abs().max().item(), np.finfo(np.float32).tiny)
        ok = err <= (2.0 ** (np.floor(np.log2(top)) - 7)
                     if got.dtype == torch.bfloat16 else 1e-6 * top)
    require(ok, f"{tag} off its plain version: max_abs_err={err}, "
                f"{share} of elements differ")
    return err, share


def epilogue_checks() -> dict:
    """E1 (every form of E1_FORMS) and E2 against their plain versions in
    bf16 and f32 at EPI_WIDTHS, M = 32896 and EPI_EDGE_M; then the
    wrappers refusing what the kernels do not take. Returns the largest
    error of E1, E2 and their f32 forms."""
    from hirest_tpu_torch.ops.epilogue import (bias_act, bias_act_ref,
                                               bias_residual,
                                               bias_residual_ref)

    worst = {}
    seed = 900
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        for c in EPI_WIDTHS:
            forms = (*(("E1", a, wb) for a, wb in E1_FORMS),
                     ("E2", None, True))
            for kind, act, with_bias in forms:
                errs, shares = [], []
                for m in (BATCH * TOKENS, *EPI_EDGE_M):
                    seed += 1
                    y, b, x = epilogue_inputs(m, c, seed, dtype)
                    tag = f"{kind} {name} [{m},{c}]"
                    if kind == "E1":
                        bb = b if with_bias else None
                        got = bias_act(y.clone(), bb, act=act)
                        want = bias_act_ref(y.clone(), bb, act=act)
                    else:
                        got = bias_residual(y.clone(), b, x)
                        want = bias_residual_ref(y.clone(), b, x)
                    err, share = epilogue_check(tag, got, want,
                                                exact=act != "gelu")
                    errs.append(err)
                    shares.append(share)
                form = (f"act={act}, {'bias' if with_bias else 'no bias'}"
                        if kind == "E1" else "bias + residual")
                bar = ("one bf16 ulp of the largest" if act == "gelu"
                       else "bit for bit")
                print(f"[kernels] {kind} {name} {form} [M,{c}], M = "
                      f"{BATCH * TOKENS}, {', '.join(map(str, EPI_EDGE_M))}:"
                      f" max_abs_err={max(errs)}, share differing "
                      f"{', '.join(f'{s:.6f}' for s in shares)} ({bar})")
                key = kind + ("f32" if name == "f32" else "")
                worst[key] = max(worst.get(key, 0.0), *errs)
    y = torch.zeros((4, 1408), device="cuda", dtype=torch.bfloat16)
    b = torch.zeros(1408, device="cuda", dtype=torch.bfloat16)
    for what, call in (
            ("f16", lambda: bias_act(y.half(), b.half())),
            ("a transposed view", lambda: bias_act(y.t(), b[:4])),
            ("C % 8 != 0", lambda: bias_act(y[:, :1404].contiguous(),
                                            b[:1404])),
            ("an f32 bias on bf16", lambda: bias_act(y, b.float())),
            ("a residual of another shape",
             lambda: bias_residual(y, b, y[:2]))):
        try:
            call()
        except (TypeError, ValueError):
            continue
        require(False, f"E1/E2 took {what}")
    print("[kernels] E1/E2 wrappers refuse f16, a transposed view, C % 8 "
          "!= 0 in bf16, a bias of another dtype, a residual of another "
          "shape")
    return worst


def epilogue_times(m: int, w: int, hid: int, kernels: bool) -> dict:
    """E1 and E2 at B=128 (M = m) in bf16 and f32 beside their plain chains
    (the block's code before the kernels: the bias added in place, then
    gelu_bf16_poly; x + (y + b)), a library call on the same bytes (F.gelu
    for E1 with a GELU; torch.add with the bias for E1's qkv form, the same
    function; torch.add(x, y) for E2) and the bound. kernels False (a
    checkout without ops/epilogue.py): the kernel's "ms" is None."""
    import torch.nn.functional as F

    from hirest_tpu_torch.models.layers import gelu_bf16_poly

    if kernels:
        from hirest_tpu_torch.ops.epilogue import bias_act, bias_residual
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        sfx = "" if dtype == torch.bfloat16 else "f32"
        for key, c, act in ((f"E1{sfx}", hid, "gelu_poly"),
                            (f"E1{sfx} qkv none [M,{3 * w}]", 3 * w, "none"),
                            (f"E2{sfx}", w, None)):
            y, b, x = epilogue_inputs(m, c, 950 + c, dtype)
            yp = y.clone()
            if act is None:
                def plain():
                    return x + yp.add_(b)

                def library():
                    return torch.add(x, y)

                def kernel():
                    return bias_residual(y, b, x)
            elif act == "none":
                def plain():
                    return yp.add_(b)

                def library():
                    return torch.add(y, b)

                def kernel():
                    return bias_act(y, b, act="none")
            else:
                def plain():
                    return gelu_bf16_poly(yp.add_(b))

                def library():
                    return F.gelu(y)

                def kernel():
                    return bias_act(y, b, act="gelu_poly")
            res[key] = {
                "ms": cuda_ms(kernel, 20) if kernels else None,
                "plain_ms": cuda_ms(plain, 5),
                "library_ms": cuda_ms(library, 20),
                **epilogue_bound(m, c, dtype, act, residual=act is None)}
            del y, b, x, yp
    return res


# E3's products at EVA-g's widths: (form, N, with a bias, with the
# residual): v1's qkv has no bias, v2/v3's has; out and fc2 add the
# residual; fc1 (int8 dyn, the fused-quant MLP without K4); the unrolled
# tower's head
E3_FORMS = (("qkv v1", 4224, False, False), ("qkv v2/v3", 4224, True, False),
            ("out / fc2", 1408, True, True), ("fc1", 6144, True, False),
            ("head", 1024, True, False))
INT8_EDGE_M = (1, 257, 5000)  # a row, a frame, not a multiple of a block's


def int8_epilogue_inputs(m: int, n: int, seed: int, dtype, with_bias: bool,
                         with_res: bool) -> tuple:
    """E3's operands: int32 accumulators as a 1408-deep int8 product gives
    them (up to ~2^24.5, so the int -> f32 conversion rounds), the first
    columns at its edges (2^24 + 1, -(2^25 + 3), 0, 127^2 * 1408), row and
    channel scales, a bias, a residual in dtype."""
    g = gen(seed)
    acc = torch.randint(-2 ** 24, 2 ** 24, (m, n), generator=g,
                        device="cuda", dtype=torch.int32) * 2 + 1
    acc[:, :4] = torch.tensor([2 ** 24 + 1, -(2 ** 25 + 3), 0,
                               127 * 127 * 1408], dtype=torch.int32)
    x_s = torch.rand((m, 1), generator=g, device="cuda") * 0.05
    w_s = torch.rand(n, generator=g, device="cuda") * 1e-3
    b = torch.randn(n, generator=g, device="cuda") if with_bias else None
    x = ((torch.randn((m, n), generator=g, device="cuda") * 2).to(dtype)
         if with_res else None)
    return acc, x_s, w_s, b, x


def row_quant_inputs(m: int, c: int, seed: int, dtype) -> torch.Tensor:
    """Rows [m, c] in dtype with a per-row spread; where m >= 5 the first
    five are tie_rows' (quotients on k + 1/2, a zero row)."""
    x = fc1_inputs(m, seed, c=c, dtype=torch.float32)
    if m >= 5:
        x[:5] = tie_rows(c).float()
    return x.to(dtype)


def differing(got, want, tag: str = "") -> int:
    """Codes and scales (by their bits) of got that differ from want's."""
    (q, s), (rq, rs) = got, want
    torch.cuda.synchronize()
    require(q.shape == rq.shape and s.shape == rs.shape,
            f"{tag}: shapes {tuple(q.shape)} {tuple(s.shape)}, expected "
            f"{tuple(rq.shape)} {tuple(rs.shape)}")
    return int((q != rq).sum().item()) + int(
        (s.view(torch.int32) != rs.view(torch.int32)).sum().item())


def codes_equal(tag: str, got, want) -> int:
    """Codes and scales against the plain version's, bit for bit (bar 0);
    returns the count of differing codes and scales."""
    n = differing(got, want, tag)
    print(f"[kernels] {tag}: {n} of {got[0].numel()} codes and "
          f"{got[1].numel()} scales differ (bar 0)")
    require(n == 0, f"{tag} off its plain version")
    return n


def int8_epilogue_checks() -> dict:
    """E3 (every E3_FORMS product) bit for bit against its plain version
    in bf16 and f32 at M = 32896 and INT8_EDGE_M; E4 bit for bit against
    its plain version on the trunk's rows (1408, 6144; also 257 rows into
    [300, C + 32]), the unrolled tower's patch rows (588 into 592-wide
    codes, B = 128 and 2 images) and head rows (the class tokens, 257 x
    1408 apart, B = 128 and 2), with ties and a zero row, each on the
    kernel row_quant_route names and counted there; K5 without an
    activation
    (what dyn_quant_rows launches on the card) bit for bit against
    dyn_quant_rows' plain version at the scanned block's widths; then the
    wrappers refusing what the kernels do not take. Returns E3's and E4's
    largest errors (0 where bit for bit)."""
    from hirest_tpu_torch.ops.quant import (act_quant,
                                            dyn_quant_rows_ref, int8_epilogue,
                                            int8_epilogue_ref, row_quant,
                                            row_quant_ref, row_quant_route)

    worst = {}
    seed = 1300
    for dtype in (torch.bfloat16, torch.float32):
        sfx = "" if dtype == torch.bfloat16 else "f32"
        for form, n, with_bias, with_res in E3_FORMS:
            errs, shares = [], []
            for m in (BATCH * TOKENS, *INT8_EDGE_M):
                seed += 1
                acc, x_s, w_s, b, x = int8_epilogue_inputs(
                    m, n, seed, dtype, with_bias, with_res)
                got = int8_epilogue(acc, x_s, w_s, b, dtype, x)
                want = int8_epilogue_ref(acc, x_s, w_s, b, dtype, x)
                err, share = epilogue_check(f"E3{sfx} {form} [{m},{n}]",
                                            got, want, exact=True)
                errs.append(err)
                shares.append(share)
            print(f"[kernels] E3{sfx} {form} [M,{n}], M = {BATCH * TOKENS}, "
                  f"{', '.join(map(str, INT8_EDGE_M))}: max_abs_err="
                  f"{max(errs)}, share differing "
                  f"{', '.join(f'{v:.6f}' for v in shares)} (bit for bit)")
            worst["E3" + sfx] = max(worst.get("E3" + sfx, 0.0), *errs)
        # E4: (what, rows x2, rows written, codes' width)
        cases = []
        for c in (1408, 6144):
            for m in (BATCH * TOKENS, *INT8_EDGE_M):
                seed += 1
                x2 = row_quant_inputs(m, c, seed, dtype)
                cases.append((f"[{m},{c}]", x2, m, c))
            # codes wider than the row and rows past M, both zero
            seed += 1
            x2 = row_quant_inputs(TOKENS, c, seed, dtype)
            cases.append((f"[{TOKENS},{c}] padded", x2, 300, c + 32))
        for batch in (BATCH, 2):
            seed += 1
            patches = row_quant_inputs(batch * 256, 588, seed, dtype)
            cases.append((f"patch rows [{batch * 256},588] into 592",
                          patches, batch * 256, 592))
            seed += 1
            tokens = row_quant_inputs(batch * TOKENS, 1408, seed, dtype)
            head = tokens.view(batch, TOKENS, 1408)[:, 0]
            cases.append((f"head rows [{batch},1408] {TOKENS} x 1408 apart",
                          head, batch, 1408))
        # each case on the kernel row_quant_route names: the ring for bf16
        # rows a bulk copy takes, row_quant_kernel for the patch rows and
        # f32 rows; the launch counted on that kernel's count
        for what, x2, rows, ldq in cases:
            ldx = x2.stride(0) if x2.shape[0] > 1 else x2.shape[1]
            route = row_quant_route(dtype, x2.shape, ldx,
                                    x2.data_ptr() % 16 == 0, ldq)
            attr = ("launches" if route == "ring" else
                    "launches_f32" if sfx else "rows_launches")
            require(route == ("rows" if sfx or "patch" in what else "ring"),
                    f"E4{sfx} {what} routed to {route}")
            before = getattr(row_quant, attr)
            codes_equal(f"E4{sfx} row_quant {what}, [{rows},{ldq}] out, "
                        f"{route}", row_quant(x2, rows, ldq),
                        row_quant_ref(x2, rows, ldq))
            require(getattr(row_quant, attr) == before + 1,
                    f"E4{sfx} {what}: no launch on {attr}")
        worst["E4" + sfx] = 0.0
        if not sfx:
            worst["E4rows"] = 0.0
        for c in (1408, 6144):
            for m in (BATCH * TOKENS, *INT8_EDGE_M):
                seed += 1
                x = row_quant_inputs(m, c, seed, dtype)
                codes_equal(f"K5{sfx} act=none vs dyn_quant_rows [{m},{c}]",
                            act_quant(x, act="none"), dyn_quant_rows_ref(x))
    acc = torch.zeros((32, 1408), dtype=torch.int32, device="cuda")
    x_s = torch.ones((32, 1), device="cuda")
    w_s = torch.ones(1408, device="cuda")
    y = torch.zeros((32, 1408), dtype=torch.bfloat16, device="cuda")
    for what, call in (
            ("f16 out", lambda: int8_epilogue(acc, x_s, w_s, None,
                                              torch.float16)),
            ("an int16 accumulator", lambda: int8_epilogue(
                acc.short(), x_s, w_s, None, torch.bfloat16)),
            ("a transposed accumulator", lambda: int8_epilogue(
                acc.t(), x_s, w_s, None, torch.bfloat16)),
            ("N % 4 != 0", lambda: int8_epilogue(
                acc[:, :1406].contiguous(), x_s, w_s[:1406], None,
                torch.bfloat16)),
            ("a residual of another dtype", lambda: int8_epilogue(
                acc, x_s, w_s, None, torch.bfloat16, y.float())),
            ("f16 rows", lambda: row_quant(y.half())),
            ("C % 4 != 0", lambda: row_quant(y[:, :1406])),
            ("a transposed view", lambda: row_quant(y.t())),
            ("codes narrower than the row", lambda: row_quant(y, 32, 1404)),
            ("fewer rows than x", lambda: row_quant(y, 16))):
        try:
            call()
        except (TypeError, ValueError):
            continue
        require(False, f"E3/E4 took {what}")
    print("[kernels] E3/E4 wrappers refuse f16, an int16 accumulator, a "
          "transposed accumulator or view, N or C % 4 != 0, a residual of "
          "another dtype, codes narrower than the row, fewer rows than x")
    return worst


def int8_epilogue_bound(m: int, n: int, dtype, with_bias: bool,
                        with_res: bool) -> dict:
    """E3's bound on [m, n]: the int32 accumulator read, the output written
    (and the residual read) in dtype, the scales and bias read once."""
    size = 2 if dtype == torch.bfloat16 else 4
    moved = m * n * (4 + size * (2 if with_res else 1)) + m * 4 + n * 4 * (
        2 if with_bias else 1)
    return bound(moved, 0, ISSUE_SLOTS_PER_S)


def row_quant_bound(m: int, c: int, dtype, ldq=None) -> dict:
    """E4's bound: the rows read once, the codes and scales written."""
    size = 2 if dtype == torch.bfloat16 else 4
    return bound(m * c * size + m * (ldq or c) + m * 4, 0, ISSUE_SLOTS_PER_S)


def e4_cases(m: int, w: int, hid: int, dtype=torch.bfloat16) -> dict:
    """E4's shapes on the unrolled int8 tower at B=128: name -> (rows x2,
    rows written, codes' width): the trunk's rows [M, w], the MLP's
    [M, hid], the patch rows [128 * 256, 588] into 592 and the head's
    class-token rows [128, w], 257 x w apart."""
    tokens = row_quant_inputs(m, w, 1452, dtype)
    return {f"[M,{w}]": (row_quant_inputs(m, w, 1450, dtype), m, w),
            f"[M,{hid}]": (row_quant_inputs(m, hid, 1451, dtype), m, hid),
            f"patch rows [{BATCH * 256},588] into 592": (
                row_quant_inputs(BATCH * 256, 588, 1453, dtype), BATCH * 256,
                592),
            f"head rows [{BATCH},{w}] {TOKENS} x {w} apart": (
                tokens.view(BATCH, TOKENS, w)[:, 0], BATCH, w)}


def e4_times(m: int, w: int, hid: int, dtype=torch.bfloat16) -> dict:
    """E4 (row_quant, through the wrapper every version of the port has) at
    each e4_cases shape: ms beside its plain version, a clone of its rows
    and its bound."""
    from hirest_tpu_torch.ops.quant import row_quant, row_quant_ref

    res = {}
    for name, (x2, rows, ldq) in e4_cases(m, w, hid, dtype).items():
        res[name] = {
            "ms": cuda_ms(lambda: row_quant(x2, rows, ldq), 50, 5),
            "plain_ms": cuda_ms(lambda: row_quant_ref(x2, rows, ldq), 5),
            "library_ms": None,
            "reference_ms": cuda_ms(lambda: x2.clone(), 20),
            **row_quant_bound(rows, x2.shape[1], dtype, ldq)}
    return res


def int8_epilogue_times(m: int, w: int, hid: int) -> tuple:
    """E3 and E4 at B=128 (M = m) in bf16 and f32, each beside its plain
    chain, a same-bytes reference and its bound: E3 on the qkv projection
    [M, 3w] with its bias (the kernels line's row), on out / fc2 [M, w]
    with bias and residual; reference acc.to(dtype) (and x + that for the
    residual form). E4 at e4_cases' shapes: the trunk's rows [M, w] on the
    ring (the kernels line's E4; f32: row_quant_kernel, E4f32) and the
    patch rows (row_quant_kernel, the kernels line's E4rows); reference a
    clone of the rows. Returns (the kernels line's rows, the others)."""
    from hirest_tpu_torch.ops.quant import int8_epilogue, int8_epilogue_ref

    res, extra = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        sfx = "" if dtype == torch.bfloat16 else "f32"
        for key, n, with_res in ((f"E3{sfx}", 3 * w, False),
                                 (f"E3{sfx} out/fc2 + residual [M,{w}]", w,
                                  True)):
            acc, x_s, w_s, b, x = int8_epilogue_inputs(m, n, 1400 + n, dtype,
                                                       True, with_res)
            ref = ((lambda: x + acc.to(dtype)) if with_res
                   else (lambda: acc.to(dtype)))
            (res if key == f"E3{sfx}" else extra)[key] = {
                "ms": cuda_ms(lambda: int8_epilogue(acc, x_s, w_s, b, dtype,
                                                    x), 20),
                "plain_ms": cuda_ms(lambda: int8_epilogue_ref(
                    acc, x_s, w_s, b, dtype, x), 5),
                "library_ms": None,
                "reference_ms": cuda_ms(ref, 20),
                **int8_epilogue_bound(m, n, dtype, True, with_res)}
            del acc, x_s, w_s, b, x
        for name, r in e4_times(m, w, hid, dtype).items():
            if name == f"[M,{w}]":
                res[f"E4{sfx}"] = r
            elif name.startswith("patch") and not sfx:
                res["E4rows"] = r
            else:
                extra[f"E4{sfx} {name}"] = r
    return res, extra


# G1's products at EVA-g's widths: (form, K, N, with a bias, with the
# residual): v1's qkv without its bias, v2/v3's with it, both heads' widths
# (88, and padded to 128: qkv 6144 wide, out 2048 deep), out and fc2 with
# the residual, fc1, and the unrolled tower's patch embedding (588 padded
# to 592); the head on class-token rows is G1_HEAD
G1_FORMS = (("qkv v1", 1408, 4224, False, False),
            ("qkv v2/v3", 1408, 4224, True, False),
            ("qkv v1 padded heads", 1408, 6144, False, False),
            ("qkv padded heads", 1408, 6144, True, False),
            ("out", 1408, 1408, True, True),
            ("out padded heads", 2048, 1408, True, True),
            ("fc1", 1408, 6144, True, False),
            ("fc2", 6144, 1408, True, True),
            ("patch embed", 592, 1408, True, False))
G1_EDGE_M = (1, 17, 257, 5000)  # a row, _int_mm's least, a frame, ragged
# 256 row tiles, so clusters of two along M pair every row tile (M = 32896
# leaves the last one alone)
G1_EVEN_M = BATCH * 256
G1_HEAD = (1408, 1024)  # the head: K, N, on B class-token rows
G1_HEAD_SPLITS = (2, 3, 5, 8)  # split K forced at the head, beside the rule's
G1_KERNELS = ("int8_gemm_kernel", "int8_gemm_split_kernel",
              "int8_gemm_serial_kernel")


def g1_variants() -> dict:
    """G1's variants in this checkout (ops/quant.py::INT8_GEMM_VARIANTS)
    -> what each is."""
    from hirest_tpu_torch.ops import quant

    v = quant.INT8_GEMM_VARIANTS
    return dict(v) if isinstance(v, dict) else {i: f"variant {i}" for i in v}


def g1_forced(quant, v):
    """G1 in variant v, in this checkout's wrapper or an earlier one's."""
    import inspect

    key = ("config" if "config" in inspect.signature(
        quant._int8_gemm_launch).parameters else "variant")
    return lambda *args: quant._int8_gemm_launch(*args, **{key: v})


def print_int8_gemm_info(tag: str) -> None:
    """Each G1 variant's shared memory, ring stages, cluster and the blocks
    (clusters) the card holds at once."""
    from hirest_tpu_torch.ops import quant

    names = g1_variants()
    for (v, dt), info in quant.int8_gemm_info().items():
        held = ("not persistent" if info["resident"] == 0 else
                f"{info['resident']} blocks at once"
                + (f" ({info['resident'] // info['cluster']} clusters of "
                   f"{info['cluster']}, cudaOccupancyMaxActiveClusters)"
                   if info["cluster"] > 1 else ""))
        print(f"[{tag}] G1 variant {v} ({names[v]}), {dt} out: "
              f"{info['smem']} B shared a block, {info['stages']} ring "
              f"stages, {held}")


def int8_gemm_inputs(m: int, k: int, n: int, seed: int, dtype,
                     with_bias: bool, with_res: bool,
                     head_rows: bool = False) -> tuple:
    """G1's operands: random int8 codes x_q [m, k] (with head_rows, the
    class tokens of [m, 257, k] codes: rows 257 k apart) and w_q [n, k],
    row and channel scales, a bias, a residual in dtype. Row 0 against w_q's
    row 0 gives an odd product, past 2^24 where K > 1040 (the int -> f32
    conversion rounds), row 1 its negation."""
    g = gen(seed)
    if head_rows:
        x_q = torch.randint(-127, 128, (m, TOKENS, k), generator=g,
                            device="cuda", dtype=torch.int8)[:, 0]
    else:
        x_q = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                            dtype=torch.int8)
    w_q = torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                        dtype=torch.int8)
    x_q[0] = 127
    w_q[0] = 127
    w_q[0, 0] = 126
    if m > 1:
        x_q[1] = -127
    x_s = torch.rand((m, 1), generator=g, device="cuda") * 0.05 + 1e-3
    w_s = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-5
    b = torch.randn(n, generator=g, device="cuda") if with_bias else None
    x = ((torch.randn((m, n), generator=g, device="cuda") * 2).to(dtype)
         if with_res else None)
    return x_q, x_s, w_q, w_s, b, x


def int8_gemm_cases(seed: int, edges: bool = True):
    """(tag, G1's operands, dtype) at every shape G1 takes over, in bf16 and
    f32: each G1_FORMS product at M = 32896 (the patch embedding at 32768)
    and, with edges, at G1_EVEN_M and G1_EDGE_M; the head on class-token
    rows at B = 2 and 128."""
    for dtype in (torch.bfloat16, torch.float32):
        sfx = "" if dtype == torch.bfloat16 else "f32"
        for form, k, n, with_bias, with_res in G1_FORMS:
            big = G1_EVEN_M if form == "patch embed" else BATCH * TOKENS
            more = (*((G1_EVEN_M,) if big != G1_EVEN_M else ()), *G1_EDGE_M)
            for m in (big, *(more if edges else ())):
                seed += 1
                yield (f"G1{sfx} {form} [{m},{k}]x[{k},{n}]",
                       int8_gemm_inputs(m, k, n, seed, dtype, with_bias,
                                        with_res), dtype)
        for batch in (2, BATCH):
            seed += 1
            k, n = G1_HEAD
            yield (f"G1{sfx} head [{batch},{k}]x[{k},{n}] on class-token "
                   f"rows {TOKENS} x {k} apart",
                   int8_gemm_inputs(batch, k, n, seed, dtype, True, False,
                                    head_rows=True), dtype)


def int8_gemm_checks() -> dict:
    """G1 (int8_mm on CUDA, in int8_gemm_config's choice) bit for bit
    against its plain version (int8_mm_ref: torch._int_mm, then E3's plain
    version) at every shape of int8_gemm_cases, in bf16 and f32 out, and
    every variant (each one the rule picks somewhere) forced at every
    shape in each dtype it has, split K also at G1_HEAD_SPLITS on the
    head's rows. Then the wrapper refusing what G1's rule refuses. Returns
    G1's largest errors (0: bit for bit)."""
    from hirest_tpu_torch.ops.quant import (INT8_GEMM_F32_ONLY,
                                            INT8_GEMM_SPLIT, Int8GemmConfig,
                                            _int8_gemm_launch,
                                            int8_gemm_config, int8_mm,
                                            int8_mm_ref)

    forced = list(g1_variants())
    worst = {"G1": 0.0, "G1f32": 0.0}
    n_checks, picked = 0, {}
    for tag, (x_q, x_s, w_q, w_s, b, x), dtype in int8_gemm_cases(2100):
        want = int8_mm_ref(x_q, x_s, w_q, w_s, b, dtype, x)
        got = int8_mm(x_q, x_s, w_q, w_s, b, dtype, x)
        err, share = epilogue_check(tag, got, want, exact=True)
        m, k = x_q.shape
        n = w_q.shape[0]
        config = int8_gemm_config(m, n, k, dtype == torch.float32,
                                  x is not None)
        picked.setdefault(config[:2], []).append(m)
        configs = [v for v in forced if dtype == torch.float32
                   or v not in INT8_GEMM_F32_ONLY]
        if "head" in tag:
            configs += [Int8GemmConfig(INT8_GEMM_SPLIT, sp, sp)
                        for sp in G1_HEAD_SPLITS]
        for c in configs:
            got = _int8_gemm_launch(x_q, x_s, w_q, w_s, b, dtype, x,
                                    config=c)
            epilogue_check(f"{tag} {c}", got, want, exact=True)
        n_checks += 1 + len(configs)
        key = "G1" if dtype == torch.bfloat16 else "G1f32"
        worst[key] = max(worst[key], err)
        if m in (BATCH * TOKENS, G1_EVEN_M, 2):
            print(f"[kernels] {tag}: {config}, max_abs_err={err}, share "
                  f"differing {share} (bit for bit; also at M = "
                  f"{', '.join(map(str, G1_EDGE_M))} and in variants "
                  f"{forced})")
        del x_q, x_s, w_q, w_s, b, x, got, want
    print(f"[kernels] G1 int8_mm: {n_checks} products bit for bit with "
          f"int8_mm_ref, bf16 and f32 out; the rule's picks (variant, "
          f"splits) -> rows: "
          f"{ {c: sorted(set(ms)) for c, ms in picked.items()} }")
    codes = torch.zeros((32, 1408), dtype=torch.int8, device="cuda")
    w_q = torch.zeros((1408, 1408), dtype=torch.int8, device="cuda")
    x_s = torch.ones((32, 1), device="cuda")
    w_s = torch.ones(1408, device="cuda")
    y = torch.zeros((32, 1408), dtype=torch.bfloat16, device="cuda")
    for what, call in (
            ("f16 out", lambda: int8_mm(codes, x_s, w_q, w_s, None,
                                        torch.float16)),
            ("K % 16 != 0", lambda: int8_mm(
                codes[:, :1400].contiguous(), x_s,
                w_q[:, :1400].contiguous(), w_s, None, torch.bfloat16)),
            ("N % 8 != 0", lambda: int8_mm(codes, x_s, w_q[:1404], w_s[:1404],
                                           None, torch.bfloat16)),
            ("a transposed x_q", lambda: int8_mm(
                w_q[:, :32].t(), x_s, w_q, w_s, None, torch.bfloat16)),
            ("x_q rows not 16 bytes apart", lambda: int8_mm(
                torch.zeros(32 * 1416, dtype=torch.int8, device="cuda")
                .as_strided((32, 1408), (1416, 1)), x_s, w_q, w_s, None,
                torch.bfloat16)),
            ("a transposed w_q", lambda: int8_mm(codes, x_s, w_q.t(), w_s,
                                                 None, torch.bfloat16)),
            ("f32 codes", lambda: int8_mm(codes.float(), x_s, w_q, w_s, None,
                                          torch.bfloat16)),
            ("a residual of another dtype", lambda: int8_mm(
                codes, x_s, w_q, w_s, None, torch.bfloat16, y.float())),
            ("K differing between the operands", lambda: int8_mm(
                codes, x_s, w_q[:, :1392].contiguous(), w_s, None,
                torch.bfloat16))):
        try:
            call()
        except (TypeError, ValueError):
            continue
        require(False, f"G1 took {what}")
    print("[kernels] G1 wrapper refuses f16 out, K % 16 != 0, N % 8 != 0, "
          "a transposed x_q or w_q, x_q rows not 16 bytes apart, f32 codes, "
          "a residual of another dtype, K differing between the operands")
    return worst


def int8_gemm_bound(m: int, k: int, n: int, dtype, with_bias: bool,
                    with_res: bool) -> dict:
    """G1's bound: 2 M N K int8 operations at the dense int8 rate, or the
    bytes (x_q, w_q, the scales and bias read once, the output written and
    the residual read in dtype), whichever takes longer."""
    size = 2 if dtype == torch.bfloat16 else 4
    moved = (m * k + n * k + m * 4 + n * 4 * (2 if with_bias else 1)
             + m * n * size * (2 if with_res else 1))
    return bound(moved, 2 * m * n * k, INT8_OP_PER_S)


def int8_gemm_times(variants: bool) -> tuple:
    """At every G1_FORMS product (M = 32896, the patch embedding 32768) and
    the head at B = 128, in bf16 and f32 out: G1 (int8_mm, the rule's
    variant; with variants, also each variant forced, in turns: every
    variant, then every variant again in reverse order) beside its bound,
    the plain version (int8_mm_ref), torch._int_mm alone and
    torch._int_mm + E3 (int8_epilogue), the chain G1 replaces. Where the
    checkout has no G1, its int8_mm (torch._int_mm + E3) and the rest.
    Returns (the kernels line's rows: qkv v2/v3, its bias, the kernels
    line's; every row, by tag)."""
    from hirest_tpu_torch.ops import quant

    kernel = hasattr(quant, "int8_gemm_shape")
    order = list(g1_variants()) if kernel and variants else []
    rows = {}
    seed = 2500
    for dtype in (torch.bfloat16, torch.float32):
        sfx = "" if dtype == torch.bfloat16 else "f32"
        for form, k, n, with_bias, with_res in (*G1_FORMS,
                                                ("head", *G1_HEAD, True,
                                                 False)):
            m = {"patch embed": BATCH * 256, "head": BATCH}.get(
                form, BATCH * TOKENS)
            seed += 1
            x_q, x_s, w_q, w_s, b, x = int8_gemm_inputs(
                m, k, n, seed, dtype, with_bias, with_res,
                head_rows=form == "head")
            x_c = x_q.contiguous()
            # no one PyTorch call computes G1's function: library_ms is
            # null, and torch._int_mm's product alone is int_mm_ms
            r = {"ms": None,
                 "plain_ms": cuda_ms(lambda: quant.int8_mm_ref(
                     x_q, x_s, w_q, w_s, b, dtype, x), 5)
                 if kernel else None,
                 "library_ms": None,
                 "int_mm_ms": cuda_ms(lambda: _INT_MM(x_c, w_q.t()), 20),
                 "int_mm_e3_ms": cuda_ms(lambda: quant.int8_epilogue(
                     _INT_MM(x_c, w_q.t()), x_s, w_s, b, dtype, x), 20),
                 **int8_gemm_bound(m, k, n, dtype, with_bias, with_res)}
            if kernel:
                r["ms"] = cuda_ms(lambda: quant.int8_mm(
                    x_q, x_s, w_q, w_s, b, dtype, x), 20)
                if hasattr(quant, "int8_gemm_config") and kernel:
                    try:
                        r["config"] = tuple(quant.int8_gemm_config(
                            m, n, k, dtype == torch.float32, x is not None))
                    except TypeError:  # an earlier rule, by K alone
                        r["config"] = quant.int8_gemm_config(
                            k, dtype == torch.float32, x is not None)
                mine = [v for v in order if dtype == torch.float32 or v not in
                        getattr(quant, "INT8_GEMM_F32_ONLY", ())]
                if order:
                    r["variants"] = {v: [] for v in mine}
                    for v in mine + mine[::-1]:
                        fn = g1_forced(quant, v)
                        r["variants"][v].append(cuda_ms(
                            lambda: fn(x_q, x_s, w_q, w_s, b, dtype, x), 20))
            rows[f"G1{sfx} {form} [{m},{k}]x[{k},{n}]"] = r
            if form == "qkv v2/v3":
                rows[f"G1{sfx}"] = r
            del x_q, x_s, w_q, w_s, b, x, x_c
    line = {key: rows[key] for key in ("G1", "G1f32")}
    return line, {k: v for k, v in rows.items() if k not in line}


# short products whose time the host's enqueue hides: (form, M, K, N,
# with the head's class-token rows)
G1_SHORT = (("head", BATCH, 1408, 1024, True), ("head", 2, 1408, 1024, True),
            ("qkv v2/v3", TOKENS, 1408, 4224, False),
            ("fc2", TOKENS, 6144, 1408, False))


def int8_gemm_short_times(card: str, tag: str) -> None:
    """G1 at G1_SHORT in bf16, each variant of this checkout's (the
    rule's first) in CUDA graphs: device time without the host's
    enqueue, beside the rule's choice and torch._int_mm's."""
    from hirest_tpu_torch.ops import quant

    names = g1_variants()
    for form, m, k, n, head in G1_SHORT:
        x_q, x_s, w_q, w_s, b, x = int8_gemm_inputs(
            m, k, n, 2700 + m, torch.bfloat16, True, form == "fc2",
            head_rows=head)
        x_c = torch.nn.functional.pad(x_q, (0, 0, 0, max(0, 17 - m)))
        ms = {"rule": graph_ms(lambda: quant.int8_mm(
                  x_q, x_s, w_q, w_s, b, torch.bfloat16, x)),
              "_int_mm": graph_ms(lambda: _INT_MM(x_c, w_q.t()))}
        for v in names:
            if v in quant.INT8_GEMM_F32_ONLY:
                continue
            fn = g1_forced(quant, v)
            ms[v] = graph_ms(lambda: fn(x_q, x_s, w_q, w_s, b,
                                        torch.bfloat16, x))
        config = quant.int8_gemm_config(m, n, k, False, x is not None)
        print(f"[{tag}] {card}: {REPO.name}: G1 {form} [{m},{k}]x[{k},{n}] "
              f"bf16, device ms in CUDA graphs: rule {tuple(config)} "
              f"{ms['rule']:.4f}, _int_mm {ms['_int_mm']:.4f}; "
              + ", ".join(f"{v} {ms[v]:.4f}" for v in names if v in ms))
        del x_q, x_s, w_q, w_s, b, x, x_c


def print_int8_gemm_times(rows: dict, card: str, tag: str) -> None:
    names = g1_variants() if any("variants" in r for r in rows.values()) \
        else {}
    for name, r in rows.items():
        kernel = ("missing" if r["ms"] is None else
                  f"{r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.3f} of bound)"
                  f"{', ' + str(r['config']) if 'config' in r else ''}")
        plain = ("missing" if r["plain_ms"] is None
                 else f"{r['plain_ms']:.4f} ms")
        print(f"[{tag}] {card}: {REPO.name}: {name}: G1 {kernel}, "
              f"_int_mm {r['int_mm_ms']:.4f} ms, _int_mm + E3 "
              f"{r['int_mm_e3_ms']:.4f} ms, plain {plain}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        for v, ms in r.get("variants", {}).items():
            print(f"[{tag}] {card}:   variant {v} ({names[v]}): "
                  f"{' / '.join(f'{t:.4f}' for t in ms)} ms "
                  f"({r['bound_ms'] / min(ms):.3f} of bound)")


# the int8 forwards --time-int8-gemm times: staged tower dtype (None: the
# unrolled int8 tower) -> (tag, flags of build_scanned_vision_apply,
# KERNEL_GROUPS set)
G1_TOWERS = (
    (torch.bfloat16, (
        ("production int8", dict(int8=True, attn_v3=True, fused_quant=True,
                                 fused_mlp=True), "int8"),
        ("ladder int8 dyn", dict(int8=True), "ladder int8 K8"),
        ("ladder int8+fq", dict(int8=True, fused_quant=True),
         "ladder int8 K8"),
        ("ladder int8+fq+v3", dict(int8=True, fused_quant=True,
                                   attn_v3=True), "ladder int8"))),
    (torch.float32, (
        ("ladder int8+fq+v3 in f32", dict(int8=True, fused_quant=True,
                                          attn_v3=True), "ladder f32 int8"),)),
    (None, (("unrolled int8", {}, "unrolled int8"),)),
)
G1_FORWARDS = 3  # timed forwards of B=128 a configuration, after a warm-up


def time_int8_gemm(cfg, card: str) -> None:
    """G1 at every shape it takes over beside its bound, torch._int_mm
    alone, torch._int_mm + E3 and the plain version, and every variant in
    turns (int8_gemm_times), after G1's registers and spills (ptxas), each
    variant's shared memory, ring and the clusters the card holds at once,
    and every variant's bit-for-bit check (int8_gemm_checks); then each G1_TOWERS forward at full width and depth on
    seeded weights: ms a forward and frames/s over G1_FORWARDS, and one
    profiled forward's groups. A checkout without G1 times torch._int_mm +
    E3 (its int8_mm) and its forwards, and an earlier G1 its own variants
    unchecked, so parent, change, change, parent in one call compares the
    two trees."""
    from hirest_tpu_torch.models.eva_quant import build_int8_vision_apply
    from hirest_tpu_torch.models.eva_scan import (build_scanned_vision_apply,
                                                  stage_scanned_params)
    from hirest_tpu_torch.ops import build, quant
    from hirest_tpu_torch.utils.init import random_eva_vision_state_dict

    kernel = "int8_gemm" in build.SOURCES
    logs = build.build()  # every source at once, as the forwards need them
    if kernel:
        ptxas_summary(logs.get("int8_gemm", ""), G1_KERNELS)
        if hasattr(quant, "int8_gemm_info"):
            print_int8_gemm_info("time-int8-gemm")
            int8_gemm_checks()
    else:
        print(f"[time-int8-gemm] {REPO}: G1 (csrc/int8_gemm.cu) is not in "
              f"this checkout: torch._int_mm + E3 alone")
    line, rows = int8_gemm_times(variants=kernel)
    print_int8_gemm_times({**line, **rows}, card, "time-int8-gemm")
    if kernel and hasattr(quant, "int8_gemm_info"):
        int8_gemm_short_times(card, "time-int8-gemm")
    t0 = time.perf_counter()
    sd = random_eva_vision_state_dict(cfg, seed=0)
    print(f"[time-int8-gemm] seeded weights drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    frames = normalize_frames(np.random.default_rng(5).integers(
        0, 256, (BATCH, 224, 224, 3), dtype=np.uint8))
    for dtype, runs in G1_TOWERS:
        staged = (None if dtype is None else
                  stage_scanned_params(sd, cfg, int8=True, dtype=dtype,
                                       device="cuda"))
        for tag, flags, groups in runs:
            fn = (build_int8_vision_apply(sd, cfg, device="cuda")
                  if dtype is None else
                  build_scanned_vision_apply(None, cfg, staged=staged,
                                             dtype=dtype, device="cuda",
                                             **flags))
            fn(frames)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(G1_FORWARDS):
                out = fn(frames)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            require(bool(torch.as_tensor(out).isfinite().all()),
                    f"{tag}: non-finite output")
            print(f"[time-int8-gemm] {card}: {REPO.name}: {tag}: "
                  f"{secs / G1_FORWARDS * 1e3:.2f} ms a forward of {BATCH}, "
                  f"{BATCH * G1_FORWARDS / secs:.2f} frames/s")
            profile_call(f"one {tag} forward B={BATCH}", lambda: fn(frames),
                         card, groups, tag="time-int8-gemm")
            del fn, out
        del staged
        torch.cuda.empty_cache()


# K3 and K9 int8's shapes in the kernels phase: (d, B, tokens, n_real):
# EVA-g's and the padded heads', the padding to 264 tokens, and the tiles'
# edges (a tile and one more row or key; the longest rows the staged first
# version took)
K3_SHAPES = tuple((d, batch, tokens, n_real) for d in (88, 128)
                  for batch, tokens, n_real in (
                      (2, TOKENS, 0), (BATCH, TOKENS, 0), (2, 264, TOKENS),
                      (BATCH, 264, TOKENS), (2, 33, 0), (2, 65, 0),
                      (2, 592 if d == 88 else 432, 0)))
# heads a block of K3's cluster epilogue -> its clusters
K3_VARIANTS = {1: "clusters of 16, one head a block",
               2: "clusters of 8, two heads a block"}


def k3_cluster_checks(heads: int) -> int:
    """K3's cluster epilogue (attention_qkv3.cu at 16 heads) bit for bit
    against the two-step epilogue of the same body (the library built with
    -DHIREST_QKV3_TWO_STEP=1: the f32 workspace, atomicMax and the second
    kernel) at every K3_SHAPES shape: through fused_attention_qkv3 and
    fused_attention_qkv2 (the variant the card's rule picks) and each
    K3_VARIANTS variant forced, codes and scales, the counts of differing
    values printed (bar 0). Prints what cudaOccupancyMaxActiveClusters
    gives each variant. Returns the differing values in all."""
    from hirest_tpu_torch.ops import attention

    for d in (88, 128):
        info = attention.qkv3_cluster_info(d)
        print(f"[kernels] K3 cluster epilogue d={d}: "
              f"cudaOccupancyMaxActiveClusters {info['clusters_of_16']} "
              f"clusters of 16 ({16 * info['clusters_of_16']} SMs), "
              f"{info['clusters_of_8']} of 8 ({8 * info['clusters_of_8']} "
              f"SMs); the launch takes {info['heads_per_block']} head(s) a "
              f"block ({K3_VARIANTS[info['heads_per_block']]})")
    total = 0
    for i, (d, batch, tokens, n_real) in enumerate(K3_SHAPES):
        qkv = attention_inputs(batch, seed=200 + i, tokens=tokens,
                               hd=heads * d)
        args = (qkv, d ** -0.5, heads)
        want = attention._launch_qkv3(*args, True, n_real, two_step=True)
        calls = {"K3": lambda: attention.fused_attention_qkv3(
                     *args, quant_out=True, n_real=n_real),
                 "K9 int8": lambda: attention.fused_attention_qkv2(
                     *args, quant_out=True, n_real=n_real),
                 **{f"{h} head(s) a block": (
                     lambda h=h: attention._launch_qkv3(
                         *args, True, n_real, heads_per_block=h))
                    for h in K3_VARIANTS}}
        counts = {name: differing(call(), want, f"K3 {name}")
                  for name, call in calls.items()}
        total += sum(counts.values())
        print(f"[kernels] K3 cluster epilogue vs two-step [{batch},{tokens},"
              f"{3 * heads * d}] n_real={n_real}: differing codes and "
              f"scales " + ", ".join(f"{k} {n}" for k, n in counts.items())
              + " (bar 0)")
        require(not any(counts.values()),
                f"K3 cluster epilogue off the two-step one at [{batch},"
                f"{tokens},{3 * heads * d}] n_real={n_real}: {counts}")
    return total


# K8 int8's shapes in the kernels phase: (d, B, tokens): EVA-g's and the
# padded heads', at B = 2 and 128, and the tiles' edges (a tile and one
# more row or key; 600 keys)
K8_SHAPES = tuple((d, batch, tokens) for d in (88, 128)
                  for batch, tokens in ((2, TOKENS), (BATCH, TOKENS),
                                        (2, 33), (2, 65), (2, 600)))


def k8_cluster_checks(heads: int) -> int:
    """K8 int8's cluster epilogue (attention_qkv3.cu's v1 form at 16
    heads, nonzero biases) bit for bit against the two-step epilogue of
    the same body (the -DHIREST_QKV3_TWO_STEP=1 build) at every K8_SHAPES
    shape: through fused_attention_qkv (the variant the card's rule picks)
    and each K3_VARIANTS variant forced, codes and scales, the counts of
    differing values printed (bar 0). Prints what
    cudaOccupancyMaxActiveClusters gives each variant of the v1 form.
    Returns the differing values in all."""
    from hirest_tpu_torch.ops import attention

    for d in (64, 88, 128):
        info = attention.qkv3_cluster_info(d, v1=True)
        print(f"[kernels] K8 int8 cluster epilogue d={d}: "
              f"cudaOccupancyMaxActiveClusters {info['clusters_of_16']} "
              f"clusters of 16, {info['clusters_of_8']} of 8; the launch "
              f"takes {K3_VARIANTS[info['heads_per_block']]}")
    total = 0
    for i, (d, batch, tokens) in enumerate(K8_SHAPES):
        qkv = attention_inputs(batch, seed=300 + i, tokens=tokens,
                               hd=heads * d)
        qb, vb = biases(heads * d, seed=350 + i)
        scale = d ** -0.5
        q, k, v = split_views(qkv, heads)
        bq, bv = (attention._bias_arg(t, heads * d, qkv.device)
                  for t in (qb, vb))
        want = attention._launch_v1(q, k, v, None, None, scale, bq, bv,
                                    two_step=True)
        calls = {"K8 int8": lambda: attention.fused_attention_qkv(
                     qkv, qb, vb, scale, heads, quant_out=True),
                 **{f"{h} head(s) a block": (
                     lambda h=h: attention._launch_v1(
                         q, k, v, None, None, scale, bq, bv,
                         heads_per_block=h))
                    for h in K3_VARIANTS}}
        counts = {name: differing(call(), want, f"K8 int8 {name}")
                  for name, call in calls.items()}
        total += sum(counts.values())
        print(f"[kernels] K8 int8 cluster epilogue vs two-step [{batch},"
              f"{tokens},{3 * heads * d}]: differing codes and scales "
              + ", ".join(f"{k} {n}" for k, n in counts.items())
              + " (bar 0)")
        require(not any(counts.values()),
                f"K8 int8 cluster epilogue off the two-step one at [{batch},"
                f"{tokens},{3 * heads * d}]: {counts}")
    return total


def phase_kernels(cfg) -> dict:
    """Every kernel against its plain version at the main paths' shapes."""
    from hirest_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_packed,
                                                fused_attention_packed_ref,
                                                fused_attention_qkv,
                                                fused_attention_qkv2,
                                                fused_attention_qkv2_ref,
                                                fused_attention_qkv3,
                                                fused_attention_qkv3_ref,
                                                fused_attention_qkv_ref,
                                                fused_attention_ref)
    from hirest_tpu_torch.ops.quant import (_mlp_hidden_launch,
                                            fused_mlp_int8,
                                            fused_mlp_int8_ref,
                                            mlp_int8_hidden_ref)

    scale, heads = cfg.head_width ** -0.5, cfg.num_heads
    worst = {"K1": 0.0, "K3": 0.0, "K4": 0.0, "K6": 0.0, "K7": 0.0}
    for d in (88, 128):  # the native head width, and the padded one
        for batch in (2, BATCH):
            qkv = attention_inputs(batch, seed=batch + d - 88, hd=heads * d)
            err = check_close(
                f"K1 fused_attention_qkv3 d={d} B={batch}",
                fused_attention_qkv3(qkv, d ** -0.5, heads),
                fused_attention_qkv3_ref(qkv, d ** -0.5, heads))
            if d == 88:
                worst["K1"] = max(worst["K1"], err)

    # K3: codes within one, equal on 99 %, scales within 2^-7 (p is rounded
    # to bf16 and may round the other way under another summation order)
    for d, batch, tokens, n_real in ((88, 2, TOKENS, 0), (88, 2, 264, TOKENS),
                                     (88, BATCH, TOKENS, 0),
                                     (128, 2, TOKENS, 0),
                                     (128, BATCH, TOKENS, 0)):
        qkv = attention_inputs(batch, seed=10 + batch + tokens + d - 88,
                               tokens=tokens, hd=heads * d)
        got = fused_attention_qkv3(qkv, d ** -0.5, heads, quant_out=True,
                                   n_real=n_real)
        want = fused_attention_qkv3_ref(qkv, d ** -0.5, heads,
                                        quant_out=True, n_real=n_real)
        err = check_codes(
            f"K3 attention quant_out [{batch},{tokens},{3 * heads * d}] "
            f"n_real={n_real}", got, want, 0.99, 2 ** -7)
        if d == 88:
            worst["K3"] = max(worst["K3"], err)

    # K1 and K3 where the 64-row query tiles and 64-key tiles meet their
    # edges: 33 and 65 tokens (a tile and one more row or key), the longest
    # rows the staged first version took (592 at d=88, 432 at d=128), and
    # pad keys (n_real < S) with bf16 out, at B=2 and 128; same bars. Their
    # errors are printed apart: the kernels line keeps the main path's.
    edge = {"K1": 0.0, "K3": 0.0}
    for d, batch, tokens, n_real in (
            (88, 2, 33, 0), (88, 2, 65, 0), (128, 2, 33, 0), (128, 2, 65, 0),
            (88, 2, 592, 0), (128, 2, 432, 0), (88, 2, 264, TOKENS),
            (128, 2, 264, TOKENS), (88, BATCH, 264, TOKENS),
            (128, BATCH, 264, TOKENS)):
        qkv = attention_inputs(batch, seed=100 + batch + tokens + d,
                               tokens=tokens, hd=heads * d)
        shape = f"[{batch},{tokens},{3 * heads * d}] n_real={n_real}"
        edge["K1"] = max(edge["K1"], check_close(
            f"K1 fused_attention_qkv3 {shape}",
            fused_attention_qkv3(qkv, d ** -0.5, heads, n_real=n_real),
            fused_attention_qkv3_ref(qkv, d ** -0.5, heads, n_real=n_real)))
        edge["K3"] = max(edge["K3"], check_codes(
            f"K3 attention quant_out {shape}",
            fused_attention_qkv3(qkv, d ** -0.5, heads, quant_out=True,
                                 n_real=n_real),
            fused_attention_qkv3_ref(qkv, d ** -0.5, heads, quant_out=True,
                                     n_real=n_real), 0.99, 2 ** -7))
    print(f"[kernels] K1/K3 at the tiles' edges: K1 max_abs_err="
          f"{edge['K1']}, K3 max_abs_err (dequantized)={edge['K3']}")

    # K6 and K7 at K1's bar, on the unrolled towers' shapes: split-heads
    # views of one qkv projection (d=88), packed heads (d=128), and the
    # masked cross-attention shape in each layout
    for batch in (2, BATCH):
        q, k, v = split_views(attention_inputs(batch, seed=40 + batch))
        worst["K6"] = max(worst["K6"], check_close(
            f"K6 fused_attention [{batch},16,257,88]",
            fused_attention(q, k, v, scale), fused_attention_ref(q, k, v,
                                                                 scale)))
        q, k, v = attention_inputs(batch, seed=50 + batch,
                                   hd=PADDED_HD).chunk(3, -1)
        worst["K7"] = max(worst["K7"], check_close(
            f"K7 fused_attention_packed [{batch},257,16*128]",
            fused_attention_packed(q, k, v, 128 ** -0.5, heads),
            fused_attention_packed_ref(q, k, v, 128 ** -0.5, heads)))
    q, k, v, mask = masked_inputs(seed=60)
    worst["K6"] = max(worst["K6"], check_close(
        "K6 fused_attention [2,12,48,64] over 20 keys, 15 valid",
        fused_attention(q, k, v, 0.125, mask),
        fused_attention_ref(q, k, v, 0.125, mask)))
    q, k, v, mask = masked_inputs(seed=61, heads=16, d=128)
    packed = [t.transpose(1, 2).flatten(2) for t in (q, k, v)]
    worst["K7"] = max(worst["K7"], check_close(
        "K7 fused_attention_packed [2,48,16*128] over 20 keys, 15 valid",
        fused_attention_packed(*packed, 128 ** -0.5, heads, mask),
        fused_attention_packed_ref(*packed, 128 ** -0.5, heads, mask)))
    # the v1 form's edges: a batch row whose keys are all masked
    # (uniform p, as -1e30 gives), and 600 keys (ten key tiles through the
    # ring, the last of 24 keys) over 33 queries (one consumer's 64-row
    # tile, part of it past Sq)
    q, k, v, mask = masked_inputs(seed=62, valid=(15, 0))
    worst["K6"] = max(worst["K6"], check_close(
        "K6 fused_attention [2,12,48,64] over 20 keys, 15 and 0 valid",
        fused_attention(q, k, v, 0.125, mask),
        fused_attention_ref(q, k, v, 0.125, mask)))
    q, k, v, mask = masked_inputs(seed=63, valid=(15, 0), heads=16, d=128)
    packed = [t.transpose(1, 2).flatten(2) for t in (q, k, v)]
    worst["K7"] = max(worst["K7"], check_close(
        "K7 fused_attention_packed [2,48,16*128] over 20 keys, 15 and 0 "
        "valid", fused_attention_packed(*packed, 128 ** -0.5, heads, mask),
        fused_attention_packed_ref(*packed, 128 ** -0.5, heads, mask)))
    q, k, v, mask = masked_inputs(seed=64, sq=33, sk=600, valid=(590, 600),
                                  heads=16, d=88)
    worst["K6"] = max(worst["K6"], check_close(
        "K6 fused_attention [2,16,33,88] over 600 keys, 590 and 600 valid",
        fused_attention(q, k, v, scale, mask),
        fused_attention_ref(q, k, v, scale, mask)))
    q, k, v, _ = masked_inputs(seed=65, sq=33, sk=600, heads=16, d=128)
    packed = [t.transpose(1, 2).flatten(2) for t in (q, k, v)]
    worst["K7"] = max(worst["K7"], check_close(
        "K7 fused_attention_packed [2,33,16*128] over 600 keys",
        fused_attention_packed(*packed, 128 ** -0.5, heads),
        fused_attention_packed_ref(*packed, 128 ** -0.5, heads)))
    # K4's first kernel: its codes and scales must equal the plain
    # version's (the products are exact and every f32 step rounds where the
    # plain version rounds), at every tail of its persistent walk, for
    # both activations, with rows whose chunk maximum lies in each block of
    # a cluster and an all-zero row (k4_stage_inputs)
    for m in K4_STAGE_ROWS:
        for zero in (False, True):
            args = k4_stage_inputs(m, seed=30 + m % 1000, zero_row=zero)
            for act in ("gelu_poly", "gelu"):
                codes, scales = _mlp_hidden_launch(*args, act)
                want_codes, want_scales = mlp_int8_hidden_ref(*args, act=act)
                torch.cuda.synchronize()
                n_codes = int((codes != want_codes).sum().item())
                n_scales = int((scales != want_scales).sum().item())
                floor = int((want_scales == 1e-8).sum().item())
                print(f"[kernels] K4 mlp_hidden [{m},1408]x6144 act={act}"
                      f"{' zero row' if zero else ''}: {n_codes} of "
                      f"{codes.numel()} codes and {n_scales} of "
                      f"{scales.numel()} scales differ (bar 0), {floor} "
                      f"scales at the floor")
                require(n_codes == 0 and n_scales == 0 and floor >= zero *
                        scales.shape[1], f"K4 mlp_hidden [{m}] {act} off "
                        f"its plain version")
    # K4 whole: within 1e-2 of the MLP's largest contribution max|want - x|
    # plus one bf16 ulp of |want|, element by element: a hidden code that
    # lands on the other side of a rounding boundary moves a row by far less
    for batch in (2, BATCH):
        args = mlp_inputs(batch * TOKENS, seed=30 + batch)
        for act in ("gelu_poly", "gelu"):
            got = fused_mlp_int8(*args, act=act)
            torch.cuda.synchronize()
            want = fused_mlp_int8_ref(*args, act=act).float()
            contrib = (want - args[-1].float()).abs().max().item()
            ulp = torch.ldexp(torch.ones_like(want),
                              torch.frexp(want)[1] - 8)
            excess = ((got.float() - want).abs() - 1e-2 * contrib - ulp)
            err = (got.float() - want).abs().max().item()
            n_out = int((got.float() != want).sum().item())
            print(f"[kernels] K4 fused_mlp_int8 [{batch * TOKENS},1408]x6144 "
                  f"act={act}: {n_out} of {got.numel()} outputs differ, "
                  f"max_abs_err={err} max|want-x|={contrib} "
                  f"worst excess over the bar={excess.max().item()}")
            require(bool(got.isfinite().all()) and excess.max().item() <= 0,
                    f"fused_mlp_int8 [{batch * TOKENS}] {act} off its plain "
                    f"version")
            worst["K4"] = max(worst["K4"], err)

    # K8 with nonzero biases: bf16 out at K6's bar, int8 out at K3's; at
    # B=2 and 128, at head width 128, and over 600 tokens (more than the
    # first version's staged head held in shared memory)
    worst["K8"] = worst["K8q"] = 0.0
    for batch, tokens, d, h in ((2, TOKENS, 88, heads), (BATCH, TOKENS, 88, heads),
                                (2, TOKENS, 128, heads), (2, 600, 88, heads),
                                (2, 50, 64, 12)):
        qkv = attention_inputs(batch, seed=80 + batch + tokens + d,
                               tokens=tokens, hd=h * d)
        qb, vb = biases(h * d, seed=81 + d)
        shape = f"[{batch},{tokens},{qkv.shape[-1]}]"
        err = check_close(
            f"K8 fused_attention_qkv {shape} biased",
            fused_attention_qkv(qkv, qb, vb, d ** -0.5, h),
            fused_attention_qkv_ref(qkv, qb, vb, d ** -0.5, h))
        errq = check_codes(
            f"K8 fused_attention_qkv quant_out {shape} biased ({h} heads)",
            fused_attention_qkv(qkv, qb, vb, d ** -0.5, h,
                                quant_out=True),
            fused_attention_qkv_ref(qkv, qb, vb, d ** -0.5, h,
                                    quant_out=True), 0.99, 2 ** -7)
        if d == 88:  # EVA-g's head width, the ladder's
            worst["K8"] = max(worst["K8"], err)
            worst["K8q"] = max(worst["K8q"], errq)

    # K9 at K1's and K3's bars, also padded to 264 tokens with n_real
    qkv = attention_inputs(BATCH, seed=82)
    worst["K9"] = check_close(
        f"K9 fused_attention_qkv2 [{BATCH},{TOKENS},{qkv.shape[-1]}]",
        fused_attention_qkv2(qkv, scale, heads),
        fused_attention_qkv2_ref(qkv, scale, heads))
    worst["K9q"] = 0.0
    for batch, tokens, n_real in ((BATCH, TOKENS, 0), (2, 264, TOKENS)):
        qkv = attention_inputs(batch, seed=83 + batch, tokens=tokens)
        worst["K9q"] = max(worst["K9q"], check_codes(
            f"K9 fused_attention_qkv2 quant_out [{batch},{tokens},"
            f"{qkv.shape[-1]}] n_real={n_real}",
            fused_attention_qkv2(qkv, scale, heads, quant_out=True,
                                 n_real=n_real),
            fused_attention_qkv2_ref(qkv, scale, heads, quant_out=True,
                                     n_real=n_real), 0.99, 2 ** -7))

    k3_cluster_checks(heads)
    k8_cluster_checks(heads)
    f32 = f32_checks()
    worst["K6"] = max(worst["K6"], f32.pop("K6"))
    worst.update(f32)
    worst.update(f32_int8_checks())
    worst.update(row_checks()[0])
    worst.update(epilogue_checks())
    worst.update(int8_epilogue_checks())
    worst.update(int8_gemm_checks())
    return worst


def run_videos(cfg, encoders: dict, frames: dict, tag: str) -> tuple:
    """Every synthetic video through each encoder, with the launch counts
    zeroed before and read after. Returns (features, counts, forwards)."""
    from hirest_tpu_torch.extraction.features import finish_video_features

    zero_counts()
    forwards = 0
    feats = {}
    t0 = time.perf_counter()
    for u8, enc in encoders.items():
        for vid, (n, duration) in VIDEOS.items():
            embs = []
            for i in range(0, n, BATCH):
                chunk = frames[vid][i: i + BATCH]
                k = len(chunk)
                batch = np.zeros((BATCH, 224, 224, 3), np.uint8)
                batch[:k] = chunk
                embs.append(enc(batch if u8 else normalize_frames(batch))[:k])
                forwards += 1
            feats[u8, vid] = finish_video_features(embs, duration=duration)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[main] {tag}: {forwards} forwards of {BATCH} frames in "
          f"{time.perf_counter() - t0:.2f} s; launches {counts}")
    for vid, (n, duration) in VIDEOS.items():
        f, fu = feats[False, vid], feats[True, vid]
        want = (round(duration), cfg.embed_dim)
        require(f.shape == want and fu.shape == want,
                f"{tag} {vid}: shape {f.shape}/{fu.shape}, expected {want}")
        require(bool(np.isfinite(f).all() and np.isfinite(fu).all()),
                f"{tag} {vid}: non-finite features")
        require(bool(np.allclose(np.linalg.norm(f, axis=-1), 1, atol=1e-3)
                     and np.allclose(np.linalg.norm(fu, axis=-1), 1,
                                     atol=1e-3)),
                f"{tag} {vid}: features not L2-normalized")
        cos = cosine(f, fu).min()
        print(f"[main] {tag} {vid}: {f.shape} finite, unit norm; "
              f"min cosine float vs uint8 front end = {cos:.6f}")
        require(cos >= COS_MIN, f"{tag} {vid}: uint8 front end off the "
                                f"float one")
    return feats, counts, forwards


def phase_main(cfg, pretrained: Path) -> dict:
    """The extraction encoders on a few videos: bf16 then int8, each with
    the float and the uint8 front end."""
    from hirest_tpu_torch.extraction.features import make_eva_encoder

    rng = np.random.default_rng(0)
    frames = {v: rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
              for v, (n, _) in VIDEOS.items()}
    encoders, launches, feats = {}, {}, {}
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        t0 = time.perf_counter()
        encoders[tag] = {u8: make_eva_encoder(str(pretrained), int8=int8,
                                              uint8_frontend=u8,
                                              device="cuda")[0]
                         for u8 in (False, True)}
        print(f"[main] {tag}: two full-width encoders staged in "
              f"{time.perf_counter() - t0:.1f} s")
        feats[tag], counts, fw = run_videos(cfg, encoders[tag], frames, tag)
        n = cfg.layers * fw
        want = (expect(K2=2 * n, K3=n, K4=n, G1=2 * n) if int8
                else expect(K1=n, E1=2 * n, E2=2 * n))
        require(counts == want, f"{tag} launches {counts}, expected {want}")
        launches.update({k: v for k, v in counts.items() if want[k]})
    cos = min(cosine(feats["int8"][False, v], feats["bf16"][False, v]).min()
              for v in VIDEOS)
    print(f"[main] int8 vs bf16 features (float front end): min cosine "
          f"{cos:.6f}")
    return {"launches": launches, "encoders": encoders, "frames": frames,
            "features": {vid: feats["int8"][False, vid] for vid in VIDEOS}}


def factory_weights(cfg, text_cfg, pretrained: Path) -> dict:
    """One `text.*` / `visual.*` state dict for every factory build: the
    checkpoint when there is one, else one draw of seeded random weights."""
    from hirest_tpu_torch.models.convert import load_torch_ckpt
    from hirest_tpu_torch.utils.init import (random_eva_text_state_dict,
                                             random_eva_vision_state_dict)

    ckpt = pretrained / "eva_clip_psz14.pt"
    if ckpt.exists():
        return load_torch_ckpt(str(ckpt))
    t0 = time.perf_counter()
    sd = {**{f"text.{k}": v for k, v in
             random_eva_text_state_dict(text_cfg, seed=0).items()},
          **{f"visual.{k}": v for k, v in
             random_eva_vision_state_dict(cfg, seed=0).items()}}
    print(f"[factory] seeded random weights drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    return sd


def prompt_ids(n: int, seed: int, text_cfg) -> np.ndarray:
    """Token ids [n, 77] as the tokenizer gives them: tokens below the EOT
    id (the vocabulary's last), EOT at varied positions, zeros after."""
    ctx, eot = text_cfg.context_length, text_cfg.vocab_size - 1
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, eot, size=(n, ctx))
    ends = rng.integers(1, ctx, size=n)
    for row, end in zip(ids, ends):
        row[end] = eot
        row[end + 1:] = 0
    return ids


# factory configuration -> (its options, launches per image forward)
FACTORY = {
    "unrolled": (dict(scan=False), dict(K6=1)),
    "padded_unrolled": (dict(scan=False, padded_heads=True), dict(K7=1)),
    "padded_scanned": (dict(scan=True, padded_heads=True),
                       dict(K1=1, E1=2, E2=2)),
    "padded_scanned_int8": (dict(scan=True, padded_heads=True, int8=True),
                            dict(K2=2, K3=1, K4=1, G1=2)),
}


def phase_factory(cfg, text_cfg, weights: dict) -> dict:
    """build_eva_model_and_transforms at full width on the card: the text
    tower on PROMPTS prompts, and every image configuration of FACTORY on
    FACTORY_FORWARDS forwards of B=128, with the launch counts zeroed
    before each run and read after it."""
    from hirest_tpu_torch.models.eva_clip import build_eva_model_and_transforms

    frames = normalize_frames(np.random.default_rng(2).integers(
        0, 256, (BATCH, 224, 224, 3), dtype=np.uint8))
    models, feats, launches = {}, {}, {}
    for tag, (options, per_forward) in FACTORY.items():
        t0 = time.perf_counter()
        models[tag] = build_eva_model_and_transforms(
            pretrained=weights, device="cuda", text_config=text_cfg,
            vision_config=cfg, **options)[0]
        torch.cuda.synchronize()
        print(f"[factory] {tag}: built in {time.perf_counter() - t0:.1f} s")
        zero_counts()
        for _ in range(FACTORY_FORWARDS):
            out = models[tag].encode_image(frames)
        torch.cuda.synchronize()
        counts = read_counts()
        want = expect(**{k: v * cfg.layers * FACTORY_FORWARDS
                         for k, v in per_forward.items()})
        print(f"[factory] {tag}: {FACTORY_FORWARDS} forwards of {BATCH} "
              f"frames; launches {counts}")
        require(counts == want, f"{tag} launches {counts}, expected {want}")
        require(tuple(out.shape) == (BATCH, cfg.embed_dim)
                and bool(out.isfinite().all()), f"{tag}: output {out.shape}")
        feats[tag] = out.cpu().numpy()
        launches.update({k: v for k, v in counts.items() if want[k]})
    for tag in ("padded_unrolled", "padded_scanned"):  # same function
        cos = cosine(feats[tag], feats["unrolled"]).min()
        print(f"[factory] {tag} vs unrolled: min cosine {cos:.6f} "
              f"(>= {COS_MIN})")
        require(cos >= COS_MIN, f"{tag} off the unrolled tower")
    cos = cosine(feats["padded_scanned_int8"], feats["padded_scanned"]).min()
    print(f"[factory] padded int8 vs padded bf16: min cosine {cos:.6f} "
          f"(>= {COS_INT8_VS_FLOAT})")
    require(cos >= COS_INT8_VS_FLOAT, "padded int8 off padded bf16")

    ids = prompt_ids(PROMPTS, seed=3, text_cfg=text_cfg)
    zero_counts()
    text = torch.cat([models["unrolled"].encode_text(ids[i: i + BATCH])
                      for i in range(0, PROMPTS, BATCH)])
    torch.cuda.synchronize()
    print(f"[factory] encode_text: {tuple(text.shape)} from {PROMPTS} "
          f"prompts, EOT at positions {int(ids.argmax(1).min())}.."
          f"{int(ids.argmax(1).max())}; launches {read_counts()}")
    require(tuple(text.shape) == (PROMPTS, text_cfg.embed_dim)
            and bool(text.isfinite().all()) and read_counts() == expect(),
            "encode_text output")
    return {"models": models, "frames": frames, "ids": ids,
            "launches": launches}


# ladder configuration -> (flags of build_scanned_vision_apply, launches
# per layer); bench.py's ladder tags (:817-823) less the TPU layout flags.
# E1 takes the qkv bias where v2/v3 fold it into the projection, and fc1's
# bias and GELU (int8 dyn: its GELU); E2 proj's and fc2's bias + residual;
# G1 each int8 product with its epilogue (the residual after out and fc2);
# int8 dyn's four row quantizations run K5 without an activation
LADDER = {
    "bf16": ({}, dict(K8=1, E1=1, E2=2)),
    "bf16+v2": (dict(attn_v2=True), dict(K9=1, E1=2, E2=2)),
    "bf16+v3+lnk": (dict(attn_v3=True, fused_ln=True),
                    dict(K1=1, K10=2, E1=2, E2=2)),
    "int8": (dict(int8=True), dict(K8=1, E1=1, G1=4, K5=4)),
    "int8+fq": (dict(int8=True, fused_quant=True),
                dict(K2=2, K5=1, K8q=1, G1=4)),
    "int8+fq+v2": (dict(int8=True, fused_quant=True, attn_v2=True),
                   dict(K2=2, K5=1, K9q=1, G1=4)),
    "int8+fq+v3": (dict(int8=True, fused_quant=True, attn_v3=True),
                   dict(K2=2, K3=1, K5=1, G1=4)),
}
LADDER_FORWARDS = 2  # image forwards of B=128 per ladder configuration


def phase_ladder(cfg, weights: dict) -> dict:
    """Every configuration of LADDER at full width, on one bf16 and one int8
    tower staged once (stage_scanned_params), LADDER_FORWARDS forwards of
    B=128 each with the launch counts zeroed before and read after. Returns
    the forwards, their frames and the launches summed over the runs."""
    from hirest_tpu_torch.models.eva_scan import (build_scanned_vision_apply,
                                                  stage_scanned_params)

    frames = normalize_frames(np.random.default_rng(5).integers(
        0, 256, (BATCH, 224, 224, 3), dtype=np.uint8))
    staged = {}
    for int8 in (False, True):
        t0 = time.perf_counter()
        staged[int8] = stage_scanned_params(weights, cfg, int8=int8,
                                            device="cuda")
        torch.cuda.synchronize()
        print(f"[ladder] {'int8' if int8 else 'bf16'} tower staged in "
              f"{time.perf_counter() - t0:.1f} s")
    fns, feats, launches = {}, {}, {}
    for tag, (flags, per_forward) in LADDER.items():
        fns[tag] = build_scanned_vision_apply(
            None, cfg, staged=staged[bool(flags.get("int8"))], device="cuda",
            **flags)
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(LADDER_FORWARDS):
            out = fns[tag](frames)
        torch.cuda.synchronize()
        counts = read_counts()
        want = expect(**{k: v * cfg.layers * LADDER_FORWARDS
                         for k, v in per_forward.items()})
        print(f"[ladder] {tag}: {LADDER_FORWARDS} forwards of {BATCH} frames "
              f"in {time.perf_counter() - t0:.2f} s; launches {counts}")
        require(counts == want, f"ladder {tag} launches {counts}, expected "
                                f"{want}")
        require(tuple(out.shape) == (BATCH, cfg.embed_dim)
                and bool(out.isfinite().all()), f"ladder {tag}: output "
                                                f"{tuple(out.shape)}")
        feats[tag] = out.cpu().numpy()
        for k, n in counts.items():
            if n:
                launches[k] = launches.get(k, 0) + n
    for tag, (flags, _) in LADDER.items():
        bar = COS_INT8_VS_FLOAT if flags.get("int8") else COS_MIN
        cos = cosine(feats[tag], feats["bf16"]).min()
        print(f"[ladder] {tag} vs bf16 at full depth: min cosine {cos:.6f} "
              f"(>= {bar})")
        require(cos >= bar, f"ladder {tag} off the bf16 forward")
    return {"fns": fns, "frames": frames, "launches": launches}


def phase_ladder_depth(cfg, frames) -> None:
    """Each LADDER configuration cut to 2 layers, on the card in bf16
    against the plain path on the CPU in f32 with the same flags: cosine
    >= 0.99 (bf16 vs float, int8 vs int8), and int8 >= 0.98 against the
    CPU float forward."""
    from dataclasses import replace

    from hirest_tpu_torch.models.eva_scan import build_scanned_vision_apply
    from hirest_tpu_torch.utils.init import random_eva_vision_state_dict

    cut = replace(cfg, layers=2)
    sd = random_eva_vision_state_dict(cut, seed=0)
    cpu_float = None
    for tag, (flags, _) in LADDER.items():
        ref = build_scanned_vision_apply(sd, cut, device="cpu",
                                         dtype=torch.float32,
                                         **flags)(frames).numpy()
        got = build_scanned_vision_apply(sd, cut, device="cuda",
                                         **flags)(frames).cpu().numpy()
        cpu_float = ref if cpu_float is None else cpu_float
        checks = [("card vs f32 CPU plain, same flags", ref, COS_MIN)]
        if flags.get("int8"):
            checks.append(("card vs float f32 CPU plain", cpu_float,
                           COS_INT8_VS_FLOAT))
        for what, want, bar in checks:
            cos = cosine(got, want).min()
            print(f"[depth] 2 layers, ladder {tag}, {what}: cosine "
                  f"min={cos:.6f} (>= {bar})")
            require(got.shape == (len(frames), cfg.embed_dim)
                    and bool(cos >= bar), f"2-layer ladder {tag} {what} "
                                          f"below {bar}")


def phase_depth(cfg, pretrained: Path) -> np.ndarray:
    """The same weights at 2 layers: the card's bf16 and int8 forwards
    against the plain path on the CPU in f32. Returns the 4 frames used."""
    from dataclasses import replace

    from hirest_tpu_torch.models.convert import load_torch_ckpt
    from hirest_tpu_torch.models.eva_scan import build_scanned_vision_apply
    from hirest_tpu_torch.utils.init import random_eva_vision_state_dict

    cut = replace(cfg, layers=2)
    ckpt = pretrained / "eva_clip_psz14.pt"
    # random init draws blocks in order, so 2 layers are the first 2 of 40
    sd = (load_torch_ckpt(str(ckpt)) if ckpt.exists()
          else random_eva_vision_state_dict(cut, seed=0))
    frames = normalize_frames(np.random.default_rng(1).integers(
        0, 256, (4, 224, 224, 3), dtype=np.uint8))

    def run(device, int8):
        dtype = torch.bfloat16 if device == "cuda" else torch.float32
        out = build_scanned_vision_apply(sd, cut, int8=int8, attn_v3=True,
                                         fused_quant=int8, fused_mlp=int8,
                                         device=device, dtype=dtype)(frames)
        return out.cpu().numpy()

    cpu_float, cpu_int8 = run("cpu", False), run("cpu", True)
    for int8, ref, bar, what in (
            (False, cpu_float, COS_MIN, "bf16 card vs f32 CPU plain"),
            (True, cpu_int8, COS_MIN, "int8 bf16 card vs int8 f32 CPU plain"),
            (True, cpu_float, COS_INT8_VS_FLOAT,
             "int8 bf16 card vs float f32 CPU plain")):
        got = run("cuda", int8)
        cos = cosine(got, ref)
        print(f"[depth] 2 layers, {what}: cosine min={cos.min():.6f} "
              f"(>= {bar})")
        require(got.shape == (4, cfg.embed_dim) and bool(cos.min() >= bar),
                f"2-layer {what} below {bar}")
    return frames


def phase_factory_depth(cfg, text_cfg, weights: dict, frames) -> dict:
    """The factory's towers cut to 2 layers, on the card in bf16 against the
    unpadded plain paths on the CPU in f32, at cosine >= 0.99: the text
    tower, the unrolled tower, the padded unrolled tower against the
    unrolled one and the padded scanned tower against the scanned one.
    Returns the CPU's outputs (image by scan, text) and the prompts."""
    from dataclasses import replace

    from hirest_tpu_torch.models.eva_clip import build_eva_model_and_transforms

    cuts = dict(text_config=replace(text_cfg, layers=2),
                vision_config=replace(cfg, layers=2))
    ids = prompt_ids(8, seed=4, text_cfg=text_cfg)

    def build(device, **options):
        dtype = torch.bfloat16 if device == "cuda" else torch.float32
        return build_eva_model_and_transforms(
            pretrained=weights, device=device, dtype=dtype, **cuts,
            **options)[0]

    cpu = {scan: build("cpu", scan=scan) for scan in (False, True)}
    ref_text = cpu[False].encode_text(ids).numpy()
    ref_image = {scan: m.encode_image(frames).numpy()
                 for scan, m in cpu.items()}
    for what, options, ref in (
            ("unrolled", dict(scan=False), ref_image[False]),
            ("padded unrolled vs unpadded", dict(scan=False,
                                                 padded_heads=True),
             ref_image[False]),
            ("padded scanned vs unpadded", dict(scan=True,
                                                padded_heads=True),
             ref_image[True])):
        model = build("cuda", **options)
        cos = cosine(model.encode_image(frames).cpu().numpy(), ref)
        print(f"[depth] 2 layers, {what}: bf16 card vs f32 CPU plain: "
              f"cosine min={cos.min():.6f} (>= {COS_MIN})")
        require(bool(cos.min() >= COS_MIN), f"2-layer {what} below {COS_MIN}")
    cos = cosine(model.encode_text(ids).cpu().numpy(), ref_text)
    print(f"[depth] 2 layers, text tower: bf16 card vs f32 CPU plain: "
          f"cosine min={cos.min():.6f} (>= {COS_MIN})")
    require(bool(cos.min() >= COS_MIN), f"2-layer text tower below {COS_MIN}")
    return {"image": ref_image, "text": ref_text, "ids": ids}


# f32 2-layer configuration -> (factory options, or build_scanned_vision_
# apply flags under "scanned", launches a layer); the factory in f32 is
# build_eva_model_and_transforms(dtype=torch.float32), which sends every
# attention to the f32 body
F32_DEPTH = {
    "factory scan=True": (dict(scan=True), dict(K1f32=1, E1f32=2, E2f32=2)),
    "factory scan=False": (dict(scan=False), dict(K6f32=1)),
    "factory padded unrolled": (dict(scan=False, padded_heads=True),
                                dict(K7f32=1)),
    "factory padded scanned": (dict(scan=True, padded_heads=True),
                               dict(K1f32=1, E1f32=2, E2f32=2)),
    "scanned v1": (dict(scanned={}), dict(K8f32=1, E1f32=1, E2f32=2)),
    "scanned v2": (dict(scanned=dict(attn_v2=True)),
                   dict(K9f32=1, E1f32=2, E2f32=2)),
}
# f32 int8 2-layer configurations, each against the CPU's f32 int8 path with
# the same flags (cosine >= COS_MIN) and its f32 float path (>=
# COS_INT8_VS_FLOAT): the factory's (fused_quant, fused_mlp, v3: K2, K3,
# K4), and the scanned forward's int8 + fused_quant + fused_mlp with v1 and
# v2, which carry K8 and K9 int8 without K5
F32_INT8_DEPTH = {
    "factory int8": (dict(attn_v3=True),
                     dict(K2f32=2, K3f32=1, K4f32=1, G1f32=2)),
    "scanned int8 fq+fm v1": ({}, dict(K2f32=2, K8qf32=1, K4f32=1,
                                       G1f32=2)),
    "scanned int8 fq+fm v2": (dict(attn_v2=True),
                              dict(K2f32=2, K9qf32=1, K4f32=1, G1f32=2)),
}


def phase_f32_depth(cfg, text_cfg, weights: dict, frames, ref: dict) -> dict:
    """The f32 paths on the card, each cut to 2 layers, against the CPU's
    f32 outputs of phase_factory_depth within 1e-5 of the largest value:
    the factory with dtype=torch.float32 (scanned and unrolled, padded
    heads or not; the padded ones against the unpadded CPU paths, an
    identity), the scanned forward's v1 (K8's function) and v2 (K9's)
    against the scanned CPU path, and the text tower. Launch counts zeroed
    before each forward and read after. Returns the f32 launches."""
    from dataclasses import replace

    from hirest_tpu_torch.models.convert import eva_vision_state_dict
    from hirest_tpu_torch.models.eva_clip import build_eva_model_and_transforms
    from hirest_tpu_torch.models.eva_scan import build_scanned_vision_apply

    cut = replace(cfg, layers=2)
    cuts = dict(text_config=replace(text_cfg, layers=2), vision_config=cut)
    launches: dict = {}
    for tag, (options, per_layer) in F32_DEPTH.items():
        options = dict(options)
        scanned = options.pop("scanned", None)
        if scanned is None:
            model = build_eva_model_and_transforms(
                pretrained=weights, device="cuda", dtype=torch.float32,
                **cuts, **options)[0]
            encode, want = model.encode_image, ref["image"][options["scan"]]
        else:
            encode = build_scanned_vision_apply(
                eva_vision_state_dict(weights), cut, dtype=torch.float32,
                device="cuda", **scanned)
            want = ref["image"][True]
        zero_counts()
        got = encode(frames)
        torch.cuda.synchronize()
        counts = read_counts()
        expected = expect(**{k: v * cut.layers for k, v in per_layer.items()})
        require(counts == expected, f"f32 {tag} launches {counts}, expected "
                                    f"{expected}")
        got = got.cpu().numpy()
        err = np.abs(got - want).max()
        top = np.abs(want).max()
        print(f"[f32] 2 layers, {tag}: f32 card vs f32 CPU plain: "
              f"max_abs_err={err} of max|ref|={top}; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        require(err <= F32_TOL * top, f"f32 2-layer {tag} beyond {F32_TOL}")
        for k, v in counts.items():
            if v:
                launches[k] = launches.get(k, 0) + v
    got = model.encode_text(ref["ids"]).cpu().numpy()
    err = np.abs(got - ref["text"]).max()
    top = np.abs(ref["text"]).max()
    print(f"[f32] 2 layers, text tower: f32 card vs f32 CPU plain: "
          f"max_abs_err={err} of max|ref|={top}")
    require(err <= F32_TOL * top, f"f32 2-layer text tower beyond {F32_TOL}")
    vision_sd = eva_vision_state_dict(weights)
    for tag, (flags, per_layer) in F32_INT8_DEPTH.items():
        def encode(device, tag=tag, flags=flags):
            if tag == "factory int8":
                return build_eva_model_and_transforms(
                    pretrained=weights, device=device, dtype=torch.float32,
                    int8=True, scan=True, **cuts)[0].encode_image
            return build_scanned_vision_apply(
                vision_sd, cut, dtype=torch.float32, device=device,
                int8=True, fused_quant=True, fused_mlp=True, **flags)

        want = encode("cpu")(frames).numpy()
        card_encode = encode("cuda")
        zero_counts()
        got = card_encode(frames)
        torch.cuda.synchronize()
        counts = read_counts()
        expected = expect(**{k: v * cut.layers for k, v in per_layer.items()})
        require(counts == expected, f"f32 {tag} launches {counts}, expected "
                                    f"{expected}")
        got = got.cpu().numpy()
        cos, cos_float = cosine(got, want), cosine(got, ref["image"][True])
        print(f"[f32] 2 layers, {tag}: f32 int8 card vs f32 int8 CPU plain: "
              f"cosine min={cos.min():.6f} (>= {COS_MIN}), max_abs_err="
              f"{np.abs(got - want).max()} of max|ref|={np.abs(want).max()}; "
              f"vs f32 float CPU: cosine min={cos_float.min():.6f} (>= "
              f"{COS_INT8_VS_FLOAT}); launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        require(bool(np.isfinite(got).all()) and cos.min() >= COS_MIN
                and cos_float.min() >= COS_INT8_VS_FLOAT,
                f"f32 2-layer {tag} below its cosine bars")
        for k, v in counts.items():
            if v:
                launches[k] = launches.get(k, 0) + v
    return launches


# the ladder configurations in f32 (flags from LADDER) -> their f32
# launches a layer: the fused LayerNorm's K10, K5 in the fused-quant MLP
# (and int8 dyn's four row quantizations), int8 dyn's K8, and G1 for every
# int8 product
F32_LADDER = {
    "bf16+v3+lnk": dict(K1f32=1, K10f32=2, E1f32=2, E2f32=2),
    "int8": dict(K8f32=1, E1f32=1, G1f32=4, K5f32=4),
    "int8+fq": dict(K2f32=2, K5f32=1, K8qf32=1, G1f32=4),
    "int8+fq+v2": dict(K2f32=2, K5f32=1, K9qf32=1, G1f32=4),
    "int8+fq+v3": dict(K2f32=2, K3f32=1, K5f32=1, G1f32=4),
}
F32_LADDER_FULL = ("bf16+v3+lnk", "int8+fq+v3")  # run at full depth too
F32_LADDER_FORWARDS = 2  # timed forwards of B=128, after one warm-up


def phase_f32_ladder_depth(cfg, weights: dict, frames, ref: dict) -> dict:
    """F32_LADDER's configurations in f32 cut to 2 layers, on the card
    against the CPU's f32 path with the same flags: the float one within
    F32_TOL of the largest value, the int8 ones at cosine >= COS_MIN and,
    against the CPU's f32 float path (phase_factory_depth's scanned
    output), >= COS_INT8_VS_FLOAT. Launch counts zeroed before each
    forward and read after, exact. Returns the f32 launches."""
    from dataclasses import replace

    from hirest_tpu_torch.models.convert import eva_vision_state_dict
    from hirest_tpu_torch.models.eva_scan import build_scanned_vision_apply

    t0 = time.perf_counter()
    cut = replace(cfg, layers=2)
    sd = eva_vision_state_dict(weights)
    launches: dict = {}
    for tag, per_layer in F32_LADDER.items():
        flags = LADDER[tag][0]
        want = build_scanned_vision_apply(sd, cut, dtype=torch.float32,
                                          device="cpu", **flags)(frames)
        want = want.numpy()
        encode = build_scanned_vision_apply(sd, cut, dtype=torch.float32,
                                            device="cuda", **flags)
        zero_counts()
        got = encode(frames)
        torch.cuda.synchronize()
        counts = read_counts()
        expected = expect(**{k: v * cut.layers for k, v in per_layer.items()})
        require(counts == expected, f"f32 ladder {tag} launches {counts}, "
                                    f"expected {expected}")
        got = got.cpu().numpy()
        require(got.shape == want.shape and bool(np.isfinite(got).all()),
                f"f32 ladder {tag}: output {got.shape}")
        err, top = np.abs(got - want).max(), np.abs(want).max()
        fired = {k: v for k, v in counts.items() if v}
        if flags.get("int8"):
            cos, cos_float = cosine(got, want), cosine(got, ref["image"][True])
            print(f"[f32 ladder] 2 layers, {tag}: f32 card vs f32 CPU plain, "
                  f"same flags: cosine min={cos.min():.6f} (>= {COS_MIN}), "
                  f"max_abs_err={err} of max|ref|={top}; vs f32 float CPU: "
                  f"cosine min={cos_float.min():.6f} (>= "
                  f"{COS_INT8_VS_FLOAT}); launches {fired}")
            require(cos.min() >= COS_MIN
                    and cos_float.min() >= COS_INT8_VS_FLOAT,
                    f"f32 2-layer ladder {tag} below its cosine bars")
        else:
            print(f"[f32 ladder] 2 layers, {tag}: f32 card vs f32 CPU plain, "
                  f"same flags: max_abs_err={err} of max|ref|={top} (<= "
                  f"{F32_TOL} of it); launches {fired}")
            require(err <= F32_TOL * top,
                    f"f32 2-layer ladder {tag} beyond {F32_TOL}")
        for k, v in fired.items():
            launches[k] = launches.get(k, 0) + v
    print(f"[f32 ladder] 2-layer cuts: {time.perf_counter() - t0:.1f} s")
    return launches


def phase_f32_ladder(cfg, weights: dict, card: str) -> dict:
    """F32_LADDER_FULL in f32 at full width and depth (40 x 1408, B=128)
    through build_scanned_vision_apply(dtype=torch.float32, device="cuda")
    on one staged f32 tower per precision: a warm-up forward and
    F32_LADDER_FORWARDS timed ones with the counts zeroed before and read
    after (exact, per forward), the outputs finite, the int8 one at cosine
    >= COS_INT8_VS_FLOAT to the float one; frames/s, then one profiled
    forward's device time by group of kernels. Returns the launches."""
    from hirest_tpu_torch.models.eva_scan import (build_scanned_vision_apply,
                                                  stage_scanned_params)

    t0 = time.perf_counter()
    frames = normalize_frames(np.random.default_rng(5).integers(
        0, 256, (BATCH, 224, 224, 3), dtype=np.uint8))
    launches: dict = {}
    feats = {}
    for tag in F32_LADDER_FULL:
        flags = LADDER[tag][0]
        int8 = bool(flags.get("int8"))
        t1 = time.perf_counter()
        staged = stage_scanned_params(weights, cfg, int8=int8,
                                      dtype=torch.float32, device="cuda")
        fn = build_scanned_vision_apply(None, cfg, staged=staged,
                                        dtype=torch.float32, device="cuda",
                                        **flags)
        torch.cuda.synchronize()
        staged_s = time.perf_counter() - t1
        zero_counts()
        fn(frames)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(F32_LADDER_FORWARDS):
            out = fn(frames)
        torch.cuda.synchronize()
        fps = BATCH * F32_LADDER_FORWARDS / (time.perf_counter() - t1)
        counts = read_counts()
        want = expect(**{k: v * cfg.layers * (1 + F32_LADDER_FORWARDS)
                         for k, v in F32_LADDER[tag].items()})
        print(f"[f32 ladder] {card}: {tag} f32, staged in {staged_s:.1f} s; "
              f"B={BATCH}: {fps:.2f} frames/s over {F32_LADDER_FORWARDS} "
              f"forwards; launches over {1 + F32_LADDER_FORWARDS} {counts}")
        require(counts == want, f"f32 ladder {tag} launches {counts}, "
                                f"expected {want}")
        require(out.dtype == torch.float32
                and tuple(out.shape) == (BATCH, cfg.embed_dim)
                and bool(out.isfinite().all()),
                f"f32 ladder {tag}: output {out.dtype} {tuple(out.shape)}")
        feats[tag] = out.cpu().numpy()
        for k, n in counts.items():
            if n:
                launches[k] = launches.get(k, 0) + n
        profile_call(f"one f32 {tag} forward B={BATCH}", lambda: fn(frames),
                     card, "ladder f32 int8" if int8 else "ladder f32",
                     tag="f32 ladder")
        del fn, staged, out
        torch.cuda.empty_cache()
    cos = cosine(feats["int8+fq+v3"], feats["bf16+v3+lnk"]).min()
    print(f"[f32 ladder] int8+fq+v3 vs bf16+v3+lnk in f32 at full depth: "
          f"min cosine {cos:.6f} (>= {COS_INT8_VS_FLOAT})")
    require(cos >= COS_INT8_VS_FLOAT, "f32 int8+fq+v3 off the f32 float "
                                      "forward")
    print(f"[f32 ladder] full-width f32 forwards: "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


# the unrolled int8 tower (models/eva_quant.py): quant_attention -> tag
INT8_TOWER = {True: "unrolled int8", False: "unrolled int8, bf16 qkv/out"}


def int8_tower_launches(cfg, quant_attention: bool, f32: bool = False
                        ) -> dict:
    """The unrolled int8 tower's launches a forward: K6 a layer, and E4
    and G1 for each QuantDense (4 a layer with quant_attention, else fc1
    and fc2; the patch embedding and the head); in bf16 E4 on the ring for
    all but the patch rows, which take row_quant_kernel (E4rows); their
    f32 forms with f32."""
    dense = (4 if quant_attention else 2) * cfg.layers + 2
    if f32:
        return dict(K6f32=cfg.layers, G1f32=dense, E4f32=dense)
    return dict(K6=cfg.layers, G1=dense, E4=dense - 1, E4rows=1)


def phase_int8_tower(cfg, weights: dict, factory: dict) -> dict:
    """build_int8_vision_apply at full width for each quant_attention, on
    the factory's seeded weights: FACTORY_FORWARDS forwards of B=128 each
    with the launch counts zeroed before and read after (int8_tower_
    launches a forward, nothing else), the outputs finite and at cosine
    >= 0.98 to the float unrolled tower at full depth. Returns the
    forwards and their launches."""
    from hirest_tpu_torch.models.eva_quant import build_int8_vision_apply

    frames = factory["frames"]
    want = factory["models"]["unrolled"].encode_image(frames).cpu().numpy()
    fns, launches = {}, {}
    for qa, tag in INT8_TOWER.items():
        t0 = time.perf_counter()
        fns[qa] = build_int8_vision_apply(weights, cfg, quant_attention=qa,
                                          device="cuda")
        torch.cuda.synchronize()
        print(f"[int8 tower] {tag}: quantized and staged in "
              f"{time.perf_counter() - t0:.1f} s")
        zero_counts()
        for _ in range(FACTORY_FORWARDS):
            out = fns[qa](frames)
        torch.cuda.synchronize()
        counts = read_counts()
        want_counts = expect(**{k: v * FACTORY_FORWARDS for k, v in
                                int8_tower_launches(cfg, qa).items()})
        print(f"[int8 tower] {tag}: {FACTORY_FORWARDS} forwards of {BATCH} "
              f"frames; launches {counts}")
        require(counts == want_counts, f"{tag} launches {counts}, expected "
                                       f"{want_counts}")
        require(tuple(out.shape) == (BATCH, cfg.embed_dim)
                and bool(out.isfinite().all()), f"{tag}: output "
                                                f"{tuple(out.shape)}")
        for k, n in counts.items():
            if n:
                launches[k] = launches.get(k, 0) + n
        cos = cosine(out.cpu().numpy(), want).min()
        print(f"[int8 tower] {tag} vs the float unrolled tower at full "
              f"depth: min cosine {cos:.6f} (>= {COS_INT8_VS_FLOAT})")
        require(cos >= COS_INT8_VS_FLOAT, f"{tag} off the float tower")
    return {"fns": fns, "frames": frames, "launches": launches}


def phase_int8_tower_depth(cfg, weights: dict, frames) -> dict:
    """The unrolled int8 tower cut to 2 layers, on the card in bf16 against
    the same function on the CPU in f32 (cosine >= 0.99) and against the
    float unrolled tower on the CPU in f32 (>= 0.98), for each
    quant_attention; then with quant_attention in f32 on the card (E3, E4
    and K6 in their f32 forms, launch counts exact) at the same bars.
    Returns the f32 launches."""
    from dataclasses import replace

    from hirest_tpu_torch.models.eva_clip import build_unrolled_vision_apply
    from hirest_tpu_torch.models.eva_quant import build_int8_vision_apply

    cut = replace(cfg, layers=2)
    cpu_float = build_unrolled_vision_apply(weights, cut, dtype=torch.float32,
                                            device="cpu")(frames).numpy()
    refs = {}
    for qa, tag in INT8_TOWER.items():
        ref = refs[qa] = build_int8_vision_apply(
            weights, cut, quant_attention=qa, dtype=torch.float32,
            device="cpu")(frames).numpy()
        got = build_int8_vision_apply(weights, cut, quant_attention=qa,
                                      device="cuda")(frames).cpu().numpy()
        for what, want, bar in (
                ("card vs the same f32 CPU plain", ref, COS_MIN),
                ("card vs the float unrolled f32 CPU plain", cpu_float,
                 COS_INT8_VS_FLOAT)):
            cos = cosine(got, want).min()
            print(f"[depth] 2 layers, {tag}, {what}: cosine min={cos:.6f} "
                  f"(>= {bar})")
            require(got.shape == (len(frames), cfg.embed_dim)
                    and bool(cos >= bar), f"2-layer {tag} {what} below "
                                          f"{bar}")
    encode = build_int8_vision_apply(weights, cut, dtype=torch.float32,
                                     device="cuda")
    zero_counts()
    got = encode(frames)
    torch.cuda.synchronize()
    counts = read_counts()
    want = expect(**int8_tower_launches(cut, True, f32=True))
    require(counts == want, f"f32 unrolled int8 launches {counts}, expected "
                            f"{want}")
    got = got.cpu().numpy()
    for what, ref, bar in (("f32 card vs the same f32 CPU plain", refs[True],
                            COS_MIN),
                           ("f32 card vs the float unrolled f32 CPU plain",
                            cpu_float, COS_INT8_VS_FLOAT)):
        cos = cosine(got, ref).min()
        print(f"[depth] 2 layers, unrolled int8, {what}: cosine "
              f"min={cos:.6f} (>= {bar}), max_abs_err="
              f"{np.abs(got - ref).max()} of max|ref|={np.abs(ref).max()}")
        require(bool(np.isfinite(got).all()) and bool(cos >= bar),
                f"2-layer f32 unrolled int8 {what} below {bar}")
    return {k: v for k, v in counts.items() if v}


@contextlib.contextmanager
def plain_int8_kernels():
    """Within it, the int8 towers run the plain versions where they launch
    G1, E4 and K5's row quantization: `int8_mm` (G1, which the scanned
    block and int8_matmul call), `row_quant` (E4, int8_matmul's) and the
    scanned block's `dyn_quant_rows` (K5 without an activation)."""
    import hirest_tpu_torch.models.eva_scan as eva_scan
    import hirest_tpu_torch.ops.quant as quant

    saved = [(quant, "int8_mm", quant.int8_mm_ref),
             (eva_scan, "int8_mm", quant.int8_mm_ref),
             (quant, "row_quant", quant.row_quant_ref),
             (eva_scan, "dyn_quant_rows", quant.dyn_quant_rows_ref)]
    saved = [(mod, name, getattr(mod, name), plain)
             for mod, name, plain in saved]
    for mod, name, _, plain in saved:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, kernel, _ in saved:
            setattr(mod, name, kernel)


def phase_int8_plain(main: dict, ladder: dict, tower: dict) -> None:
    """The production int8 encoder (int8+fq+v3+fm), the ladder's int8 dyn,
    int8+fq and int8+fq+v3, and the unrolled int8 tower at full width and
    depth, each twice on the same B=128 float frames: as built, and with
    plain_int8_kernels. The products are exact int32 and every other
    kernel runs alike, so any difference would be G1's, E4's or K5's: the
    outputs must be equal bit for bit. The counts show the kernels ran the
    first time and not the second, and torch._int_mm ran only in the
    plain versions."""
    t0 = time.perf_counter()
    frames = normalize_frames(main["frames"]["vid_a"][:BATCH])
    runs = {"int8+fq+v3+fm (production encoder)":
            (main["encoders"]["int8"][False], ("G1",)),
            "int8 dyn (ladder)": (ladder["fns"]["int8"], ("G1", "K5")),
            "int8+fq (ladder)": (ladder["fns"]["int8+fq"], ("G1",)),
            "int8+fq+v3 (ladder)": (ladder["fns"]["int8+fq+v3"], ("G1",)),
            "unrolled int8": (tower["fns"][True], ("G1", "E4", "E4rows"))}
    for tag, (fn, kernels) in runs.items():
        outs, counts, int_mm = [], [], []
        for plain in (False, True):
            zero_counts()  # outside: the context swaps the wrappers
            with (plain_int8_kernels() if plain
                  else contextlib.nullcontext()):
                out = torch.as_tensor(fn(frames))
                torch.cuda.synchronize()
            counts.append({k: read_counts()[k] for k in kernels})
            int_mm.append(read_counts()["_int_mm"])
            outs.append(out.float().cpu())
        ok = torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
        n = int((outs[0] != outs[1]).sum().item())
        print(f"[int8 plain] {tag}: kernels {counts[0]}, plain {counts[1]}; "
              f"torch._int_mm calls {int_mm[0]} with the kernels, "
              f"{int_mm[1]} with the plain versions; {n} of "
              f"{outs[0].numel()} outputs differ (bar 0)")
        require(all(counts[0].values()) and not any(counts[1].values())
                and int_mm[0] == 0 and int_mm[1] > 0,
                f"{tag}: launches {counts}, torch._int_mm calls {int_mm}")
        require(ok and bool(outs[0].isfinite().all()),
                f"{tag}: the kernels' forward off the plain versions'")
    print(f"[int8 plain] {time.perf_counter() - t0:.1f} s")


def time_int8_tower(tower: dict, card: str) -> None:
    """Frames/s of each unrolled int8 forward at B=128, as time_factory,
    then one profiled forward's groups and idle share."""
    for qa, tag in INT8_TOWER.items():
        fn = tower["fns"][qa]
        fn(tower["frames"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iters = 5
        for _ in range(iters):
            fn(tower["frames"])
        torch.cuda.synchronize()
        fps = BATCH * iters / (time.perf_counter() - t0)
        print(f"[timing] {card}: {tag} B={BATCH}: {fps:.2f} frames/s")
    for qa, tag in INT8_TOWER.items():
        profile_forward(tag, tower["fns"][qa], tower["frames"], card,
                        "unrolled int8")


def time_encoders(main: dict, card: str) -> dict:
    out = {}
    for tag, encoders in main["encoders"].items():
        for u8, enc in encoders.items():
            u8_frames = main["frames"]["vid_a"][:BATCH]
            batch = u8_frames if u8 else normalize_frames(u8_frames)
            enc(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            iters = 5
            for _ in range(iters):
                enc(batch)
            torch.cuda.synchronize()
            fps = BATCH * iters / (time.perf_counter() - t0)
            name = "uint8" if u8 else "float"
            print(f"[timing] {card}: {tag} encoder ({name} front end, host "
                  f"frames in) B={BATCH}: {fps:.2f} frames/s")
            out[f"fps_{tag}_{name}"] = fps
    # every projection as an int8 product, at the dense int8 peak
    proj_ops = 2 * BATCH * TOKENS * 40 * 1408 * (4224 + 1408 + 2 * 6144)
    print(f"[timing] int8 projections {proj_ops / 1e12:.1f} TOP per forward: "
          f"at {INT8_OP_PER_S / 1e12:.0f} TOP/s the card cannot pass "
          f"{BATCH * INT8_OP_PER_S / proj_ops:.0f} frames/s")
    return out


def time_factory(factory: dict, card: str) -> None:
    """Frames/s of every factory image configuration at B=128 and text
    prompts/s at TEXT_BATCH, host clock around work ending in a
    synchronize, after one warm-up call."""
    for tag, model in factory["models"].items():
        for what, fn, n in (
                ("images", lambda: model.encode_image(factory["frames"]),
                 BATCH),
                ("prompts", lambda: model.encode_text(
                    factory["ids"][:TEXT_BATCH]), TEXT_BATCH)):
            if what == "prompts" and tag != "unrolled":
                continue  # one text tower is enough: they are the same
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            iters = 5
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            rate = n * iters / (time.perf_counter() - t0)
            label = ("text encoder" if what == "prompts"
                     else f"factory {tag} encode_image")
            print(f"[timing] {card}: {label} B={n}: {rate:.2f} {what}/s")


def time_ladder(ladder: dict, card: str) -> dict:
    """Frames/s of every ladder configuration at B=128, as time_factory."""
    out = {}
    for tag, fn in ladder["fns"].items():
        fn(ladder["frames"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iters = 5
        for _ in range(iters):
            fn(ladder["frames"])
        torch.cuda.synchronize()
        fps = BATCH * iters / (time.perf_counter() - t0)
        print(f"[timing] {card}: ladder {tag} B={BATCH}: {fps:.2f} frames/s")
        out[tag] = fps
    return out


def phase_timing(cfg, main: dict, factory: dict, ladder: dict,
                 card: str) -> tuple:
    """Frames/s, and each kernel's ms beside its plain version, a library
    yardstick and the bound, at the main path's B=128 shapes. Returns (the
    kernels' readings, frames/s by the bench's tag: the production encoders
    on float frames as bf16+v3 and int8+fq+v3+fm, and the ladder's)."""
    import torch.nn.functional as F

    from hirest_tpu_torch.models.layers import split_heads
    from hirest_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_packed,
                                                fused_attention_packed_ref,
                                                fused_attention_qkv,
                                                fused_attention_qkv2,
                                                fused_attention_qkv2_ref,
                                                fused_attention_qkv3,
                                                fused_attention_qkv3_ref,
                                                fused_attention_qkv_ref,
                                                fused_attention_ref)
    from hirest_tpu_torch.ops.quant import (_mlp_hidden_launch,
                                            _mlp_out_launch, act_quant,
                                            act_quant_ref, fused_mlp_int8,
                                            fused_mlp_int8_ref, ln_bf16,
                                            ln_bf16_ref, ln_quant,
                                            ln_quant_ref,
                                            mlp_int8_hidden_ref,
                                            mlp_int8_out_ref)

    enc = time_encoders(main, card)
    time_factory(factory, card)
    fps = {"bf16+v3": enc["fps_bf16_float"],
           "int8+fq+v3+fm": enc["fps_int8_float"],
           **time_ladder(ladder, card)}
    res = {}
    scale, heads, d = cfg.head_width ** -0.5, cfg.num_heads, cfg.head_width
    m, w, hid = BATCH * TOKENS, cfg.width, cfg.mlp_hidden

    qkv = attention_inputs(BATCH, seed=7)
    b, s, three_hd = qkv.shape
    q, k, v = qkv.view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)
    attn_flops = 2 * 2 * b * heads * s * s * d  # QK^T and PV
    res["K1"] = {
        "ms": cuda_ms(lambda: fused_attention_qkv3(qkv, scale, heads), 20),
        "plain_ms": cuda_ms(
            lambda: fused_attention_qkv3_ref(qkv, scale, heads), 5),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 20),
        **bound(qkv.numel() * 2 + m * w * 2, attn_flops, BF16_FLOP_PER_S)}
    res["K3"] = {
        "ms": cuda_ms(lambda: fused_attention_qkv3(
            qkv, scale, heads, quant_out=True), 20),
        "plain_ms": cuda_ms(lambda: fused_attention_qkv3_ref(
            qkv, scale, heads, quant_out=True), 5),
        "library_ms": None,
        **bound(qkv.numel() * 2 + m * w + m * 4, attn_flops,
                BF16_FLOP_PER_S)}

    x, g, bb = ln_inputs(m, seed=8)
    res["K2"] = {
        "ms": cuda_ms(lambda: ln_quant(x, g, bb, EPS), 20),
        "plain_ms": cuda_ms(lambda: ln_quant_ref(x, g, bb, EPS), 5),
        "library_ms": None,
        **bound(m * w * 2 + m * w + m * 4 + 2 * w * 4,
                ROW_SLOTS["K2"] * m * w, ISSUE_SLOTS_PER_S)}

    args = mlp_inputs(m, seed=9)
    h_q, _, w1_q, _, _, w2_q, _, _, x_res = args
    hidden_q = torch.randint(-127, 128, (m, hid), dtype=torch.int8,
                             device="cuda", generator=gen(10))
    res["K4"] = {
        "ms": cuda_ms(lambda: fused_mlp_int8(*args), 5),
        "plain_ms": cuda_ms(lambda: fused_mlp_int8_ref(*args), 3),
        # the floor a library would give: its two products as torch._int_mm
        "library_ms": cuda_ms(lambda: (torch._int_mm(h_q, w1_q.t()),
                                       torch._int_mm(hidden_q, w2_q.t())), 5),
        **bound(m * w + m * 4 + 2 * m * w * 2 + 2 * hid * w
                + 4 * (2 * hid + 2 * w), 2 * 2 * m * w * hid, INT8_OP_PER_S)}
    # K4's two kernels alone, each against its plain version and its one
    # product as torch._int_mm; the bytes count the hidden codes and
    # scales that pass between them
    codes, scales = _mlp_hidden_launch(*args[:5], "gelu_poly")
    code_bytes = m * hid + m * (hid // 1024) * 4
    stages = {
        "K4a mlp_hidden": {
            "ms": cuda_ms(lambda: _mlp_hidden_launch(*args[:5], "gelu_poly"),
                          5),
            "plain_ms": cuda_ms(lambda: mlp_int8_hidden_ref(*args[:5]), 3),
            "library_ms": cuda_ms(lambda: torch._int_mm(h_q, w1_q.t()), 5),
            **bound(m * w + m * 4 + hid * w + 8 * hid + code_bytes,
                    2 * m * w * hid, INT8_OP_PER_S)},
        "K4b mlp_out": {
            "ms": cuda_ms(lambda: _mlp_out_launch(codes, scales, *args[5:]),
                          5),
            "plain_ms": cuda_ms(lambda: mlp_int8_out_ref(codes, scales,
                                                         *args[5:]), 3),
            "library_ms": cuda_ms(lambda: torch._int_mm(codes, w2_q.t()), 5),
            **bound(code_bytes + hid * w + 8 * w + 2 * m * w * 2,
                    2 * m * w * hid, INT8_OP_PER_S)}}
    # the unrolled towers' attention: K6 on split-heads views of one qkv
    # projection, K7 on packed heads at the padded width; K1 and K3 at the
    # padded width (heads padded 88 -> 128) on the padded scanned tower
    qkv = attention_inputs(BATCH, seed=11)
    q, k, v = split_views(qkv)
    res["K6"] = {
        "ms": cuda_ms(lambda: fused_attention(q, k, v, scale), 20),
        "plain_ms": cuda_ms(lambda: fused_attention_ref(q, k, v, scale), 5),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 20),
        **bound(4 * q.numel() * 2, attn_flops, BF16_FLOP_PER_S)}
    qkv128 = attention_inputs(BATCH, seed=12, hd=PADDED_HD)
    p128 = 128 ** -0.5
    q, k, v = qkv128.chunk(3, -1)
    qs, ks, vs = (split_heads(t, heads) for t in (q, k, v))
    flops128 = 2 * 2 * BATCH * heads * s * s * 128
    res["K7"] = {
        "ms": cuda_ms(lambda: fused_attention_packed(q, k, v, p128, heads),
                      20),
        "plain_ms": cuda_ms(lambda: fused_attention_packed_ref(
            q, k, v, p128, heads), 5),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, scale=p128), 20),
        **bound(4 * q.numel() * 2, flops128, BF16_FLOP_PER_S)}
    padded = {
        "K1 d=128": {
            "ms": cuda_ms(lambda: fused_attention_qkv3(qkv128, p128, heads),
                          20),
            "plain_ms": cuda_ms(lambda: fused_attention_qkv3_ref(
                qkv128, p128, heads), 5),
            "library_ms": res["K7"]["library_ms"],
            **bound(qkv128.numel() * 2 + m * PADDED_HD * 2, flops128,
                    BF16_FLOP_PER_S)},
        "K3 d=128": {
            "ms": cuda_ms(lambda: fused_attention_qkv3(
                qkv128, p128, heads, quant_out=True), 20),
            "plain_ms": cuda_ms(lambda: fused_attention_qkv3_ref(
                qkv128, p128, heads, quant_out=True), 5),
            "library_ms": None,
            **bound(qkv128.numel() * 2 + m * PADDED_HD + m * 4, flops128,
                    BF16_FLOP_PER_S)}}
    # K9 on K1's and K3's inputs: the same kernel under its own wrapper
    res["K9"] = {
        "ms": cuda_ms(lambda: fused_attention_qkv2(qkv, scale, heads), 20),
        "plain_ms": cuda_ms(
            lambda: fused_attention_qkv2_ref(qkv, scale, heads), 5),
        "library_ms": res["K1"]["library_ms"],
        **bound(qkv.numel() * 2 + m * w * 2, attn_flops, BF16_FLOP_PER_S)}
    res["K9q"] = {
        "ms": cuda_ms(lambda: fused_attention_qkv2(
            qkv, scale, heads, quant_out=True), 20),
        "plain_ms": cuda_ms(lambda: fused_attention_qkv2_ref(
            qkv, scale, heads, quant_out=True), 5),
        "library_ms": None,
        **bound(qkv.numel() * 2 + m * w + m * 4, attn_flops,
                BF16_FLOP_PER_S)}
    # K8 on a qkv projection without bias and nonzero q/v biases; its
    # library yardstick runs on the heads with the biases already added
    qkv8 = attention_inputs(BATCH, seed=13)
    qb, vb = biases(w, seed=14)
    q, k, v = (split_heads(t, heads) for t in qkv8.chunk(3, -1))
    qbh, vbh = (split_heads(t + bias, heads) for t, bias in
                ((qkv8[..., :w], qb), (qkv8[..., 2 * w:], vb)))
    res["K8"] = {
        "ms": cuda_ms(lambda: fused_attention_qkv(qkv8, qb, vb, scale,
                                                  heads), 20),
        "plain_ms": cuda_ms(lambda: fused_attention_qkv_ref(
            qkv8, qb, vb, scale, heads), 5),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qbh, k, vbh, scale=scale), 20),
        **bound(qkv8.numel() * 2 + 2 * w * 2 + m * w * 2, attn_flops,
                BF16_FLOP_PER_S)}
    res["K8q"] = {
        "ms": cuda_ms(lambda: fused_attention_qkv(qkv8, qb, vb, scale, heads,
                                                  quant_out=True), 20),
        "plain_ms": cuda_ms(lambda: fused_attention_qkv_ref(
            qkv8, qb, vb, scale, heads, quant_out=True), 5),
        "library_ms": None,
        **bound(qkv8.numel() * 2 + 2 * w * 2 + m * w + m * 4, attn_flops,
                BF16_FLOP_PER_S)}
    # K5 on the int8 MLP's fc1 output with gelu_bf16_poly, and on an
    # attention output without activation
    h6 = fc1_inputs(m, seed=15, c=hid)
    res["K5"] = {
        "ms": cuda_ms(lambda: act_quant(h6, act="gelu_poly"), 20),
        "plain_ms": cuda_ms(lambda: act_quant_ref(h6, act="gelu_poly"), 5),
        "library_ms": None,
        **bound(m * hid * 3 + m * 4, ROW_SLOTS["K5 gelu_poly"] * m * hid,
                ISSUE_SLOTS_PER_S)}
    h1 = fc1_inputs(m, seed=16, c=w)
    extra = {"K5 act=none [M,1408]": {
        "ms": cuda_ms(lambda: act_quant(h1), 20),
        "plain_ms": cuda_ms(lambda: act_quant_ref(h1), 5),
        "library_ms": None,
        **bound(m * w * 3 + m * 4, ROW_SLOTS["K5 none"] * m * w,
                ISSUE_SLOTS_PER_S)}}
    # K10 against F.layer_norm on the same bf16 rows
    x10, g10, b10 = ln_inputs(m, seed=17)
    res["K10"] = {
        "ms": cuda_ms(lambda: ln_bf16(x10, g10, b10, EPS), 20),
        "plain_ms": cuda_ms(lambda: ln_bf16_ref(x10, g10, b10, EPS), 5),
        "library_ms": cuda_ms(lambda: F.layer_norm(
            x10, (w,), g10.bfloat16(), b10.bfloat16(), EPS), 20),
        **bound(m * w * 2 * 2 + 2 * w * 4, ROW_SLOTS["K10"] * m * w,
                ISSUE_SLOTS_PER_S)}
    # the f32 body (attention_f32.cu) through each wrapper: K6 at
    # ViT-B/32's split heads [128, 12, 50, 64] (the eval path's), and at
    # EVA-g's; K7 packed at d = 128; K1/K9's and K8's layouts at EVA-g's
    # width; each beside SDPA in f32 on the same heads (K8's pre-biased),
    # its bound 3xTF32's (tf32x3_bound)
    qkv = f32_inputs(BATCH, 260, 50, 12 * 64)
    q, k, v = split_views(qkv, 12)
    res["K6f32"] = {
        "ms": cuda_ms(lambda: fused_attention(q, k, v, 0.125), 20),
        "plain_ms": cuda_ms(lambda: fused_attention_ref(q, k, v, 0.125), 5),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=0.125), 20),
        **tf32x3_bound(4 * q.numel() * 4, 2 * 2 * BATCH * 12 * 50 * 50 * 64)}
    qkv = f32_inputs(BATCH, 261, TOKENS, w)
    q, k, v = split_views(qkv)
    f32_extra = {"K6f32 EVA-g [128,16,257,88]": {
        "ms": cuda_ms(lambda: fused_attention(q, k, v, scale), 5),
        "plain_ms": cuda_ms(lambda: fused_attention_ref(q, k, v, scale), 3),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 5),
        **tf32x3_bound(4 * q.numel() * 4, attn_flops)}}
    res["K1f32"] = {
        "ms": cuda_ms(lambda: fused_attention_qkv3(qkv, scale, heads), 5),
        "plain_ms": cuda_ms(lambda: fused_attention_qkv3_ref(
            qkv, scale, heads), 3),
        "library_ms": f32_extra["K6f32 EVA-g [128,16,257,88]"]["library_ms"],
        **tf32x3_bound((qkv.numel() + m * w) * 4, attn_flops)}
    res["K9f32"] = {
        "ms": cuda_ms(lambda: fused_attention_qkv2(qkv, scale, heads), 5),
        "plain_ms": cuda_ms(lambda: fused_attention_qkv2_ref(
            qkv, scale, heads), 3),
        "library_ms": res["K1f32"]["library_ms"],
        **tf32x3_bound((qkv.numel() + m * w) * 4, attn_flops)}
    gb = gen(263)
    qb32, vb32 = (torch.randn(w, generator=gb, device="cuda") * 0.5
                  for _ in range(2))
    qbh, vbh = (split_heads(t + bias, heads) for t, bias in
                ((qkv[..., :w], qb32), (qkv[..., 2 * w:], vb32)))
    res["K8f32"] = {
        "ms": cuda_ms(lambda: fused_attention_qkv(qkv, qb32, vb32, scale,
                                                  heads), 5),
        "plain_ms": cuda_ms(lambda: fused_attention_qkv_ref(
            qkv, qb32, vb32, scale, heads), 3),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qbh, k, vbh, scale=scale), 5),
        **tf32x3_bound((qkv.numel() + 2 * w + m * w) * 4, attn_flops)}
    pq, pk, pv = f32_inputs(BATCH, 262, TOKENS, PADDED_HD).chunk(3, -1)
    sq, sk, sv = (split_heads(t, heads) for t in (pq, pk, pv))
    res["K7f32"] = {
        "ms": cuda_ms(lambda: fused_attention_packed(pq, pk, pv, p128,
                                                     heads), 5),
        "plain_ms": cuda_ms(lambda: fused_attention_packed_ref(
            pq, pk, pv, p128, heads), 3),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, scale=p128), 5),
        **tf32x3_bound(4 * pq.numel() * 4, flops128)}
    # the f32 int8 factory's forms, each beside its bf16 counterpart (K3,
    # K9 int8, K8 int8, K2, K4 above) on the same values in f32
    for key, fn, ref, kw in (
            ("K3f32", fused_attention_qkv3, fused_attention_qkv3_ref, {}),
            ("K9qf32", fused_attention_qkv2, fused_attention_qkv2_ref, {}),
            ("K8qf32", fused_attention_qkv, fused_attention_qkv_ref,
             dict(bias=True))):
        def call(f, bias=False):
            if bias:
                return lambda: f(qkv, qb32, vb32, scale, heads,
                                 quant_out=True)
            return lambda: f(qkv, scale, heads, quant_out=True)

        res[key] = {
            "ms": cuda_ms(call(fn, **kw), 5),
            "plain_ms": cuda_ms(call(ref, **kw), 3),
            "library_ms": None,
            **tf32x3_bound((qkv.numel() + (2 * w if kw else 0)) * 4
                           + m * w + m * 4, attn_flops)}
    x32 = x.float()
    res["K2f32"] = {
        "ms": cuda_ms(lambda: ln_quant(x32, g, bb, EPS), 20),
        "plain_ms": cuda_ms(lambda: ln_quant_ref(x32, g, bb, EPS), 5),
        "library_ms": None,
        **bound(m * w * 4 + m * w + m * 4 + 2 * w * 4,
                (ROW_SLOTS["K2"] - 1) * m * w, ISSUE_SLOTS_PER_S)}
    # K5's and K10's f32 forms on the same rows in f32 (inputs of 1 GB and
    # 185 MB, past the 50 MB L2); K10 beside F.layer_norm in f32
    h6f, h1f, x10f = h6.float(), h1.float(), x10.float()
    res["K5f32"] = {
        "ms": cuda_ms(lambda: act_quant(h6f, act="gelu_poly"), 20),
        "plain_ms": cuda_ms(lambda: act_quant_ref(h6f, act="gelu_poly"), 5),
        "library_ms": None,
        **bound(m * hid * 5 + m * 4,
                (ROW_SLOTS["K5 gelu_poly"] - 1) * m * hid, ISSUE_SLOTS_PER_S)}
    extra["K5f32 act=none [M,1408]"] = {
        "ms": cuda_ms(lambda: act_quant(h1f), 20),
        "plain_ms": cuda_ms(lambda: act_quant_ref(h1f), 5),
        "library_ms": None,
        **bound(m * w * 5 + m * 4, (ROW_SLOTS["K5 none"] - 1) * m * w,
                ISSUE_SLOTS_PER_S)}
    res["K10f32"] = {
        "ms": cuda_ms(lambda: ln_bf16(x10f, g10, b10, EPS), 20),
        "plain_ms": cuda_ms(lambda: ln_bf16_ref(x10f, g10, b10, EPS), 5),
        "library_ms": cuda_ms(lambda: F.layer_norm(x10f, (w,), g10, b10,
                                                   EPS), 20),
        **bound(m * w * 4 * 2 + 2 * w * 4, (ROW_SLOTS["K10"] - 1.5) * m * w,
                ISSUE_SLOTS_PER_S)}
    args32 = (*args[:-1], x_res.float())
    res["K4f32"] = {
        "ms": cuda_ms(lambda: fused_mlp_int8(*args32), 5),
        "plain_ms": cuda_ms(lambda: fused_mlp_int8_ref(*args32), 3),
        "library_ms": res["K4"]["library_ms"],
        **bound(m * w + m * 4 + 2 * m * w * 4 + 2 * hid * w
                + 4 * (2 * hid + 2 * w), 2 * 2 * m * w * hid, INT8_OP_PER_S)}
    # E1 on fc1's output (bias, gelu_bf16_poly) and on the qkv projection
    # (its bias alone), E2 on proj's and fc2's, in bf16 and f32
    for key, r in epilogue_times(m, w, hid, kernels=True).items():
        (res if key in ("E1", "E2", "E1f32", "E2f32") else extra)[key] = r
    # E3 on the qkv projection and on out / fc2 with the residual, E4 on
    # the unrolled tower's trunk and patch rows, in bf16 and f32
    e3e4, e3e4_extra = int8_epilogue_times(m, w, hid)
    res.update(e3e4)
    extra.update(e3e4_extra)
    # G1 at every product it takes over, beside torch._int_mm and
    # torch._int_mm + E3
    g1, g1_extra = int8_gemm_times(variants=False)
    res.update(g1)
    print_int8_gemm_times({**g1, **g1_extra}, card, "timing")
    for key, base in (("K3f32", "K3"), ("K9qf32", "K9q"), ("K8qf32", "K8q"),
                      ("K2f32", "K2"), ("K4f32", "K4"), ("K5f32", "K5"),
                      ("K10f32", "K10"), ("E1f32", "E1"), ("E2f32", "E2"),
                      ("E3f32", "E3"), ("E4f32", "E4"), ("G1f32", "G1")):
        print(f"[timing] {card}: {key} (f32 activations) {res[key]['ms']:.4f}"
              f" ms beside {base} (bf16) {res[base]['ms']:.4f} ms, "
              f"{res[key]['ms'] / res[base]['ms']:.2f}x")
    for name, r in {**res, **stages, **padded, **extra,
                    **f32_extra}.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        ref = ("" if "reference_ms" not in r else
               f", same-bytes reference {r['reference_ms']:.4f} ms")
        print(f"[timing] {card}: {name} B={BATCH}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {lib} ms{ref}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.3f} of it")
    return res, fps


KERNEL_GROUPS = {  # precision -> (group, substrings of a device kernel's name)
    "bf16": (
        ("E1 bias_act (CUDA)", ("bias_act_kernel",)),
        ("E2 bias_residual (CUDA)", ("bias_residual_kernel",)),
        ("K1 attention_qkv3 (CUDA)", ("attention_qkv3",)),
        ("projections (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
        ("layer_norm", ("layer_norm",)),
        ("elementwise (casts, the qkv bias's cat; without E1/E2 the GELU "
         "chain, bias, residual)", ("elementwise", "reduce")),
    ),
    "int8": (
        ("G1 int8_gemm, products and dequant (CUDA)",
         ("int8_gemm",)),
        ("E3 int8_epilogue dequant (CUDA)", ("dequant_kernel",)),
        ("K2 ln_quant (CUDA)", ("ln_quant", "ln_kernel")),
        ("K3 attention_qkv3, int8 epilogue in the kernel (CUDA; the two-step "
         "epilogue's quant_rows too, should it run)",
         ("attention_qkv3", "quant_rows")),
        ("K4 fused_mlp_int8 (CUDA)", ("fused_mlp_int8",)),
        ("other GEMMs (cuBLAS; torch._int_mm before G1)",
         ("nvjet", "gemm", "cutlass", "xmma", "imma")),
        ("elementwise (casts; without E3 the dequant chain)",
         ("elementwise", "reduce")),
    ),
    "ladder bf16": (
        ("E1 bias_act (CUDA)", ("bias_act_kernel",)),
        ("E2 bias_residual (CUDA)", ("bias_residual_kernel",)),
        ("K8 attention_qkv3, v1 form (CUDA; attention_split.cu in "
         "earlier checkouts)",
         ("attention_qkv3", "attention_split")),
        ("projections (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
        ("layer_norm", ("layer_norm",)),
        ("elementwise (casts; without E1/E2 the GELU chain, bias, "
         "residual)", ("elementwise", "reduce")),
    ),
    "ladder int8 K8": (
        ("G1 int8_gemm, products and dequant (CUDA)",
         ("int8_gemm",)),
        ("E3 int8_epilogue dequant (CUDA)", ("dequant_kernel",)),
        ("E1 bias_act (CUDA)", ("bias_act_kernel",)),
        ("E2 bias_residual (CUDA)", ("bias_residual_kernel",)),
        ("K2 ln_quant (CUDA)", ("ln_quant", "ln_kernel")),
        ("K8 attention_qkv3, v1 form, int8 epilogue in the kernel (CUDA; "
         "the two-step epilogue's quant_rows too, should it run; "
         "attention_split.cu in earlier checkouts)",
         ("attention_qkv3", "quant_rows", "attention_split")),
        ("K5 act_quant (CUDA; int8 dyn's row quantization too)",
         ("act_quant",)),
        ("other GEMMs (cuBLAS; torch._int_mm before G1)",
         ("nvjet", "gemm", "cutlass", "xmma", "imma")),
        ("elementwise (casts; without E3 and K5 the dequant and row "
         "quantization chains, without E1 int8 dyn's GELU chain)",
         ("elementwise", "reduce")),
    ),
    "ladder int8": (
        ("G1 int8_gemm, products and dequant (CUDA)",
         ("int8_gemm",)),
        ("E3 int8_epilogue dequant (CUDA)", ("dequant_kernel",)),
        ("K2 ln_quant (CUDA)", ("ln_quant", "ln_kernel")),
        ("K3 attention_qkv3, int8 epilogue in the kernel (CUDA; the two-step "
         "epilogue's quant_rows too, should it run)",
         ("attention_qkv3", "quant_rows")),
        ("K5 act_quant (CUDA)", ("act_quant",)),
        ("other GEMMs (cuBLAS; torch._int_mm before G1)",
         ("nvjet", "gemm", "cutlass", "xmma", "imma")),
        ("elementwise (casts; without E3 the dequant chain)",
         ("elementwise", "reduce")),
    ),
    "ladder f32": (
        ("E1 bias_act (CUDA)", ("bias_act_kernel",)),
        ("E2 bias_residual (CUDA)", ("bias_residual_kernel",)),
        ("K1 f32 attention_f32 (CUDA)", ("attention_f32",)),
        ("K10 f32 ln_f32_kernel (CUDA)", ("ln_f32_kernel<false>",
                                          "ln_f32_kernelILb0E")),
        ("projections (cuBLAS, f32)", ("nvjet", "gemm", "cutlass", "xmma")),
        ("elementwise (casts; without E1/E2 the GELU chain, bias, "
         "residual)", ("elementwise", "reduce")),
    ),
    "ladder f32 int8": (
        ("G1 f32 int8_gemm, products and dequant (CUDA)",
         ("int8_gemm",)),
        ("E3 f32 int8_epilogue dequant (CUDA)", ("dequant_kernel",)),
        ("K2 f32 ln_f32_kernel (CUDA)", ("ln_f32_kernel<true>",
                                         "ln_f32_kernelILb1E")),
        ("K3 f32 attention_f32 int8 epilogue (CUDA, both steps)",
         ("attention_f32", "quant_rows")),
        ("K5 f32 act_quant_f32_kernel (CUDA)", ("act_quant_f32",)),
        ("other GEMMs (cuBLAS; torch._int_mm before G1)",
         ("nvjet", "gemm", "cutlass", "xmma", "imma")),
        ("elementwise (without E3 the dequant chain)",
         ("elementwise", "reduce")),
    ),
    "serving": (
        ("matmuls (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma", "gemv")),
        ("softmax and log_softmax", ("softmax",)),
        ("top-k and sort (beam)", ("topk", "sort", "radix", "bitonic")),
        ("reductions (LayerNorm statistics, norms, argmax)", ("reduce",)),
        ("gathers, index copies, cat", ("index", "gather", "scatter",
                                        "Cat", "copy")),
        ("elementwise", ("elementwise",)),
    ),
    "unrolled int8": (
        ("G1 int8_gemm, products and dequant (CUDA)",
         ("int8_gemm",)),
        ("E3 int8_epilogue dequant (CUDA)", ("dequant_kernel",)),
        ("E4 row_quant (CUDA: act_quant_kernel's ring; the patch rows' "
         "row_quant_kernel)", ("row_quant_kernel", "act_quant_kernel")),
        ("K6 attention_qkv3, v1 form (CUDA; attention_split.cu in "
         "earlier checkouts)",
         ("attention_qkv3", "attention_split")),
        ("other GEMMs (bf16 cuBLAS qkv/out without quant_attention; "
         "torch._int_mm before G1)", ("nvjet", "gemm", "cutlass", "xmma",
                                      "imma")),
        ("exact GELU", ("gelu", "Gelu")),
        ("elementwise and reductions (LayerNorm, q/v bias, residual, "
         "casts; without E3 and E4 the dequant and row quantization "
         "chains)", ("elementwise", "reduce")),
    ),
    "asr": (
        ("matmuls (cuBLAS, f32)", ("nvjet", "gemm", "cutlass", "xmma",
                                   "gemv")),
        ("softmax", ("softmax",)),
        ("layer_norm", ("layer_norm",)),
        ("reductions", ("reduce",)),
        ("gathers, index copies, cache writes, cat",
         ("index", "gather", "scatter", "Cat", "copy")),
        ("elementwise (GELU, bias, residual, mask)", ("elementwise",)),
    ),
    "training": (
        ("matmuls (cuBLAS, f32)", ("nvjet", "gemm", "cutlass", "xmma",
                                   "gemv")),
        ("softmax and log_softmax, forward and backward", ("softmax",)),
        ("reductions (LayerNorm statistics, losses, norms)", ("reduce",)),
        ("gathers, scatters, index copies (embeddings)",
         ("index", "gather", "scatter", "Cat", "copy", "embedding")),
        ("elementwise (GELU, dropout, optimizer update)", ("elementwise",)),
    ),
    "clip": (
        ("K6 f32 attention_f32 (CUDA)", ("attention_f32",)),
        ("matmuls (cuBLAS, f32)", ("nvjet", "gemm", "cutlass", "xmma",
                                   "gemv")),
        ("reductions (LayerNorm statistics, norms)", ("reduce",)),
        ("copies, cat", ("copy", "Cat", "index")),
        ("elementwise (QuickGELU, bias, residual, casts)", ("elementwise",)),
    ),
    "unrolled": (
        ("K6/K7 attention_qkv3, v1 form (CUDA; attention_split.cu in "
         "earlier checkouts)", ("attention_qkv3", "attention_split")),
        ("projections (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
        ("exact GELU", ("gelu", "Gelu")),
        ("elementwise and reductions (LayerNorm, q/v bias, residual, casts)",
         ("elementwise", "reduce")),
    ),
}


def profile_call(label: str, fn, card: str, group_set: str,
                 tag: str = "profile") -> dict:
    """One call's device kernels by group from torch.profiler, and the
    device's idle share of its wall time, after one unprofiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict = {}
    kernels: dict = {}
    launches = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        launches += e.count
        group = next((g for g, keys in KERNEL_GROUPS[group_set]
                      if any(k in e.key for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
        kernels[e.key] = kernels.get(e.key, 0.0) + ms
    busy = sum(groups.values())
    print(f"[{tag}] {card}: {label}: wall {wall_ms:.2f} ms (profiled), "
          f"device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall_ms:.4f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}]   {g}: {ms:.2f} ms ({ms / busy:.4f} of busy)")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag}]     kernel {name[:110]}: {ms:.2f} ms")
    return {"wall_ms": wall_ms, "busy_ms": busy, "launches": launches,
            "kernels": kernels}


def profile_forward(tag: str, enc, batch: np.ndarray, card: str,
                    group_set: str) -> dict:
    """One forward's device kernels by group, and the idle share."""
    return profile_call(f"one {tag} forward B={BATCH}", lambda: enc(batch),
                        card, group_set)


def no_two_step_epilogue(tag: str, prof: dict) -> None:
    """K3's int8 epilogue ran inside the attention kernel: the profiled
    forward ran no quant_rows_kernel and no memset (the two-step
    epilogue's second kernel and its rowmax zeroing)."""
    found = [k for k in prof["kernels"]
             if "quant_rows" in k or "memset" in k.lower()]
    print(f"[profile] {tag}: quant_rows_kernel or memset on the device: "
          f"{found or 'none'}")
    require(not found, f"{tag} ran the two-step epilogue's {found}")


def phase_profile(cfg, main: dict, factory: dict, ladder: dict,
                  card: str) -> None:
    """Where one float-front-end forward's time goes, for each precision and
    for the factory's bf16 image configurations, and each plain per-layer
    op timed alone at the main path's shapes with CUDA events."""
    import torch.nn.functional as F

    from hirest_tpu_torch.models.eva_clip import layer_norm
    from hirest_tpu_torch.models.layers import (gelu, gelu_bf16_poly,
                                                layer_norm_fast_var)
    from hirest_tpu_torch.ops.quant import int8_epilogue, int8_mm

    batch = normalize_frames(main["frames"]["vid_a"][:BATCH])
    for tag, encoders in main["encoders"].items():
        prof = profile_forward(tag, encoders[False], batch, card, tag)
        if tag == "int8":
            no_two_step_epilogue("the production int8 forward", prof)
    for tag, groups in (("bf16", "ladder bf16"), ("int8", "ladder int8 K8"),
                        ("int8+fq", "ladder int8 K8"),
                        ("int8+fq+v3", "ladder int8")):
        prof = profile_forward(f"ladder {tag}", ladder["fns"][tag], batch,
                               card, groups)
        if tag in ("int8+fq", "int8+fq+v3"):  # K8 int8, K3
            no_two_step_epilogue(f"ladder {tag}", prof)
    for tag in ("unrolled", "padded_unrolled", "padded_scanned"):
        profile_forward(f"factory {tag}", factory["models"][tag].encode_image,
                        batch, card, "bf16" if "scanned" in tag
                        else "unrolled")

    m, w, hid = BATCH * TOKENS, cfg.width, cfg.mlp_hidden
    g = gen(3)

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.02
                ).to(torch.bfloat16)

    def codes(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8,
                             device="cuda", generator=g)

    x, h = rnd(m, w) * 50, rnd(m, hid) * 50
    wq, bq, wp, bp = rnd(3 * w, w), rnd(3 * w), rnd(w, w), rnd(w)
    w1, b1, w2, b2 = rnd(hid, w), rnd(hid), rnd(w, hid), rnd(w)
    norm = torch.nn.LayerNorm(w, device="cuda")
    x_q, x_s = codes(m, w), torch.rand((m, 1), device="cuda", generator=g)
    qkv_q, out_q = codes(3 * w, w), codes(w, w)
    qkv_s = torch.rand(3 * w, device="cuda", generator=g)
    out_s = torch.rand(w, device="cuda", generator=g)
    ops = {
        "qkv linear [M,1408]x[1408,4224]": lambda: F.linear(x, wq, bq),
        "proj linear [M,1408]x[1408,1408]": lambda: F.linear(x, wp, bp),
        "fc1 linear [M,1408]x[1408,6144]": lambda: F.linear(x, w1, b1),
        "fc2 linear [M,6144]x[6144,1408]": lambda: F.linear(h, w2, b2),
        "gelu_bf16_poly [M,6144]": lambda: gelu_bf16_poly(h),
        "layer_norm (f32) [M,1408]": lambda: layer_norm(x, norm),
        "_int_mm qkv [M,1408]x[1408,4224]": lambda: _INT_MM(x_q, qkv_q.t()),
        "_int_mm + E3 qkv (the chain before G1)": lambda: int8_epilogue(
            _INT_MM(x_q, qkv_q.t()), x_s, qkv_s, bq, torch.bfloat16),
        "int8_mm qkv (G1: product + dequant epilogue)": lambda: int8_mm(
            x_q, x_s, qkv_q, qkv_s, bq, torch.bfloat16),
        "_int_mm out [M,1408]x[1408,1408]": lambda: _INT_MM(x_q, out_q.t()),
        "_int_mm + E3 out + residual (the chain before G1)":
            lambda: int8_epilogue(_INT_MM(x_q, out_q.t()), x_s, out_s, bp,
                                  torch.bfloat16, x),
        "int8_mm out + residual (G1)": lambda: int8_mm(
            x_q, x_s, out_q, out_s, bp, torch.bfloat16, x),
        "exact gelu [M,6144]": lambda: gelu(h),
        "layer_norm_fast_var (flax arithmetic) [M,1408]":
            lambda: layer_norm_fast_var(x, norm),
    }
    for name, fn in ops.items():
        print(f"[profile] {card}: {name}, M={m}: "
              f"{cuda_ms(fn, 10):.4f} ms per call")


# the serving phase: prompts, rounds, the bar
SERVE_PROMPTS = ("make oatmeal pancake mix", "fold a fitted sheet",
                 "replace a bike inner tube")
# timed rounds: each prompt retrieved, each video analyzed in each mode
SERVE_ROUNDS = 20
SPLIT_ROUNDS = 5  # analyze requests a video and mode for the split
SERVE_TOL = 1e-5  # card vs CPU f32, cached vs full: of the largest |value|
MODES = {False: "host segmentation loop", True: "fused_segmentation"}


def percentiles(ms: list) -> str:
    return (f"p50 {np.percentile(ms, 50):.2f} ms, p95 "
            f"{np.percentile(ms, 95):.2f} ms over {len(ms)} requests")


def analysis_ok(res: dict, duration: float) -> None:
    lo, hi = res["moment_bounds"]
    require(0 <= lo <= hi <= duration,
            f"{res['video']}: moment bounds {res['moment_bounds']}")
    starts = [st["bounds"][0] for st in res["steps"]]
    require(starts == sorted(starts) and all(
        0 <= st["bounds"][0] <= st["bounds"][1] <= duration
        for st in res["steps"]), f"{res['video']}: steps {res['steps']}")


def timed_requests(engine, card: str) -> None:
    """p50/p95 of retrieve and analyze, host clock around each request,
    whose answer comes back to the host (so its device work has ended).
    SERVE_ROUNDS rounds, each retrieving every prompt and analyzing every
    video in both segmentation modes, one after the other, so the modes
    see the same host; analyze pooled and per video."""
    ret = []
    ana = {(fused, vid): [] for fused in MODES for vid in VIDEOS}
    try:
        for _ in range(SERVE_ROUNDS):
            for prompt in SERVE_PROMPTS:
                t0 = time.perf_counter()
                engine.retrieve(prompt, top_k=3)
                ret.append((time.perf_counter() - t0) * 1e3)
            for vid, (_, duration) in VIDEOS.items():
                for fused in MODES:
                    engine.config.fused_segmentation = fused
                    t0 = time.perf_counter()
                    engine.analyze(SERVE_PROMPTS[0], f"{vid}.mp4", duration)
                    ana[fused, vid].append((time.perf_counter() - t0) * 1e3)
    finally:
        engine.config.fused_segmentation = False
    print(f"[serving] {card}: retrieve {percentiles(ret)}")
    for fused, mode in MODES.items():
        pooled = [ms for vid in VIDEOS for ms in ana[fused, vid]]
        print(f"[serving] {card}: analyze ({mode}) pooled "
              f"{percentiles(pooled)}")
        for vid, (frames, duration) in VIDEOS.items():
            print(f"[serving] {card}: analyze ({mode}) {vid} ({frames} "
                  f"frames) {percentiles(ana[fused, vid])}")


def analyze_split(engine, card: str, fused: bool) -> None:
    """Where an analyze request's wall time goes, SPLIT_ROUNDS requests a
    video: each trainer step timed with a synchronize on either side, the
    rest host work (annotations, collate, feature loads, the segmentation
    walk's bookkeeping); means per video and pooled."""
    trainer = engine.trainer
    spans: dict = {}
    now = {}

    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spans.setdefault((now["vid"], name), []).append(
                (time.perf_counter() - t0) * 1e3)
            return out
        return call

    steps = {"text encode": "text_encoder_fn",
             "moment retrieval": "_predict_moment_retrieval",
             "segmentation iterations": "_predict_moment_segmentation",
             "beam decode (caption_encode + 48 steps)":
                 "_predict_step_captioning"}
    saved = {attr: trainer.__dict__.get(attr) for attr in steps.values()}
    for name, attr in steps.items():
        setattr(trainer, attr, timed(name, getattr(trainer, attr)))
    total = {vid: [] for vid in VIDEOS}
    engine.config.fused_segmentation = fused
    try:
        for _ in range(SPLIT_ROUNDS):
            for vid, (_, duration) in VIDEOS.items():
                now["vid"] = vid
                t0 = time.perf_counter()
                engine.analyze(SERVE_PROMPTS[0], f"{vid}.mp4", duration)
                total[vid].append((time.perf_counter() - t0) * 1e3)
    finally:  # the instance's own attribute back, or the class's method
        engine.config.fused_segmentation = False
        for attr, fn in saved.items():
            if fn is None:
                delattr(trainer, attr)
            else:
                setattr(trainer, attr, fn)
    for label, vids in [(vid, (vid,)) for vid in VIDEOS] + [
            ("pooled", tuple(VIDEOS))]:
        n = sum(len(total[v]) for v in vids)
        parts = {name: sum(sum(spans.get((v, name), ())) for v in vids) / n
                 for name in steps}
        wall = sum(sum(total[v]) for v in vids) / n
        parts["host rest"] = wall - sum(parts.values())
        print(f"[serving] {card}: analyze split ({MODES[fused]}, {label}), "
              f"mean of {n} requests, {wall:.2f} ms: " + "; ".join(
                  f"{k} {v:.2f} ms" for k, v in parts.items()))


def serving_engine(feat_dir: Path, device: str):
    """The engine as `python -m hirest_tpu_torch.serve` builds it, at full
    width: the EVA-CLIP-g text tower (12 x 768) and MomentModel at
    JointModelConfig() with seeded random weights, 5 beams of 48 words,
    HirestConfig's defaults otherwise (f32)."""
    from hirest_tpu_torch.serve.__main__ import build_engine, parse_args

    engine = build_engine(parse_args([
        "--video_feature_dir", str(feat_dir), "--num_beams", "5",
        "--pretrained_dir", str(feat_dir / "none"), "--device", device]))
    return engine


def traced_select(trace: list, on_step=None):
    """A stand-in for infer/beam.py's `_select` that records each step
    (host copies: the prefixes [B, k, t + 1] and scores [B, k] it was
    given, the chosen source slots and tokens [B, k], and the least gap
    between neighbours among each instance's k + 1 best candidates [B],
    with their largest magnitude) and calls on_step(seqs, logits, t)
    first. Returns (the stand-in, the function it stands in for)."""
    from hirest_tpu_torch.infer import beam

    select = beam._select

    def probe(seqs, scores, logits, t):
        if on_step is not None:
            on_step(seqs, logits, t)
        b, k, _ = seqs.shape
        cand = (scores[:, :, None] + torch.log_softmax(
            logits.float(), dim=-1).reshape(b, k, -1)).reshape(b, -1)
        top = cand.topk(k + 1, dim=1).values
        out = select(seqs, scores, logits, t)
        trace.append({
            "seqs": seqs[:, :, :t + 1].cpu().numpy(),
            "scores": scores.cpu().numpy(),
            "src": out[2].cpu().numpy(),
            "tok": out[0][:, :, t + 1].cpu().numpy(),
            "gap": (top[:, :-1] - top[:, 1:]).min(1).values.cpu().numpy(),
            "top": top[:, 0].abs().max().item()})
        return out

    return probe, select


def served_captioning(engine, prompt: str, vid: str, on_step=None) -> tuple:
    """One analyze request as the engine serves it, with the batch that
    reached `Trainer._predict_step_captioning` kept and its beam's steps
    traced (traced_select; on_step(arrs, seqs, logits, t)). Returns (the
    answer, the batch or None, the trace)."""
    from hirest_tpu_torch.infer import beam

    tr, seen, trace = engine.trainer, {}, []
    predict = tr._predict_step_captioning

    def predict_probe(arrs):
        seen["arrs"] = arrs
        return predict(arrs)

    probe, select = traced_select(trace, None if on_step is None else (
        lambda seqs, logits, t: on_step(seen["arrs"], seqs, logits, t)))
    tr._predict_step_captioning, beam._select = predict_probe, probe
    try:
        res = engine.analyze(prompt, f"{vid}.mp4", VIDEOS[vid][1])
    finally:
        del tr._predict_step_captioning
        beam._select = select
    return res, seen.get("arrs"), trace


def held(tag: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max |got - want| over the largest |want|, required within SERVE_TOL."""
    err = (got.float().cpu() - want.float().cpu()).abs().max().item()
    top = want.float().abs().max().item()
    print(f"[serving] {tag}: max err {err:.3e}, {err / top:.3e} of max "
          f"|value| {top:.4f}")
    require(err <= SERVE_TOL * top, f"{tag} beyond {SERVE_TOL}")
    return err


def same_selections(tag: str, got: tuple, want: tuple, err: float,
                    phase: str = "serving") -> None:
    """Two runs of one beam (captions, trace) make the same choice at every
    step, unless the step's inputs were equal and want's least gap among
    the k + 1 best candidates of the instance lies within what the two
    runs' differences can move: 2 d + 8 err + 2 ulp, d the largest score
    difference it was given, err the largest logit difference measured on
    equal inputs (doubled for each run's own caches), ulp the candidates'
    rounding. An instance whose choice was excused so is not checked
    further; every other one must end on the same caption."""
    (got_caps, got_tr), (want_caps, want_tr) = got, want
    require(len(got_tr) == len(want_tr), f"{tag}: step counts differ")
    excused = {}
    for t, (g, w) in enumerate(zip(got_tr, want_tr)):
        ulp = float(np.spacing(np.float32(max(g["top"], w["top"]))))
        for i in range(len(w["gap"])):
            if i in excused:
                continue
            require((g["seqs"][i] == w["seqs"][i]).all(),
                    f"{tag}: instance {i} reached step {t} on other prefixes")
            if ((g["src"][i] == w["src"][i]).all()
                    and (g["tok"][i] == w["tok"][i]).all()):
                continue
            d = float(np.abs(g["scores"][i] - w["scores"][i]).max())
            slack = 2 * d + 8 * err + 2 * ulp
            print(f"[{phase}] {tag} instance {i}: choice differs at step "
                  f"{t}, least gap {w['gap'][i]:.3e}, slack {slack:.3e}")
            require(w["gap"][i] <= slack,
                    f"{tag}: instance {i} chose otherwise at step {t}")
            excused[i] = t
    for i, (g, w) in enumerate(zip(got_caps, want_caps)):
        require(i in excused or g == w, f"{tag}: caption {i} differs")
    gaps = np.concatenate([w["gap"] for w in want_tr])
    print(f"[{phase}] {tag}: {sum(g == w for g, w in zip(got_caps, want_caps))}"
          f" of {len(want_caps)} captions equal; the same choice at every "
          f"step of {len(want_caps) - len(excused)} instances; least gaps "
          f"{np.sort(gaps)[:3]}, median {np.median(gaps):.3e}")


def moment_logits(engine, prompt: str, name: str, duration: float,
                  bounds: list) -> dict:
    """The moment-retrieval and first segmentation iteration's logits of
    one request's batches."""
    from hirest_tpu_torch.data.annotations import build_examples
    from hirest_tpu_torch.data.batching import collate

    tr = engine.trainer
    anns = {prompt: {name: {"relevant": True, "clip": True,
                            "v_duration": duration, "bounds": bounds,
                            "steps": []}}}
    out = {}
    for task in ("moment_retrieval", "moment_segmentation"):
        batch = collate(build_examples(anns, task, -1, end_to_end=True),
                        tr.store, tr.buckets)
        arrs = tr._prepare(batch, task)
        with torch.inference_mode():
            if task == "moment_retrieval":
                res = tr.model.moment_retrieval(
                    arrs["vis_feats"], arrs["text_feat"],
                    arrs["video_mask"], arrs["moment_mask"])
                out[task] = torch.cat([res["start_logits"],
                                       res["end_logits"]])
            else:
                out[task] = tr.model.moment_segmentation(
                    arrs["vis_feats"], arrs["text_feat"], arrs["video_mask"],
                    arrs["moment_mask"], None, arrs["video_mask"] * 0)
    return out


def compare_card_cpu(engine, cpu_engine) -> None:
    """One analyze request a video and prompt (SERVE_PROMPTS[1:]) on the
    card against the port's CPU f32 engine, each within SERVE_TOL of the
    CPU value's largest magnitude: the moment-retrieval and first
    segmentation logits; the served step-captioning batch's caption_encode
    (the CPU's batch on both); and every decode_step of the CPU's served
    beam, replayed on the card from the CPU's inputs (tokens, cross keys
    and values, caches). Bounds equal; the two served beams' choices held
    by same_selections. On the card the served (cached) beam is also held
    against the full re-decode beam: the full decoder's logits at each
    served step's prefixes within SERVE_TOL of the cached ones, and the
    choices by same_selections."""
    from hirest_tpu_torch.infer import beam

    tr, cpu_tr = engine.trainer, cpu_engine.trainer
    dec, cpu_dec = tr.model.decoder, cpu_tr.model.decoder
    k, words = tr.config.num_beams, tr.config.max_words
    require(tr.tokenizer is None, "captions are ids without a vocabulary")

    def to_card(x):
        if isinstance(x, torch.Tensor):
            return x.to(tr.device)
        return tuple(to_card(y) for y in x)

    def ids_text(row) -> str:  # the trainer's captions without a vocabulary
        return " ".join(str(int(x)) for x in row if x != 0)

    for prompt in SERVE_PROMPTS[1:]:
        for vid, (_, duration) in VIDEOS.items():
            name, tag = f"{vid}.mp4", f"{vid} {prompt!r}"
            err = {"card": 0.0, "full": 0.0}
            state = {}

            def full_vs_cached(arrs, seqs, logits, t):
                if "enc" not in state:
                    state["enc"] = tr.model.caption_encode(
                        arrs["vis_feats"], arrs["text_feat"],
                        arrs.get("asr_feats")).repeat_interleave(k, dim=0)
                b = seqs.shape[0]
                full = dec(seqs.reshape(b * k, -1)[:, :words],
                           state["enc"])[:, t]
                e = (full - logits).abs().max().item()
                err["full"] = max(err["full"], e)
                state["top"] = max(state.get("top", 0.0),
                                   logits.abs().max().item())

            got, arrs, got_tr = served_captioning(engine, prompt, vid,
                                                  full_vs_cached)
            analysis_ok(got, duration)
            cpu_step = cpu_dec.decode_step
            tops = []

            def replay(last, t, cross, cache):
                card_in = (last.to(tr.device), t, to_card(cross),
                           to_card(cache))
                logits, cache = cpu_step(last, t, cross, cache)
                with torch.inference_mode():
                    on_card = dec.decode_step(*card_in)[0].cpu()
                err["card"] = max(err["card"],
                                  (on_card - logits).abs().max().item())
                tops.append(logits.abs().max().item())
                return logits, cache

            cpu_dec.decode_step = replay
            try:
                want, cpu_arrs, want_tr = served_captioning(cpu_engine,
                                                            prompt, vid)
            finally:
                del cpu_dec.decode_step
            require(got["moment_bounds"] == want["moment_bounds"]
                    and [s["bounds"] for s in got["steps"]]
                    == [s["bounds"] for s in want["steps"]],
                    f"{tag}: bounds differ card {got} CPU {want}")
            card_logits = moment_logits(engine, prompt, name, duration,
                                        want["moment_bounds"])
            for task, logits in moment_logits(cpu_engine, prompt, name,
                                              duration,
                                              want["moment_bounds"]).items():
                held(f"{tag} {task} logits card vs CPU f32",
                     card_logits[task], logits)
            print(f"[serving] {tag}: card and CPU agree on bounds "
                  f"{got['moment_bounds']} and {len(got['steps'])} steps")
            if arrs is None:
                continue
            with torch.inference_mode():
                held(f"{tag} caption_encode card vs CPU f32",
                     tr.model.caption_encode(
                         *to_card((cpu_arrs["vis_feats"],
                                   cpu_arrs["text_feat"]))),
                     cpu_tr.model.caption_encode(cpu_arrs["vis_feats"],
                                                 cpu_arrs["text_feat"]))
            top = max(tops)
            print(f"[serving] {tag} decode_step card vs CPU f32 on the CPU "
                  f"beam's {len(tops)} steps: max err {err['card']:.3e}, "
                  f"{err['card'] / top:.3e} of max |logit| {top:.4f}")
            require(err["card"] <= SERVE_TOL * top,
                    f"{tag}: decode_step beyond {SERVE_TOL}")
            captions = [s["caption"] for s in got["steps"]]
            same_selections(f"{tag} card vs CPU beam", (captions, got_tr),
                            ([s["caption"] for s in want["steps"]],
                             want_tr), err["card"])

            print(f"[serving] {tag} full re-decode vs cached logits at the "
                  f"served beam's prefixes: max err {err['full']:.3e}, "
                  f"{err['full'] / state['top']:.3e} of max |logit| "
                  f"{state['top']:.4f}")
            require(err["full"] <= SERVE_TOL * state["top"],
                    f"{tag}: cached decode beyond {SERVE_TOL}")
            b, full_tr = len(got["steps"]), []
            probe, select = traced_select(full_tr)
            beam._select = probe
            try:
                with torch.inference_mode():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    full, _ = beam.beam_search(
                        lambda ids, t: dec(ids[:, :words],
                                           state["enc"])[:, t],
                        b, k, words, tr.bos_id, tr.eos_id, device=tr.device)
                    full = [ids_text(row) for row in full.cpu().numpy()]
                    ms = (time.perf_counter() - t0) * 1e3
            finally:
                beam._select = select
            same_selections(f"{tag} cached vs full beam", (captions, got_tr),
                            (full, full_tr), err["full"])
            print(f"[serving] {tag}: full re-decode beam (traced) on {b} "
                  f"captions x {k} beams x {words} words in {ms:.2f} ms")


def http_requests(engine, direct: dict) -> None:
    """Every request again through the HTTP server on 127.0.0.1, port 0:
    /health, /v1/retrieve and /v1/analyze give what the engine gave."""
    import threading
    import urllib.request

    from hirest_tpu_torch.serve import make_server

    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(
            url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
        print(f"[serving] http /health: {health}")
        require(health["indexed_videos"] == len(VIDEOS)
                and "cuda" in health["devices"][0], "health")
        for prompt in SERVE_PROMPTS:
            got = post("/v1/retrieve", {"prompt": prompt, "top_k": 3})
            require(got == json.loads(json.dumps(direct["retrieve", prompt])),
                    f"http retrieve {prompt!r}")
        for vid, (_, duration) in VIDEOS.items():
            got = post("/v1/analyze", {"prompt": SERVE_PROMPTS[0],
                                       "video": f"{vid}.mp4",
                                       "video_duration": duration})
            require(got == json.loads(json.dumps(direct["analyze", vid])),
                    f"http analyze {vid}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    print(f"[serving] http: {len(SERVE_PROMPTS)} retrieve and "
          f"{len(VIDEOS)} analyze requests through {url} gave the engine's "
          f"answers")


def phase_serving(main: dict, card: str) -> None:
    """The serving path at full width over phase_main's int8 features."""
    import tempfile

    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        feat_dir = Path(tmp)
        for vid, feats in main["features"].items():
            np.save(feat_dir / f"{vid}.mp4.npy", feats)
        t0 = time.perf_counter()
        engine = serving_engine(feat_dir, "cuda")
        torch.cuda.synchronize()
        zero_counts()  # read at the end: no request launches a kernel
        print(f"[serving] engine on {engine.health()['devices'][0]} built in "
              f"{time.perf_counter() - t0:.1f} s; warmup {engine.warmup()}")
        direct = {}
        for prompt in SERVE_PROMPTS:
            direct["retrieve", prompt] = engine.retrieve(prompt, top_k=3)
            print(f"[serving] retrieve {prompt!r}: "
                  f"{direct['retrieve', prompt]}")
        for vid, (_, duration) in VIDEOS.items():
            res = engine.analyze(SERVE_PROMPTS[0], f"{vid}.mp4", duration)
            analysis_ok(res, duration)
            direct["analyze", vid] = res
            first = res["steps"][0] if res["steps"] else {"caption": ""}
            print(f"[serving] analyze {vid} ({duration} s): moment "
                  f"{res['moment_bounds']}, steps "
                  f"{[st['bounds'] for st in res['steps']]}, first caption "
                  f"{first['caption'][:60]!r}")
        http_requests(engine, direct)
        engine.config.fused_segmentation = True
        for vid, (_, duration) in VIDEOS.items():
            res = engine.analyze(SERVE_PROMPTS[0], f"{vid}.mp4", duration)
            analysis_ok(res, duration)
            print(f"[serving] fused_segmentation analyze {vid}: steps "
                  f"{[st['bounds'] for st in res['steps']]}; host loop's "
                  f"{[st['bounds'] for st in direct['analyze', vid]['steps']]}")
        engine.config.fused_segmentation = False
        t0 = time.perf_counter()
        timed_requests(engine, card)
        print(f"[serving] timed requests took "
              f"{time.perf_counter() - t0:.1f} s")
        for fused, mode in MODES.items():
            analyze_split(engine, card, fused)
            engine.config.fused_segmentation = fused
            try:
                profile_call(f"one analyze request (vid_a, {mode})",
                             lambda: engine.analyze(
                                 SERVE_PROMPTS[0], "vid_a.mp4",
                                 VIDEOS["vid_a"][1]), card, "serving",
                             tag="serving")
            finally:
                engine.config.fused_segmentation = False
        t0 = time.perf_counter()
        cpu_engine = serving_engine(feat_dir, "cpu")
        print(f"[serving] CPU f32 engine built in "
              f"{time.perf_counter() - t0:.1f} s")
        compare_card_cpu(engine, cpu_engine)
        print(f"[serving] checks against the CPU and the full beam took "
              f"{time.perf_counter() - t0:.1f} s")
        counts = read_counts()
        print(f"[serving] kernel launches during every request and check "
              f"above: {counts}")
        require(counts == expect(), "the serving path launched a kernel")
    print(f"[serving] phase done in {time.perf_counter() - start:.1f} s")


# the ASR phase: the audio, the bars, the readings' sizes
ASR_SECONDS = 45.0  # two 30 s windows of seeded audio
ASR_VIDEO = "vid_b"  # its int8 features (phase 3) sit beside the ASR ones
ASR_TOL = 1e-5  # card vs CPU f32 (TF32 off): of the largest |value|
ASR_PROMPTS = ("make oatmeal pancake mix", "fold a fitted sheet")
MINILM_BATCH = 64  # sentences an embed call when timed
MINILM_ROUNDS = 20
CUSTOM_BATCH = 64  # extract_video_features' frames a forward
PROFILE_STEPS = 48  # sampled steps of the profiled decode_segment


def speechlike_audio(seconds: float, seed: int) -> np.ndarray:
    """16-bit mono 16 kHz samples made from the seed: voiced bursts (five
    harmonics of a drifting pitch under a syllable-rate envelope) over
    noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    voice = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = np.clip(np.sin(2 * np.pi * 3.7 * t + rng.uniform(0, 6)), 0, 1)
    x = 0.3 * voice * env + 0.02 * rng.normal(size=t.size)
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


def write_byte_vocab(root: Path) -> tuple:
    """A byte-level GPT-2 BPE pair (vocab.json, merges.txt) with ids
    0 .. 50256: the 256 byte symbols, then merged pairs of them, and
    <|endoftext|> at 50256, so every text id a decode can emit has a
    token. Returns (vocab path, merges path)."""
    from hirest_tpu_torch.tokenizers.gpt2_bpe import bytes_to_unicode

    sym = [bytes_to_unicode()[b] for b in range(256)]
    order = sorted(range(256), key=lambda b: (not chr(b).isalnum(), b))
    pairs = [(sym[a], sym[b]) for a in order for b in order][: 50257 - 257]
    tokens = sym + [a + b for a, b in pairs] + ["<|endoftext|>"]
    (root / "vocab.json").write_text(json.dumps(
        {tok: i for i, tok in enumerate(tokens)}))
    (root / "merges.txt").write_text("#version: 0.2\n" + "\n".join(
        f"{a} {b}" for a, b in pairs))
    return str(root / "vocab.json"), str(root / "merges.txt")


def write_minilm_pretrained(root: Path) -> dict:
    """`minilm.pt` (seeded all-MiniLM-L6-v2-shaped weights) and a
    30522-entry WordPiece vocab.txt (the specials, letters and digits and
    their ## forms, then words) under root. Returns the state dict."""
    import string

    from hirest_tpu_torch.utils.init import random_minilm_state_dict

    sd = random_minilm_state_dict(seed=0)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               root / "minilm.pt")
    chars = list(string.ascii_lowercase + string.digits)
    words = chars + [f"##{c}" for c in chars]
    words += [f"word{i}" for i in range(VOCAB_SIZE - 5 - len(words))]
    (root / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words) + "\n")
    return sd


class AsrRecorder:
    """Wraps, for the length of a `with`, the transcriber's `transcribe`,
    the adapter's encode, init_state and step, and `decode_segment`,
    recording each 30 s
    window: its mel and the card's encoder output, the encode time
    (synchronized), every decode_segment's temperature, steps and wall
    time, every step's wall time (launches, device work and the logits'
    fetch); and for the first window every adapter call in order with its
    inputs and the card's logits, for the CPU replay."""

    def __init__(self):
        self.windows: list = []
        self.transcribe_s: list = []

    def __enter__(self):
        from hirest_tpu_torch.extraction import asr, whisper_decode as wd

        A = wd.TorchWhisperAdapter
        self.saved = [(A, n, getattr(A, n)) for n in
                      ("encode", "init_state", "step")]
        self.saved += [(wd, "decode_segment", wd.decode_segment),
                       (asr.TorchWhisperTranscriber, "transcribe",
                        asr.TorchWhisperTranscriber.transcribe)]
        orig = {n: f for _, n, f in self.saved}
        rec = self

        def encode(adapter, mel):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = orig["encode"](adapter, mel)
            torch.cuda.synchronize()
            rec.windows.append({"mel": mel.copy(), "enc": enc,
                                "encode_ms": (time.perf_counter() - t0) * 1e3,
                                "segments": [], "step_ms": [], "calls": []})
            return enc

        def init_state(adapter, enc, n_seq, max_len):
            w = rec.windows[-1]
            if len(rec.windows) == 1:
                w["calls"].append(("init", enc, n_seq, max_len))
            return orig["init_state"](adapter, enc, n_seq, max_len)

        def step(adapter, state, tokens, pos):
            t0 = time.perf_counter()
            logits, state = orig["step"](adapter, state, tokens, pos)
            w = rec.windows[-1]
            w["step_ms"].append((time.perf_counter() - t0) * 1e3)
            if len(rec.windows) == 1:
                w["calls"].append(("step", np.array(tokens), pos, logits))
            return logits, state

        def decode_segment(adapter, enc, tok, options, temperature, **kw):
            w = rec.windows[-1]
            n0, t0 = len(w["step_ms"]), time.perf_counter()
            res = orig["decode_segment"](adapter, enc, tok, options,
                                         temperature, **kw)
            w["segments"].append({
                "temperature": temperature,
                "steps": len(w["step_ms"]) - n0,
                "ms": (time.perf_counter() - t0) * 1e3,
                "tokens": len(res.tokens)})
            return res

        def transcribe(tr, audio):
            t0 = time.perf_counter()
            out = orig["transcribe"](tr, audio)
            rec.transcribe_s.append(time.perf_counter() - t0)
            return out

        wrapped = {"encode": encode, "init_state": init_state, "step": step,
                   "decode_segment": decode_segment, "transcribe": transcribe}
        for owner, name, _ in self.saved:
            setattr(owner, name, wrapped[name])
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)
        return False


def asr_held(tag: str, got, want) -> float:
    """Max |got - want| over the largest |want|, required within ASR_TOL;
    returns the absolute error."""
    got = torch.as_tensor(got).float().cpu()
    want = torch.as_tensor(want).float().cpu()
    require(got.shape == want.shape, f"{tag}: shape {tuple(got.shape)} vs "
                                     f"{tuple(want.shape)}")
    err = (got - want).abs().max().item()
    top = want.abs().max().item()
    print(f"[asr] {tag}: max err {err:.3e}, {err / top:.3e} of max |value| "
          f"{top:.4f}")
    require(err <= ASR_TOL * top, f"{tag} beyond {ASR_TOL}")
    return err


def replay_first_window(rec: AsrRecorder, sd: dict, card: str) -> None:
    """Both windows' encoder outputs against the CPU f32 encoder on the same
    mel; then every decode_step of the card's first window against the
    CPU f32 decoder fed the card's inputs (its encoder output, and each
    row's tokens up to the step's position; the default options sample,
    so no beam reorders the rows): within ASR_TOL of the CPU's largest
    logit at that step. The CPU computes a decode's steps in one uncached
    forward over its rows' tokens (the cached step is that forward's last
    position: tests/test_torch_asr.py holds the two together on the CPU);
    a step-by-step CPU replay took 82 ms a step on the card's host, 92 s
    for the window."""
    from hirest_tpu_torch.models.whisper import load_whisper

    t0 = time.perf_counter()
    cpu_enc, cpu_dec = load_whisper(sd, device="cpu")
    with torch.inference_mode():
        for i, w in enumerate(rec.windows):
            asr_held(f"window {i + 1} encoder [1, 1500, 768] card vs CPU f32",
                     w["enc"], cpu_enc(torch.from_numpy(w["mel"][None])))
    print(f"[asr] CPU encoder on {len(rec.windows)} windows in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    decodes = []  # one a temperature: its encoder output, ids and steps
    for call in rec.windows[0]["calls"]:
        if call[0] == "init":
            _, enc, n, max_len = call
            decodes.append({"enc": enc, "steps": [],
                            "ids": np.zeros((n, max_len), np.int64)})
        else:
            _, tokens, pos, card_logits = call
            decodes[-1]["ids"][:, pos] = tokens
            decodes[-1]["steps"].append((pos, card_logits))
    ratio, err, steps = 0.0, 0.0, 0
    with torch.inference_mode():
        for d in decodes:
            length = d["steps"][-1][0] + 1
            full = cpu_dec(torch.from_numpy(d["ids"][:, :length]),
                           d["enc"].cpu())
            for pos, card_logits in d["steps"]:
                want = full[:, pos]
                e = float(np.abs(card_logits - want.numpy()).max())
                err = max(err, e)
                ratio = max(ratio, e / want.abs().max().item())
                steps += 1
    print(f"[asr] {card}: window 1's {steps} decode_steps ({len(decodes)} "
          f"decodes) against the CPU f32 decoder on the card's inputs "
          f"(one CPU forward a decode, {time.perf_counter() - t0:.1f} s): "
          f"max err {err:.3e}, {ratio:.3e} of the step's max |logit|")
    require(steps > 0 and ratio <= ASR_TOL,
            f"window 1 decode_step beyond {ASR_TOL}")


def greedy_check(sd: dict, audio: np.ndarray, tok, card: str):
    """The greedy path (`use_rules=False`) on the card: transcribe() end to
    end, then greedy_decode on the first 30 s chunk on the card and on the
    CPU (from the card's encoder output), each step's logits recorded: the
    logits within ASR_TOL while the prefixes are equal, and the tokens
    equal wherever the CPU's top-2 margin exceeds what the measured
    differences can move (2 err + 2 ulp); at a step inside that, the two
    may part, and the check ends there. Returns the card transcriber."""
    from hirest_tpu_torch.extraction.asr import (EOT, SOT,
                                                 TorchWhisperTranscriber)
    from hirest_tpu_torch.extraction.mel import N_SAMPLES, log_mel_spectrogram
    from hirest_tpu_torch.models.whisper import greedy_decode, load_whisper

    tr = TorchWhisperTranscriber(sd, tokenizer=tok, use_rules=False,
                                 device="cuda")
    t0 = time.perf_counter()
    segs = tr.transcribe(audio)
    wall = time.perf_counter() - t0
    print(f"[asr] {card}: greedy mode, {len(segs)} segments from "
          f"{ASR_SECONDS} s in {wall:.2f} s (real-time factor "
          f"{ASR_SECONDS / wall:.1f})")
    require(all(0 <= s["start"] <= s["end"] for s in segs), "greedy segments")
    mel = log_mel_spectrogram(audio[:N_SAMPLES])
    with torch.inference_mode():
        enc = tr.encoder(torch.from_numpy(mel[None]).cuda())
    _, cpu_dec = load_whisper(sd, device="cpu")
    runs = {}
    for name, dec, e in (("card", tr.decoder, enc),
                         ("cpu", cpu_dec, enc.cpu())):
        logs, step = [], dec.decode_step

        def rec_step(ids, pos, cross, cache, step=step, logs=logs):
            logits, cache = step(ids, pos, cross, cache)
            logs.append(logits[0].float().cpu())
            return logits, cache

        dec.decode_step = rec_step
        try:
            t0 = time.perf_counter()
            ids = greedy_decode(dec, e, np.array([[SOT]], np.int32), 224,
                                EOT)[0]
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            del dec.decode_step
        runs[name] = (ids, logs, ms)
    (ids, logs, ms), (cids, clogs, cms) = runs["card"], runs["cpu"]
    print(f"[asr] {card}: greedy_decode 224 steps, card {ms:.1f} ms "
          f"({ms / 224:.2f} ms a step, logits fetched each step for the "
          f"check), CPU {cms:.1f} ms")
    err, equal = 0.0, 0
    for t in range(len(clogs)):
        if not np.array_equal(ids[: t + 1], cids[: t + 1]):
            break
        err = max(err, (logs[t] - clogs[t]).abs().max().item())
        if ids[t + 1] == cids[t + 1]:
            equal += 1
            continue
        top2 = clogs[t].topk(2).values
        margin = (top2[0] - top2[1]).item()
        ulp = float(np.spacing(np.float32(top2[0].abs().item())))
        print(f"[asr] greedy tokens part at step {t}: CPU top-2 margin "
              f"{margin:.3e}, measured err {err:.3e}")
        require(margin <= 2 * err + 2 * ulp,
                f"greedy token {t + 1} differs beyond the measured error")
        break
    top = max(x.abs().max().item() for x in clogs)
    print(f"[asr] greedy: {equal} of {len(clogs)} tokens equal card vs CPU; "
          f"logits max err {err:.3e}, {err / top:.3e} of max |logit| "
          f"{top:.4f}")
    require(err <= ASR_TOL * top, f"greedy logits beyond {ASR_TOL}")
    return tr


def asr_readings(rec: AsrRecorder, card: str) -> None:
    """The rules transcription's readings, beside the card."""
    wall = sum(rec.transcribe_s)
    print(f"[asr] {card}: transcribe_audio_dir_torch, {ASR_SECONDS} s of "
          f"audio in {wall:.2f} s: real-time factor "
          f"{ASR_SECONDS / wall:.2f} (audio s per wall s)")
    enc_ms = [w["encode_ms"] for w in rec.windows]
    print(f"[asr] {card}: encoder {np.mean(enc_ms):.2f} ms per 30 s window "
          f"({', '.join(f'{x:.2f}' for x in enc_ms)})")
    for i, w in enumerate(rec.windows):
        temps = [s["temperature"] for s in w["segments"]]
        dec_ms = sum(s["ms"] for s in w["segments"])
        step_ms = sum(w["step_ms"])
        n = len(w["step_ms"])
        print(f"[asr] {card}: window {i + 1}: {n} steps, temperatures "
              f"reached {temps}, steps a temperature "
              f"{[s['steps'] for s in w['segments']]}, sampled tokens "
              f"{[s['tokens'] for s in w['segments']]}; decode "
              f"{dec_ms:.1f} ms: {dec_ms / n:.2f} ms a step, of which the "
              f"step (launches, device, logits fetch) {step_ms / n:.2f} ms "
              f"and the host rules {(dec_ms - step_ms) / n:.2f} ms")


def phase_asr(main: dict, card: str) -> None:
    """The ASR path at full width (Whisper small.en 12 + 12 x 768, vocab
    51864; MiniLM-L6 6 x 384; seeded random weights, f32) on seeded audio,
    into the joint model's use_asr branch, and the custom-video EVA step."""
    import importlib.util
    import shutil
    import tempfile
    import wave

    from hirest_tpu_torch.config import EvaTextConfig, HirestConfig
    from hirest_tpu_torch.data.srt import load_srt
    from hirest_tpu_torch.extraction import asr
    from hirest_tpu_torch.extraction.features import finish_video_features
    from hirest_tpu_torch.extraction.whisper_decode import (DecodeOptions,
                                                            decode_segment)
    from hirest_tpu_torch.infer.pipeline import run_end_to_end
    from hirest_tpu_torch.models.eva_clip import eva_text_encoder
    from hirest_tpu_torch.models.minilm import make_minilm_embedder
    from hirest_tpu_torch.tokenizers.gpt2_bpe import WhisperEnTokenizer
    from hirest_tpu_torch.train.trainer import Trainer
    from hirest_tpu_torch.utils.init import (random_eva_text_state_dict,
                                             random_whisper_state_dict)

    start = time.perf_counter()
    missing = [name for name, found in (
        ("cv2 (OpenCV)", importlib.util.find_spec("cv2")),
        ("PIL (Pillow)", importlib.util.find_spec("PIL")),
        ("ffmpeg", shutil.which("ffmpeg")),
        ("whisper (openai-whisper)", importlib.util.find_spec("whisper")))
        if not found]
    print(f"[asr] host decoders missing on this machine: "
          f"{', '.join(missing) or 'none'} (the phase decodes no mp4: its "
          f"audio and frames are made from the seed, and no device step "
          f"is skipped)")
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: Path(tmp) / k for k in (
            "audio", "tok", "pretrained", "ASR", "ASR_feats_all-MiniLM-L6-v2",
            "feats", "splits", "out")}
        for d in dirs.values():
            d.mkdir()
        samples = speechlike_audio(ASR_SECONDS, 13)
        with wave.open(str(dirs["audio"] / f"{ASR_VIDEO}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(samples.tobytes())
        audio = asr.read_wav_mono16k(str(dirs["audio"] / f"{ASR_VIDEO}.wav"))
        vocab, merges = write_byte_vocab(dirs["tok"])
        tok = WhisperEnTokenizer(vocab, merges)
        t0 = time.perf_counter()
        sd = random_whisper_state_dict(seed=0)
        t1 = time.perf_counter()
        minilm_sd = write_minilm_pretrained(dirs["pretrained"])
        print(f"[asr] seeded weights: Whisper small.en "
              f"{sum(v.size for v in sd.values()) / 1e6:.1f} M parameters "
              f"in {t1 - t0:.1f} s, MiniLM-L6 "
              f"{sum(v.size for v in minilm_sd.values()) / 1e6:.1f} M "
              f"(drawn and saved) in {time.perf_counter() - t1:.1f} s")

        zero_counts()  # read after the trainer: the ASR steps launch none
        rec = AsrRecorder()
        t0 = time.perf_counter()
        with rec:
            n = asr.transcribe_audio_dir_torch(
                str(dirs["audio"]), str(dirs["ASR"]), sd, vocab_path=vocab,
                merges_path=merges, device="cuda")
        print(f"[asr] transcribe_audio_dir_torch (default DecodeOptions, "
              f"the transcriber's build included) in "
              f"{time.perf_counter() - t0:.1f} s")
        subs = load_srt(str(dirs["ASR"] / f"{ASR_VIDEO}.srt"))
        require(n == 1 and subs and all(
            0 <= s.start_seconds <= s.end_seconds <= ASR_SECONDS + 30
            for s in subs), f"SRT: {n} files, {len(subs)} segments")
        print(f"[asr] SRT: {len(subs)} segments, "
              f"{subs[0].start_seconds}-{subs[-1].end_seconds} s; first "
              f"text {subs[0].text[:40]!r}")
        asr_readings(rec, card)
        replay_first_window(rec, sd, card)
        greedy = greedy_check(sd, audio, tok, card)

        t0 = time.perf_counter()
        n = asr.embed_srt_dir(str(dirs["ASR"]),
                              str(dirs["ASR_feats_all-MiniLM-L6-v2"]),
                              pretrained_dir=str(dirs["pretrained"]),
                              device="cuda")
        emb = np.load(dirs["ASR_feats_all-MiniLM-L6-v2"] / f"{ASR_VIDEO}.npy")
        print(f"[asr] embed_srt_dir (MiniLM-L6 on the card, its build "
              f"included) in {time.perf_counter() - t0:.2f} s: {emb.shape}")
        require(n == 1 and emb.shape == (len(subs), 384)
                and emb.dtype == np.float32 and np.isfinite(emb).all()
                and np.allclose(np.linalg.norm(emb, axis=-1), 1, atol=1e-5),
                f"ASR features {emb.shape}")
        texts = [s.text for s in subs]
        vocab_txt = str(dirs["pretrained"] / "vocab.txt")
        cpu_embed = make_minilm_embedder(minilm_sd, vocab_txt, device="cpu")
        asr_held(f"MiniLM embeddings of the {len(texts)} segments, card vs "
                 f"CPU f32", emb, cpu_embed(texts))
        card_embed = make_minilm_embedder(minilm_sd, vocab_txt, device="cuda")
        batch = (texts * MINILM_BATCH)[:MINILM_BATCH]
        card_embed(batch)
        t0 = time.perf_counter()
        for _ in range(MINILM_ROUNDS):
            card_embed(batch)
        wall = time.perf_counter() - t0
        print(f"[asr] {card}: MiniLM {MINILM_BATCH * MINILM_ROUNDS / wall:.1f}"
              f" sentences/s ({MINILM_ROUNDS} calls of {MINILM_BATCH} "
              f"sentences at 128 tokens, host tokenization and the fetch "
              f"included)")

        # the use_asr branch: these features beside phase 3's int8 ones
        name, duration = f"{ASR_VIDEO}.mp4", VIDEOS[ASR_VIDEO][1]
        np.save(dirs["feats"] / f"{name}.npy", main["features"][ASR_VIDEO])
        (dirs["splits"] / "all_data_test.json").write_text(json.dumps({
            prompt: {name: {
                "relevant": True, "clip": True, "v_duration": duration,
                "bounds": [0, int(duration)],
                "steps": [{"index": i, "heading": "",
                           "absolute_bounds": [i, i + 1]}
                          for i in range(5)]}} for prompt in ASR_PROMPTS}))
        cfg = HirestConfig(
            data_dir=str(dirs["splits"]),
            video_feature_dir=str(dirs["feats"]),
            asr_dir=str(dirs["ASR"]),
            asr_feature_dir=str(dirs["ASR_feats_all-MiniLM-L6-v2"]),
            pretrained_dir=str(dirs["pretrained"]),
            ckpt_dir=str(dirs["out"]), task_moment_retrieval=True,
            task_moment_segmentation=True, task_step_captioning=True,
            end_to_end=True, eval_batch_size=1, device="cuda")
        t0 = time.perf_counter()
        text_fn = eva_text_encoder(random_eva_text_state_dict(
            EvaTextConfig(), seed=0), EvaTextConfig(), torch.float32,
            torch.device("cuda"))
        trainer = Trainer(cfg, text_encoder_fn=text_fn, verbose=False)
        require(trainer.model_cfg.use_asr and trainer.model_cfg.asr_dim == 384
                and trainer.store.has_asr, "the trainer has no ASR branch")
        res = run_end_to_end(trainer)
        torch.cuda.synchronize()
        final = json.loads((dirs["out"]
                            / "final_end_to_end_results.json").read_text())
        require(final == json.loads(json.dumps(res))
                and sorted(final) == sorted(ASR_PROMPTS),
                "final_end_to_end_results.json")
        for prompt in ASR_PROMPTS:
            entry = final[prompt][name]
            require(len(entry["bounds"]) == 2 and all(
                0 <= b <= duration for b in entry["bounds"]) and all(
                isinstance(st["heading"], str)
                and len(st["absolute_bounds"]) == 2 for st in entry["steps"]),
                f"end-to-end entry {entry}")
        print(f"[asr] Trainer (JointModelConfig(asr_dim=384), the ASR "
              f"branch live) and run_end_to_end on {name} in "
              f"{time.perf_counter() - t0:.1f} s: moments "
              f"{[final[p][name]['bounds'] for p in ASR_PROMPTS]}, steps "
              f"{[len(final[p][name]['steps']) for p in ASR_PROMPTS]}")
        counts = read_counts()
        print(f"[asr] kernel launches during transcription, the checks, "
              f"MiniLM and the end-to-end run: {counts}")
        require(counts == expect(), "the ASR path launched a kernel")

        mel = rec.windows[0]["mel"]
        print(f"[asr] {card}: encoder, warm, "
              f"{cuda_ms(lambda: greedy.adapter.encode(mel), 5):.2f} ms per "
              f"30 s window (CUDA events, 5 calls)")
        window = greedy.adapter.encode(mel)
        profile_call(f"one decode_segment (window 1, t=0.15, best_of 5, "
                     f"{PROFILE_STEPS} steps)", lambda: decode_segment(
                         greedy.adapter, window, tok,
                         DecodeOptions(sample_len=PROFILE_STEPS), 0.15,
                         rng=np.random.default_rng(0)), card, "asr",
                     tag="asr")
        del greedy, trainer

    # the custom-video EVA step, as run_custom_video chains it:
    # make_eva_encoder(pretrained_dir, uint8_frontend=True) (phase 3 built
    # it with these arguments), extract_video_features' batches of 64
    # zero-padded, its per-video finish
    enc = main["encoders"]["bf16"][True]
    frames = np.random.default_rng(17).integers(
        0, 256, (int(ASR_SECONDS), 224, 224, 3), dtype=np.uint8)
    zero_counts()
    t0 = time.perf_counter()
    embs, forwards = [], 0
    for i in range(0, len(frames), CUSTOM_BATCH):
        chunk = frames[i: i + CUSTOM_BATCH]
        batch = np.zeros((CUSTOM_BATCH, 224, 224, 3), np.uint8)
        batch[: len(chunk)] = chunk
        embs.append(enc(batch)[: len(chunk)])
        forwards += 1
    feats = finish_video_features(embs, duration=ASR_SECONDS)
    counts = read_counts()
    print(f"[asr] custom-video EVA step: {len(frames)} uint8 frames, "
          f"{forwards} forward(s) of {CUSTOM_BATCH} in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms; launches {counts}")
    require(counts == expect(K1=40 * forwards, E1=80 * forwards,
                             E2=80 * forwards),
            f"custom-video EVA launches {counts}")
    require(feats.shape == (round(ASR_SECONDS), 1024)
            and np.isfinite(feats).all() and np.allclose(
                np.linalg.norm(feats, axis=-1), 1, atol=1e-3),
            f"custom-video features {feats.shape}")
    print(f"[asr] {card}: phase done in {time.perf_counter() - start:.1f} s")


# the training phase: the synthetic split, the checks' bars
TRAIN_PROMPTS = ("make oatmeal pancake mix", "fold a fitted sheet",
                 "replace a bike inner tube", "brew pour over coffee")
TRAIN_VIDEOS = {"train": 8, "val": 2, "test": 2}  # videos a prompt: B=32
TRAIN_TASKS = ("moment_retrieval", "moment_segmentation", "step_captioning")
TRAIN_EPOCHS = 2
LOSS_TOL = 1e-5  # card vs CPU: the loss, relative; each gradient
OPT_TOL = 1e-6  # the optimizer on the CPU's gradients; resume
FALL_STEPS = 30  # steps on one fixed batch a task
RATE_STEPS = 60  # timed steps a task, a window of a few seconds
RATE_WINDOWS = 3  # its parts, each timed too: the spread within a run
VOCAB_SIZE = 30522


def write_training_split(root: Path) -> dict:
    """A synthetic HiREST split in the reference JSON schema (prompt ->
    video -> relevant, clip, v_duration, bounds, steps with index, heading
    and absolute_bounds) for train, val and test, seeded random
    [round(v_duration), 1024] features, and a made-up 30522-entry WordPiece
    vocabulary ([PAD], [UNK], [CLS], [SEP], [MASK], then words) whose words
    make the step headings. Returns the run's directories."""
    dirs = {k: root / k for k in ("splits", "feats", "pretrained", "ckpt")}
    for d in dirs.values():
        d.mkdir(parents=True)
    words = [f"word{i}" for i in range(VOCAB_SIZE - 5)]
    (dirs["pretrained"] / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words) + "\n")
    rng = np.random.default_rng(11)
    for split, n_videos in TRAIN_VIDEOS.items():
        anns = {}
        for p, prompt in enumerate(TRAIN_PROMPTS):
            videos = {}
            for v in range(n_videos):
                name = f"{split}_{p}_{v}.mp4"
                duration = float(rng.integers(30, 62)) + 0.4
                np.save(dirs["feats"] / f"{name}.npy", rng.normal(size=(
                    round(duration), 1024)).astype(np.float32))
                start = int(rng.integers(1, 6))
                end = int(duration) - int(rng.integers(1, 6))
                cuts = np.sort(rng.choice(np.arange(start + 2, end - 1),
                                          size=int(rng.integers(2, 5)),
                                          replace=False)).tolist()
                edges = [start, *cuts, end]
                videos[name] = {
                    "relevant": True, "clip": True, "v_duration": duration,
                    "bounds": [start, end],
                    "steps": [{"index": i, "heading": " ".join(
                        words[j] for j in rng.integers(0, len(words),
                                                       int(rng.integers(2,
                                                                        9)))),
                        "absolute_bounds": [edges[i], edges[i + 1]]}
                        for i in range(len(edges) - 1)]}
            anns[prompt] = videos
        (dirs["splits"] / f"all_data_{split}.json").write_text(
            json.dumps(anns))
    return dirs


def training_config(dirs: dict, device: str, **overrides):
    """The run's HirestConfig: JointModelConfig()'s widths (768 hidden,
    2 + 2 layers, vocabulary 30522, 48 words), train_batch_size 32, all
    three tasks; the text tower and the joint model get seeded random
    weights (no checkpoint in pretrained/)."""
    from hirest_tpu_torch.config import HirestConfig

    kw = dict(data_dir=str(dirs["splits"]),
              video_feature_dir=str(dirs["feats"]),
              pretrained_dir=str(dirs["pretrained"]),
              ckpt_dir=str(dirs["ckpt"]), task_moment_retrieval=True,
              task_moment_segmentation=True, task_step_captioning=True,
              train_batch_size=32, eval_batch_size=32, epochs=TRAIN_EPOCHS,
              num_workers=0, device=device)
    kw.update(overrides)
    return HirestConfig(**kw)


def training_trainer(dirs: dict, device: str, text_fn, **overrides):
    from hirest_tpu_torch.tokenizers import WordPieceTokenizer
    from hirest_tpu_torch.train.trainer import Trainer

    return Trainer(training_config(dirs, device, **overrides),
                   text_encoder_fn=text_fn, verbose=False,
                   wordpiece_tokenizer=WordPieceTokenizer(
                       str(dirs["pretrained"] / "vocab.txt")))


def zero_in_exact_arithmetic(task: str, name: str, layers: int) -> bool:
    """Parameters whose gradient is zero in exact arithmetic (every key
    bias: a softmax ignores a constant added to all of a query's scores;
    for segmentation, what adds one vector to every frame ahead of the
    frame softmax): both devices give f32 rounding noise there."""
    if name.endswith("key.bias"):
        return True
    return task == "moment_segmentation" and name in (
        "segment_predictor.0.bias",
        f"clip4cap_model.visual.encoder.layer.{layers - 1}.output."
        "LayerNorm.bias")


def card_vs_cpu_step(dirs: dict, cpu, text_fn, batches: dict) -> None:
    """(a) One step a task in f32, dropout off: the card's loss and
    gradients against the CPU trainer's on the CPU's prepared batch; then
    the optimizer on the card, fed the CPU's gradients, against the CPU's
    update (no warmup, so the update moves the weights)."""
    card = training_trainer(dirs, "cuda", text_fn, warmup_steps=0)
    layers = card.model_cfg.visual.num_hidden_layers
    for t in (cpu, card):
        t.dropout = False
        t.setup_optimizer(len(batches))
    for name, p in cpu.model.state_dict().items():
        require(torch.equal(card.model.state_dict()[name].cpu(), p),
                f"card and CPU trainers start from other weights ({name})")
    for task, batch in batches.items():
        arrs = cpu._prepare(batch, task)
        t0 = time.perf_counter()
        want_loss, want = cpu.loss_and_grads(task, arrs)
        cpu_s = time.perf_counter() - t0
        loss, grads = card.loss_and_grads(
            task, {k: v.to("cuda") for k, v in arrs.items()})
        rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
        top = max(g.abs().max().item() for g in want.values())
        worst, worst_name, noise = 0.0, "", 0.0
        for name, g in want.items():
            got = grads[name].cpu()
            if zero_in_exact_arithmetic(task, name, layers):
                noise = max(noise, got.abs().max().item(),
                            g.abs().max().item())
                continue
            scale = g.abs().max().item()
            err = (got - g).abs().max().item()
            require(err <= LOSS_TOL * scale, f"{task} gradient of {name}: "
                    f"{err:.3e} of max {scale:.3e}")
            if scale and err / scale > worst:
                worst, worst_name = err / scale, name
        print(f"[training] (a) {task}: loss card {float(loss):.6f}, CPU "
              f"{float(want_loss):.6f} ({rel:.2e} relative, <= {LOSS_TOL}); "
              f"gradients within {worst:.2e} of each tensor's max (<= "
              f"{LOSS_TOL}), the farthest {worst_name}; exactly-zero ones "
              f"at {noise:.2e} (<= 1e-6 of the largest, {top:.3e}); CPU "
              f"step {cpu_s:.1f} s")
        require(rel <= LOSS_TOL, f"{task} loss off the CPU's")
        require(noise <= 1e-6 * top, f"{task}: a gradient that is zero in "
                                     f"exact arithmetic is not noise")
        before = {k: v.clone() for k, v in cpu.model.state_dict().items()}
        cpu.apply_gradients(want)
        card.apply_gradients({k: v.to("cuda") for k, v in want.items()})
        worst, moved = 0.0, 0.0
        for name, p in cpu.model.state_dict().items():
            got = card.model.state_dict()[name].cpu()
            scale = p.abs().max().item()
            err = (got - p).abs().max().item()
            require(err <= OPT_TOL * scale, f"{task} update of {name}: "
                    f"{err:.3e} of max {scale:.3e}")
            worst = max(worst, err / scale if scale else 0.0)
            moved = max(moved, (p - before[name]).abs().max().item())
        print(f"[training] (a) {task}: the card's update from the CPU's "
              f"gradients within {worst:.2e} of each tensor's max (<= "
              f"{OPT_TOL}); the step moved a parameter up to {moved:.3e}")
        require(moved > 0, f"{task}: the update moved nothing")
        # the next task starts from the same weights on both
        card.model.load_state_dict(cpu.model.state_dict())


def check_test_predictions(ckpt: Path, anns: dict) -> None:
    """(b) The per-task test JSONs: well formed, bounds inside the video,
    segmentation steps sorted, captions strings."""
    durations = {v: round(a["v_duration"]) for p in anns.values()
                 for v, a in p.items()}
    mr = json.loads((ckpt / "test_moment_retrieval_BEST.json").read_text())
    n = 0
    for prompt, videos in mr.items():
        for vid, r in videos.items():
            require(all(0 <= b <= durations[vid] for b in r["bounds"]),
                    f"moment retrieval {vid}: {r['bounds']}")
            n += 1
    ms = json.loads((ckpt / "test_moment_segmentation_BEST.json").read_text())
    for vid, r in ms.items():
        pred = r["pred_bounds"]
        require(pred == sorted(pred) and all(
            0 <= a <= b <= durations[vid] for a, b in r["bounds"]),
            f"moment segmentation {vid}: {r['bounds']}")
    sc = json.loads((ckpt / "test_step_captioning_BEST.json").read_text())
    caps = [c["sentence"] for r in sc.values() for c in r["captions"]]
    require(bool(caps) and all(isinstance(c, str) for c in caps),
            "step captions")
    print(f"[training] (b) test predictions: {n} moments, {len(ms)} "
          f"segmentations, {len(caps)} captions, e.g. {caps[0][:60]!r}")


def tree_clone(x):
    if isinstance(x, dict):
        return {k: tree_clone(v) for k, v in x.items()}
    return x.clone() if isinstance(x, torch.Tensor) else x


def tree_equal(x, y) -> bool:
    """Same keys, and every tensor equal bit for bit (dtype included)."""
    if isinstance(x, dict):
        return (isinstance(y, dict) and set(x) == set(y)
                and all(tree_equal(x[k], y[k]) for k in x))
    if isinstance(x, torch.Tensor):
        return (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                and torch.equal(x, y))
    return x == y


def resume_check(dirs: dict, text_fn, batches: dict) -> None:
    """(c) A trainer a few steps in (dropout live) saves LAST; a fresh one
    loads it: step, epoch, model and optimizer state (moments, count) bit
    for bit; its next step with dropout off equals the unbroken run's
    within 1e-6 of each tensor's largest magnitude."""
    from hirest_tpu_torch.data.multitask import MultitaskSchedule

    a = training_trainer(dirs, "cuda", text_fn)
    # the schedule's length, as load() sets the optimizer up
    a.setup_optimizer(len(MultitaskSchedule(a.loaders["train"])))
    prepared = {t: a._prepare(b, t) for t, b in batches.items()}
    for task, arrs in prepared.items():
        a.train_step(task, arrs)
    a.epoch = 1
    a.save("LAST")
    saved = tree_clone(a.opt_state)
    b = training_trainer(dirs, "cuda", text_fn)
    b.load(str(dirs["ckpt"] / "LAST"))
    require((b.step, b.start_epoch) == (len(batches), 1),
            f"resume: step {b.step}, epoch {b.start_epoch}")
    require(tree_equal(b.opt_state, saved), "resume: optimizer state not "
                                            "restored bit for bit")
    require(tree_equal(b.model.state_dict(), a.model.state_dict()),
            "resume: model not restored bit for bit")
    task = TRAIN_TASKS[0]
    for t in (a, b):
        t.dropout = False
        t.train_step(task, prepared[task])
    worst = max((b.model.state_dict()[k] - v).abs().max().item()
                / max(v.abs().max().item(), 1e-30)
                for k, v in a.model.state_dict().items())
    print(f"[training] (c) resumed at step {b.step - 1}, epoch 1: state "
          f"bit for bit; next step within {worst:.2e} of the unbroken "
          f"run's (<= {OPT_TOL})")
    require(worst <= OPT_TOL, "resumed step off the unbroken run's")


def loss_falls(dirs: dict, text_fn, batches: dict) -> dict:
    """(d) Dropout off, FALL_STEPS steps on one fixed batch a task: each
    task's loss lower after than before. Returns the prepared batches."""
    t = training_trainer(dirs, "cuda", text_fn, lr=1e-4, warmup_steps=0)
    t.dropout = False
    t.setup_optimizer(FALL_STEPS * len(batches))
    prepared = {task: t._prepare(b, task) for task, b in batches.items()}
    first = {task: t._eval_loss(task, arrs) for task, arrs in prepared.items()}
    for _ in range(FALL_STEPS):
        for task, arrs in prepared.items():
            t.train_step(task, arrs)
    for task, arrs in prepared.items():
        last = t._eval_loss(task, arrs)
        print(f"[training] (d) {task}: loss {first[task]:.4f} -> "
              f"{last:.4f} after {FALL_STEPS} steps on one batch")
        require(last < first[task], f"{task} loss did not fall")
    return prepared


def training_readings(dirs: dict, text_fn, batches: dict, card: str) -> None:
    """(f) Steps/s a task (host clock around RATE_STEPS steps at B=32,
    after one, in RATE_WINDOWS windows each ending in a synchronize), one
    step's device time and idle share from
    the profiler, and the peak device memory of those steps above what
    was resident before the trainer was built (earlier phases' tensors,
    the text tower)."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    t = training_trainer(dirs, "cuda", text_fn)
    t.setup_optimizer(RATE_STEPS * len(batches))
    for task, batch in batches.items():
        arrs = t._prepare(batch, task)
        rows = tuple(arrs["vis_feats"].shape)
        require(rows[0] == 32, f"{task} timed at B={rows[0]}, not 32")
        t.train_step(task, arrs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks = [time.perf_counter()]
        for _ in range(RATE_WINDOWS):
            for _ in range(RATE_STEPS // RATE_WINDOWS):
                t.train_step(task, arrs)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        rate = RATE_STEPS / (marks[-1] - marks[0])
        windows = [RATE_STEPS // RATE_WINDOWS / (b - a)
                   for a, b in zip(marks, marks[1:])]
        peak = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
        print(f"[training] (f) {card}: {task} B={rows[0]}, vis_feats "
              f"{rows}: {rate:.2f} steps/s over {RATE_STEPS} steps in "
              f"{marks[-1] - marks[0]:.2f} s (windows of "
              f"{RATE_STEPS // RATE_WINDOWS}: "
              f"{', '.join(f'{w:.2f}' for w in windows)}), peak memory "
              f"{peak:.2f} GiB "
              f"above the {resident / 2 ** 30:.2f} GiB resident before")
        profile_call(f"one {task} training step", lambda: t.train_step(
            task, arrs), card, "training", tag="training")


def phase_training(card: str) -> None:
    """The training path at JointModelConfig()'s full width on a synthetic
    split: (a) the card against the CPU, (b) `python -m
    hirest_tpu_torch.run --train`'s function for TRAIN_EPOCHS epochs with
    dropout live, (c) resume, (d) the loss falls, (e) no kernel of the
    port launched throughout, (f) readings."""
    import tempfile

    from hirest_tpu_torch.config import EvaTextConfig
    from hirest_tpu_torch.models.eva_clip import eva_text_encoder
    from hirest_tpu_torch.run import main as run_main
    from hirest_tpu_torch.utils.init import random_eva_text_state_dict

    start = time.perf_counter()
    zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        dirs = write_training_split(Path(tmp))
        sd = random_eva_text_state_dict(EvaTextConfig(), seed=0)
        text_fns = {dev: eva_text_encoder(sd, EvaTextConfig(), torch.float32,
                                          torch.device(dev))
                    for dev in ("cpu", "cuda")}
        cpu = training_trainer(dirs, "cpu", text_fns["cpu"], warmup_steps=0)
        batches = {task: next(iter(cpu.loaders["train"][task]))
                   for task in TRAIN_TASKS}
        sizes = {task: len(b) for task, b in cpu.loaders["train"].items()}
        print(f"[training] split written, {sizes} train batches of 32 a "
              f"task; CPU trainer built in "
              f"{time.perf_counter() - start:.1f} s")
        card_vs_cpu_step(dirs, cpu, text_fns["cuda"], batches)
        del cpu

        metrics = Path(tmp) / "metrics.jsonl"
        t0 = time.perf_counter()
        run_main(["--train", "--data_dir", str(dirs["splits"]),
                  "--video_feature_dir", str(dirs["feats"]),
                  "--pretrained_dir", str(dirs["pretrained"]),
                  "--ckpt_dir", str(dirs["ckpt"]), "--task_moment_retrieval",
                  "--task_moment_segmentation", "--task_step_captioning",
                  "--epochs", str(TRAIN_EPOCHS), "--train_batch_size", "32",
                  "--metrics_log", str(metrics), "--device", "cuda"])
        torch.cuda.synchronize()
        records = [json.loads(line) for line in
                   metrics.read_text().splitlines()]
        losses = [r[k] for r in records for k in ("train_loss", "val_loss")
                  if k in r]
        print(f"[training] (b) `run --train`, {TRAIN_EPOCHS} epochs with "
              f"dropout live, in {time.perf_counter() - t0:.1f} s: epoch "
              f"losses {losses}")
        require(len(losses) == 2 * TRAIN_EPOCHS
                and all(np.isfinite(losses)), "training losses")
        for name in ("BEST.pt", "LAST.pt"):
            require((dirs["ckpt"] / name).exists(), f"{name} not written")
        check_test_predictions(dirs["ckpt"], json.loads(
            (dirs["splits"] / "all_data_test.json").read_text()))

        resume_check(dirs, text_fns["cuda"], batches)
        loss_falls(dirs, text_fns["cuda"], batches)
        counts = read_counts()
        print(f"[training] (e) kernel launches during (a)-(d): {counts}")
        require(counts == expect(), "the training path launched a kernel")
        training_readings(dirs, text_fns["cuda"], batches, card)
    print(f"[training] phase done in {time.perf_counter() - start:.1f} s")


PARALLEL_SPECS = ("data:2", "model:2")
PARALLEL_STEPS = 3  # training steps a task, dropout live
PARALLEL_LOSS_TOL = 1e-6  # losses and gradient norms against one process
PARALLEL_PARAM_TOL = 1e-5  # parameters, of each tensor's largest magnitude
PARALLEL_TIMEOUT = 300  # seconds the ranks of one check may take
PARALLEL_TIMED = 5  # warm moment retrieval steps timed, twice


def parallel_text_fn(ids):
    """A deterministic text feature of the token ids (the CPU tests'): the
    ranks need no text tower of their own."""
    w = np.random.default_rng(7).normal(size=(77, 1024)).astype(np.float32)
    return (np.asarray(ids, np.float32) / 49407.0) @ w


def parallel_run(root: Path, device: str, spec) -> dict:
    """One rank's run (or, with spec None, the one process's) on the
    training phase's split at JointModelConfig()'s width, f32: PARALLEL_STEPS
    steps a task with dropout live (each step's loss and gradient norm),
    the full parameters after them; then PARALLEL_TIMED more steps on one
    moment retrieval batch for steps/s (the host clock, a synchronize at
    the end), and as many again for the all-reduce time a step (the host
    clock around each all_reduce, the device synchronized on both sides);
    and the test split's predictions with each caption batch's beam
    traced."""
    import itertools

    import torch.distributed as dist

    from hirest_tpu_torch.data.multitask import MultitaskSchedule
    from hirest_tpu_torch.infer import beam

    dirs = {k: root / k for k in ("splits", "feats", "pretrained", "ckpt")}
    t = training_trainer(dirs, device, parallel_text_fn, mesh_shape=spec,
                         lr=1e-4, warmup_steps=0, clip_grad_norm=1.0)
    t.setup_optimizer(len(MultitaskSchedule(t.loaders["train"],
                                            shuffle=True)))

    def step(task, batch):
        arrs = t._prepare(t._shard(batch), task)
        loss, grads = t.loss_and_grads(task, arrs)
        norm = t.grad_norm(grads)
        t.apply_gradients(grads)
        t.step += 1
        return task, float(loss), float(norm)

    steps = [step(task, batch) for task in TRAIN_TASKS
             for batch in itertools.islice(t.loaders["train"][task],
                                           PARALLEL_STEPS)]
    params = {k: v.cpu() for k, v in t._resharded(t.model.state_dict(),
                                                  True).items()}
    batch = next(iter(t.loaders["train"]["moment_retrieval"]))
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(PARALLEL_TIMED):
        step("moment_retrieval", batch)
    torch.cuda.synchronize()
    rate = PARALLEL_TIMED / (time.perf_counter() - start)

    all_reduce, spent = dist.all_reduce, [0.0, 0]

    def timed(tensor, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = all_reduce(tensor, *args, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return out

    dist.all_reduce = timed
    try:
        for _ in range(PARALLEL_TIMED):
            step("moment_retrieval", batch)
    finally:
        dist.all_reduce = all_reduce

    trace, captions = [], []
    probe, select = traced_select(trace)
    predict = t._predict_step_captioning

    def recording(arrs):
        first = len(trace)
        out = predict(arrs)
        captions.append({"rows": t._rows, "captions": out,
                         "trace": (first, len(trace))})
        return out

    t._predict_step_captioning, beam._select = recording, probe
    try:
        preds = {task: t.evaluate(t.loaders["test"][task], task)
                 for task in TRAIN_TASKS}
    finally:
        del t._predict_step_captioning
        beam._select = select
    for c in captions:
        c["trace"] = trace[c["trace"][0]:c["trace"][1]]
    return {"steps": steps, "params": params, "rate": rate,
            "all_reduce_ms": 1e3 * spent[0] / PARALLEL_TIMED,
            "all_reduce_calls": spent[1] / PARALLEL_TIMED,
            "predictions": preds, "captions": captions}


def parallel_worker(args: dict) -> None:
    """A rank of phase_parallel's check: joins the group and runs each
    spec in turn, its results to args["out"]."""
    from hirest_tpu_torch.parallel.mesh import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = init_distributed(args["backend"], device=args["device"],
                              init_method=args["init"], rank=args["rank"],
                              world_size=args["world"])
    results = {spec: parallel_run(Path(args["root"]), str(device), spec)
               for spec in args["specs"]}
    torch.save(results, args["out"])
    torch.distributed.destroy_process_group()


def spawn_ranks(root: Path, tag: str, backend: str, devices: list,
                specs: tuple) -> list:
    """Run parallel_worker on one process a device in `devices` (ranks in
    order), joined by a file init_method -> each rank's results. Kills
    every rank and fails when one fails or outlasts PARALLEL_TIMEOUT."""
    procs = []
    for rank, device in enumerate(devices):
        args = dict(root=str(root), backend=backend, device=device,
                    init=f"file://{root / f'{tag}.init'}", rank=rank,
                    world=len(devices), specs=list(specs),
                    out=str(root / f"{tag}.{rank}.pt"))
        log = open(root / f"{tag}.{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"),
             "--parallel-worker", json.dumps(args)], cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT), log))
    deadline = time.perf_counter() + PARALLEL_TIMEOUT
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, (proc, _) in enumerate(procs):
        text = (root / f"{tag}.{rank}.log").read_text()
        require(proc.returncode == 0,
                f"parallel {tag} rank {rank} exited {proc.returncode}:\n"
                f"{text[-3000:]}")
    return [torch.load(root / f"{tag}.{rank}.pt", weights_only=False)
            for rank in range(len(devices))]


def parallel_compare(tag: str, spec: str, ranks: list, one: dict) -> None:
    """Each rank against the one process: every step's loss and gradient
    norm within PARALLEL_LOSS_TOL relative, the parameters within
    PARALLEL_PARAM_TOL of each tensor's largest magnitude (bar those zero
    in exact arithmetic), the moment retrieval and segmentation JSONs
    equal, each rank's captions the one process's rows' or a tie
    (same_selections on the two traces, err 1e-6 of the scores)."""
    from hirest_tpu_torch.config import JointModelConfig

    layers = JointModelConfig().visual.num_hidden_layers
    for rank, res in enumerate(ranks):
        got = res[spec]
        worst_loss = worst_norm = worst_param = 0.0
        require([s[0] for s in got["steps"]] == [s[0] for s in one["steps"]],
                 f"{tag} {spec}: another schedule")
        for (_, loss, norm), (_, ref_loss, ref_norm) in zip(got["steps"],
                                                            one["steps"]):
            worst_loss = max(worst_loss, abs(loss - ref_loss) / ref_loss)
            worst_norm = max(worst_norm, abs(norm - ref_norm) / ref_norm)
        for k, want in one["params"].items():
            if any(zero_in_exact_arithmetic(task, k, layers)
                   for task in TRAIN_TASKS):
                continue
            err = (got["params"][k] - want).abs().max().item()
            worst_param = max(worst_param, err / want.abs().max().item())
        print(f"[parallel] {tag} {spec} rank {rank}: {len(got['steps'])} "
              f"steps with dropout live; worst relative loss {worst_loss:.3e}"
              f", grad norm {worst_norm:.3e} (<= {PARALLEL_LOSS_TOL}); "
              f"worst parameter error {worst_param:.3e} of its tensor's "
              f"largest (<= {PARALLEL_PARAM_TOL})")
        require(worst_loss <= PARALLEL_LOSS_TOL
                and worst_norm <= PARALLEL_LOSS_TOL
                and worst_param <= PARALLEL_PARAM_TOL,
                f"{tag} {spec} rank {rank} off the one-process run")
        for task in ("moment_retrieval", "moment_segmentation"):
            require(json.dumps(got["predictions"][task])
                    == json.dumps(one["predictions"][task]),
                    f"{tag} {spec} rank {rank}: {task} predictions differ")
        require(len(got["captions"]) == len(one["captions"]),
                f"{tag} {spec}: caption batch counts differ")
        for i, (g, w) in enumerate(zip(got["captions"], one["captions"])):
            lo, n_real = g["rows"] or (0, len(w["captions"]))
            n = max(0, min(lo + len(g["captions"]), n_real) - lo)

            def rows(trace, a, b):
                return [{**{k: v[a:b] for k, v in s.items() if k != "top"},
                         "top": s["top"]} for s in trace]

            top = max(s["top"] for s in w["trace"])
            same_selections(
                f"{tag} {spec} rank {rank} batch {i}",
                (g["captions"][:n], rows(g["trace"], 0, n)),
                (w["captions"][lo:lo + n], rows(w["trace"], lo, lo + n)),
                1e-6 * top, "parallel")


def phase_parallel(card: str) -> None:
    """Data and tensor parallelism (parallel/, Trainer under mesh_shape) at
    JointModelConfig()'s width, f32, on the training phase's synthetic
    split: two ranks on the one card over gloo (CUDA tensors), as data:2
    and as model:2, against the one-process card run; `python -m
    torch.distributed.run --standalone --nproc_per_node=1 -m
    hirest_tpu_torch.run --train --mesh_shape data:1` over NCCL; and, where
    the machine has them, the same check over NCCL, one card a rank: on
    two cards as data:2 and model:2, on four as data:2,model:2. Readings:
    steps/s and all-reduce ms a step."""
    import tempfile

    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        dirs = write_training_split(root)
        zero_counts()
        one = parallel_run(root, "cuda", None)
        require(read_counts() == expect(),
                "the training path launched a kernel")
        print(f"[parallel] {card}: one process on the card: "
              f"{len(one['steps'])} checked steps; {one['rate']:.2f} steps/s "
              f"over {PARALLEL_TIMED} warm moment retrieval steps (B=32)")
        ranks = spawn_ranks(root, "gloo", "gloo", ["cuda:0", "cuda:0"],
                            PARALLEL_SPECS)
        for spec in PARALLEL_SPECS:
            parallel_compare("gloo, one card", spec, ranks, one)
            r = ranks[0][spec]
            print(f"[parallel] {card}: {spec} over gloo, two ranks on one "
                  f"card: {r['rate']:.2f} steps/s (warm moment retrieval), "
                  f"all-reduce "
                  f"{r['all_reduce_ms']:.2f} ms a step in "
                  f"{r['all_reduce_calls']:.0f} calls (gloo stages CUDA "
                  f"tensors through the host: not an NCCL time)")

        t0 = time.perf_counter()
        ckpt = root / "torchrun"
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node=1", "-m", "hirest_tpu_torch.run", "--train",
             "--mesh_shape", "data:1", "--data_dir", str(dirs["splits"]),
             "--video_feature_dir", str(dirs["feats"]),
             "--pretrained_dir", str(dirs["pretrained"]),
             "--ckpt_dir", str(ckpt), "--task_moment_retrieval",
             "--task_moment_segmentation", "--task_step_captioning",
             "--epochs", "1", "--train_batch_size", "32",
             "--eval_batch_size", "32", "--device", "cuda"],
            cwd=REPO, capture_output=True, text=True,
            timeout=PARALLEL_TIMEOUT)
        require(proc.returncode == 0, f"torchrun run --train --mesh_shape "
                f"data:1 exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        written = sorted(p.name for p in ckpt.iterdir())
        print(f"[parallel] torchrun --nproc_per_node=1 run --train "
              f"--mesh_shape data:1 over NCCL: 1 epoch in "
              f"{time.perf_counter() - t0:.1f} s, wrote {written}")
        require({"BEST.pt", "LAST.pt"} <= set(written)
                and all(f"test_{task}_BEST.json" in written
                        for task in TRAIN_TASKS), "torchrun run's files")
        check_test_predictions(ckpt, json.loads(
            (dirs["splits"] / "all_data_test.json").read_text()))

        cards = torch.cuda.device_count()
        for n, specs in ((2, PARALLEL_SPECS), (4, ("data:2,model:2",))):
            if cards < n:
                print(f"[parallel] {cards} card(s): the {n}-rank NCCL check "
                      f"({', '.join(specs)}) needs {n} cards (not run here)")
                continue
            ranks = spawn_ranks(root, f"nccl{n}", "nccl",
                                [f"cuda:{i}" for i in range(n)], specs)
            for spec in specs:
                parallel_compare(f"nccl, {n} cards", spec, ranks, one)
                r = ranks[0][spec]
                print(f"[parallel] {card}: {spec} over NCCL, one card a "
                      f"rank: {r['rate']:.2f} steps/s (warm moment "
                      f"retrieval), all-reduce "
                      f"{r['all_reduce_ms']:.2f} ms a step in "
                      f"{r['all_reduce_calls']:.0f} calls")
    print(f"[parallel] phase done in {time.perf_counter() - start:.1f} s")


# python -m hirest_tpu_torch.bench: (arguments, metric, unit) of each mode
BENCH_MODES = (
    ([], "eva_clip_frames_per_sec_per_chip", "frames/sec"),
    (["--latency"], "step_caption_p50_latency", "ms"),
    (["--vr"], "video_retrieval_queries_per_sec", "queries/sec"),
    (["--e2e"], "e2e_extraction_frames_per_sec", "frames/sec"),
    (["--unrolled", "--bf16"], "eva_clip_frames_per_sec_per_chip",
     "frames/sec"),
    (["--unrolled", "--int8"], "eva_clip_frames_per_sec_per_chip",
     "frames/sec"),
)
BENCH_AGREE = 0.15  # the production configurations against the timing phase


def run_bench(args: list) -> tuple:
    """`python -m hirest_tpu_torch.bench *args` -> (its last line, parsed;
    its stderr); it must exit 0 and end in a JSON line."""
    r = subprocess.run([sys.executable, "-m", "hirest_tpu_torch.bench",
                        *args], cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    what = " ".join(args) or "the ladder"
    require(r.returncode == 0, f"bench {what} exited {r.returncode}: "
            f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    lines = r.stdout.strip().splitlines()
    require(len(lines) >= 2, f"bench {what} printed {lines}")
    return json.loads(lines[-1]), lines[-2], r.stderr


def phase_bench(timing_fps: dict, card: str) -> None:
    """The bench entry point in six modes, each in a process of its own:
    each last line's metric, unit and value > 0; for frames/s its mfu in
    (0, 1], equal to value x useful FLOP over the peak, and a known tag;
    every ladder tag's frames/s, the production two within BENCH_AGREE of
    the timing phase's readings of the same configurations."""
    import re

    from hirest_tpu_torch.bench import (LADDER, PEAK_BF16, config_tag,
                                        eva_useful_tflops_per_frame)

    import gc

    start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the bench's processes share the card
    print(f"[bench] this process holds "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB of the card")
    ladder_tags = [config_tag(c) for c in LADDER]
    known = set(ladder_tags) | {config_tag(c, scan=False) for c in LADDER}
    tf = eva_useful_tflops_per_frame()
    peak = PEAK_BF16[torch.cuda.get_device_name(0)]
    for args, metric, unit in BENCH_MODES:
        t0 = time.perf_counter()
        line, card_line, err = run_bench(args)
        what = " ".join(args) or "ladder"
        print(f"[bench] {what} ({time.perf_counter() - t0:.1f} s, card "
              f"line {card_line!r}): {json.dumps(line)}")
        require(line.get("metric") == metric and line.get("unit") == unit
                and line.get("value", 0) > 0 and "error" not in line,
                f"bench {what}: last line {line}")
        if metric == "eva_clip_frames_per_sec_per_chip":
            mfu, value = line["mfu"], line["value"]
            require(0 < mfu <= 1 and abs(mfu - value * tf * 1e12 / peak)
                    <= 1e-4, f"bench {what}: mfu {mfu} for {value} frames/s")
            require(line["config"].get("config") in known,
                    f"bench {what}: unknown tag {line['config']}")
        got = {tag: float(f) for tag, f in re.findall(
            rf"^# batch {BATCH} (\S+): ([\d.]+) fps", err, re.M)}
        if args:
            continue
        require(sorted(got) == sorted(ladder_tags),
                f"bench ladder printed {sorted(got)}, expected "
                f"{sorted(ladder_tags)}")
        for tag in ladder_tags:
            ref = timing_fps.get(tag)
            beside = (f"timing phase {ref:.2f}, ratio {got[tag] / ref:.4f}"
                      if ref else "not in the timing phase")
            print(f"[bench] {card}: {tag} B={BATCH}: {got[tag]:.2f} "
                  f"frames/s ({beside})")
        for tag in ("bf16+v3", "int8+fq+v3+fm"):
            ratio = got[tag] / timing_fps[tag]
            require(abs(ratio - 1) <= BENCH_AGREE,
                    f"bench {tag} {got[tag]:.2f} frames/s against the "
                    f"timing phase's {timing_fps[tag]:.2f}")
    print(f"[bench] phase done in {time.perf_counter() - start:.1f} s")


EVAL_PROMPTS = ("make oatmeal pancake mix", "fold a fitted sheet",
                "boil an egg", "tie a tie", "plant a tree", "wash a car",
                "bake bread", "sharpen a knife")
EVAL_VIDEOS = 2  # test videos a prompt, and as many negative samples
EVAL_FRAMES = 8  # --n_model_frames: one forward a video
EVAL_SMALL = 2  # prompts of the small split (CPU comparisons, f32 EVA-g)
BERT_BASE = dict(hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072)
MODEL_SCORES = ("CLIPScore", "BERTScore_F1")
NLI_SHARES = ("Entailment", "Contradiction", "Netural")
# retrieval run -> (flags, data dir, launches a forward); a forward a video
RETRIEVAL = {
    "clip f32": (["--video_retrieval_model", "clip", "--raw_frame"],
                 "splits", dict(K6f32=12)),
    "clip bf16": (["--video_retrieval_model", "clip", "--raw_frame",
                   "--fp16"], "splits", dict(K6=12)),
    "clip_g features f32": (["--video_retrieval_model", "clip_g"], "splits",
                            {}),
    "clip_g bf16": (["--video_retrieval_model", "clip_g", "--raw_frame",
                     "--fp16"], "splits", dict(K6=40)),
    "clip_g f32": (["--video_retrieval_model", "clip_g", "--raw_frame"],
                   "small", dict(K6f32=40)),
}


def write_eval_workspace(root: Path, weights: dict) -> dict:
    """The eval phase's working directory, as a user of the two CLIs has
    it: ./pretrained_weights (ViT-B-32.pt, seeded; eva_clip_psz14.pt, the
    factory's weights; bertscore.bin at bert-base width with vocab.txt;
    nli/ at bert-base width with an MNLI id2label, vocab.txt and
    model.safetensors), ./data (a split of EVAL_PROMPTS with EVAL_VIDEOS
    test videos and as many negatives a prompt, its formatted GT, a small
    split of the first EVAL_SMALL prompts), JPEG frames at 1 fps,
    [n_seconds, 1024] features, and seeded predictions for the moment
    tasks and step captioning. Returns the split and the GT."""
    from PIL import Image

    from hirest_tpu_torch.eval.make_gt import build_formatted_gt
    from hirest_tpu_torch.models.convert import save_safetensors
    from hirest_tpu_torch.models.minilm import MiniLmConfig
    from hirest_tpu_torch.utils.init import (random_clip_state_dict,
                                             random_minilm_state_dict,
                                             random_nli_state_dict)

    pre = root / "pretrained_weights"
    (pre / "nli").mkdir(parents=True)
    t0 = time.perf_counter()
    torch.save({k: torch.from_numpy(v) for k, v in
                random_clip_state_dict(seed=0).items()}, pre / "ViT-B-32.pt")
    torch.save({k: torch.as_tensor(v) for k, v in weights.items()},
               pre / "eva_clip_psz14.pt")
    words = [f"word{i}" for i in range(VOCAB_SIZE - 5)]
    vocab = "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                      + words) + "\n"
    (pre / "vocab.txt").write_text(vocab)
    (pre / "nli" / "vocab.txt").write_text(vocab)
    bert = MiniLmConfig(**BERT_BASE)
    torch.save({k: torch.from_numpy(v) for k, v in
                random_minilm_state_dict(bert, seed=1).items()},
               pre / "bertscore.bin")
    nli_sd = random_nli_state_dict(bert, seed=2)
    # the layers' weights 3x the init's, the head's 100x without biases:
    # pairs that get all three labels
    for k in nli_sd:
        if k.startswith("bert.encoder") and k.endswith("dense.weight") or \
                k.endswith(("query.weight", "key.weight", "value.weight")):
            nli_sd[k] = nli_sd[k] * np.float32(3.0)
        elif k.startswith(("classifier", "bert.pooler")):
            nli_sd[k] = (nli_sd[k] * np.float32(100.0)
                         if k.endswith("weight") else np.zeros_like(nli_sd[k]))
    save_safetensors(pre / "nli" / "model.safetensors", nli_sd)
    (pre / "nli" / "config.json").write_text(json.dumps({
        "model_type": "bert", "vocab_size": VOCAB_SIZE,
        "max_position_embeddings": 512, "type_vocab_size": 2,
        "layer_norm_eps": 1e-12, **BERT_BASE,
        "id2label": {"0": "contradiction", "1": "neutral",
                     "2": "entailment"}}))
    print(f"[eval] checkpoints written in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(12)
    splits = {}
    for split in ("test", "test_negative_samples"):
        anns = {}
        for p, prompt in enumerate(EVAL_PROMPTS):
            videos = {}
            for v in range(EVAL_VIDEOS):
                name = f"{split[:4]}{split[-1]}_{p}_{v}.mp4"
                duration = float(rng.integers(16, 31)) + 0.4
                start = int(rng.integers(1, 4))
                end = int(duration) - int(rng.integers(1, 4))
                cuts = np.sort(rng.choice(np.arange(start + 2, end - 1), 2,
                                          replace=False)).tolist()
                edges = [start, *cuts, end]
                videos[name] = {
                    "relevant": True, "clip": True, "v_duration": duration,
                    "bounds": [start, end],
                    "steps": [{"index": i, "heading": " ".join(
                        words[j] for j in rng.integers(0, 2000, 4)),
                        "absolute_bounds": [edges[i], edges[i + 1]]}
                        for i in range(3)]}
            anns[prompt] = videos
        splits[split] = anns
    for d in ("splits", "small", "evaluation"):
        (root / "data" / d).mkdir(parents=True)
    for split, anns in splits.items():
        (root / "data" / "splits" / f"all_data_{split}.json").write_text(
            json.dumps(anns))
        small = {p: anns[p] for p in EVAL_PROMPTS[:EVAL_SMALL]}
        (root / "data" / "small" / f"all_data_{split}.json").write_text(
            json.dumps(small))
    gt = build_formatted_gt(splits["test"])
    (root / "data" / "evaluation" /
     "formatted_moment_evaluation_gt.json").write_text(json.dumps(gt))

    (root / "feats").mkdir()
    t0 = time.perf_counter()
    for anns in splits.values():
        for videos in anns.values():
            for name, ann in videos.items():
                n = round(ann["v_duration"])
                np.save(root / "feats" / f"{name}.npy",
                        rng.normal(size=(n, 1024)).astype(np.float32))
                d = root / "frames" / name
                d.mkdir(parents=True)
                for i in range(1, n + 1):
                    Image.fromarray(rng.integers(0, 256, (96, 128, 3),
                                                 dtype=np.uint8)).save(
                        d / f"frame_{i:04d}.jpg", quality=90)
    print(f"[eval] frames and features written in "
          f"{time.perf_counter() - t0:.1f} s")

    test = splits["test"]
    mr = {p: {v: {"bounds": (np.asarray(a["bounds"]) + rng.integers(
        -3, 4, 2)).tolist()} for v, a in test[p].items()} for p in test}
    ms = {v: {"bounds": (np.asarray(g["bounds"]) + rng.integers(
        -2, 3, (len(g["bounds"]), 2))).tolist()} for v, g in gt.items()}
    heads = [c["sentence"] for g in gt.values() for c in g["captions"]]
    sc = {v: {"captions": [{"sentence": heads[int(rng.integers(len(heads)))]}
                           for _ in g["captions"]]} for v, g in gt.items()}
    (root / "preds").mkdir()
    for name, obj in (("mr", mr), ("ms", ms), ("sc", sc)):
        (root / "preds" / f"{name}.json").write_text(json.dumps(obj))
    return {"test": test, "gt": gt, "sc": sc}


def retrieval_run(argv: list, device: str) -> tuple:
    """What `python -m hirest_tpu_torch.inference_video_retrieval` runs
    (inference_video_retrieval.main: the towers, then run_video_retrieval),
    with the launch counts zeroed after the towers are built and read after
    the scoring: (result, seconds of the scoring, counts, (encode_text,
    encode_image))."""
    from hirest_tpu_torch.config import HirestConfig
    from hirest_tpu_torch.infer.retrieval import run_video_retrieval
    from hirest_tpu_torch.inference_video_retrieval import _build_towers
    from hirest_tpu_torch.models.eva_clip import preprocess_image

    config = HirestConfig.from_args(argv + ["--device", device])
    towers = _build_towers(config, torch.device(device))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    res = run_video_retrieval(config, *towers,
                              preprocess_image if config.raw_frame else None)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, read_counts(), towers


def eval_close(tag: str, got, want, tol: float = F32_TOL) -> float:
    """got against want (both on the host) within tol of want's largest
    magnitude; returns the error."""
    got = got.detach().float().cpu().numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32)
    want = want.detach().float().cpu().numpy() if isinstance(
        want, torch.Tensor) else np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    top = float(np.abs(want).max())
    print(f"[eval] {tag}: max_abs_err={err} of max|ref|={top}")
    require(got.shape == want.shape and err <= tol * top,
            f"{tag} beyond {tol}")
    return err


def frame_batch(root: Path, video: str) -> np.ndarray:
    """EVAL_FRAMES preprocessed frames of one video, as the retrieval CLI
    samples them."""
    from PIL import Image

    from hirest_tpu_torch.models.eva_clip import preprocess_image
    from hirest_tpu_torch.timeline import subsample_indices

    paths = sorted((root / "frames" / video).glob("frame_*.jpg"))
    return np.stack([preprocess_image(Image.open(paths[i]).convert("RGB"))
                     for i in subsample_indices(len(paths), EVAL_FRAMES)])


def eval_retrieval(root: Path, weights: dict, split: dict,
                   card: str) -> dict:
    """The retrieval CLI's runs (RETRIEVAL) on the card, their launch
    counts and videos/s; main(argv) itself once; the card against the
    port's CPU f32 towers and run; bf16 against f32. Returns the f32
    run's JSON path and the launches."""
    from hirest_tpu_torch.config import EvaTextConfig
    from hirest_tpu_torch.inference_video_retrieval import main as vr_main
    from hirest_tpu_torch.models.eva_clip import eva_text_encoder
    from hirest_tpu_torch.tokenizers import clip_tokenize

    base = ["--video_feature_dir", "feats", "--video_dir", "frames",
            "--pretrained_dir", "pretrained_weights", "--n_model_frames",
            str(EVAL_FRAMES)]
    launches: dict = {}
    towers, results = {}, {}
    for tag, (flags, data, per_forward) in RETRIEVAL.items():
        argv = base + flags + ["--data_dir", f"data/{data}", "--run_name",
                               tag.replace(" ", "_")]
        res, secs, counts, towers[tag] = retrieval_run(argv, "cuda")
        results[tag] = res
        videos = len(next(iter(res.values()))["videos"])
        want = expect(**{k: v * videos for k, v in per_forward.items()})
        print(f"[eval] {card}: retrieval {tag}: {len(res)} prompts x "
              f"{videos} videos in {secs:.3f} s, {videos / secs:.2f} "
              f"videos/s; launches { {k: v for k, v in counts.items() if v} }")
        require(counts == want, f"retrieval {tag} launches {counts}, "
                                f"expected {want}")
        for prompt, row in res.items():
            require(len(row["scores"]) == videos
                    and bool(np.isfinite(row["scores"]).all()),
                    f"retrieval {tag}: scores of {prompt!r}")
        launches.update({k: launches.get(k, 0) + v
                         for k, v in counts.items() if v})

    # the entry point itself gives the decomposed run's JSON
    zero_counts()
    got = vr_main(base + RETRIEVAL["clip f32"][0] + [
        "--data_dir", "data/splits", "--run_name", "clip_f32_main",
        "--device", "cuda"])
    torch.cuda.synchronize()
    main_counts = read_counts()
    for k, v in main_counts.items():
        if v:
            launches[k] = launches.get(k, 0) + v
    eval_close("inference_video_retrieval.main clip f32 vs run_video_"
               "retrieval", [r["scores"] for r in got.values()],
               [r["scores"] for r in results["clip f32"].values()])

    # ViT-B/32 at full depth, the card against the CPU f32 towers and run
    ids = clip_tokenize(list(EVAL_PROMPTS))
    frames = frame_batch(root, next(iter(split["test"][EVAL_PROMPTS[0]])))
    cpu_argv = base + RETRIEVAL["clip f32"][0] + ["--data_dir", "data/small",
                                                 "--run_name", "clip_cpu"]
    cpu_res, _, _, (cpu_text, cpu_image) = retrieval_run(cpu_argv, "cpu")
    card_small = retrieval_run(cpu_argv[:-1] + ["clip_small"], "cuda")[0]
    text, image = towers["clip f32"]
    eval_close("ViT-B/32 text embeddings, card vs CPU f32", text(ids),
               cpu_text(ids))
    eval_close("ViT-B/32 image embeddings, card vs CPU f32", image(frames),
               cpu_image(frames))
    eval_close("ViT-B/32 retrieval scores (small split), card vs CPU f32",
               [r["scores"] for r in card_small.values()],
               [r["scores"] for r in cpu_res.values()])
    # the EVA-CLIP-g text tower at full depth
    cpu_eva_text = eva_text_encoder(weights, EvaTextConfig(), torch.float32,
                                    torch.device("cpu"))
    eval_close("EVA-CLIP-g text embeddings, card vs CPU f32",
               towers["clip_g features f32"][0](ids), cpu_eva_text(ids))
    # bf16 against f32 on the card
    for what, bf16, f32 in (
            ("ViT-B/32 text", towers["clip bf16"][0](ids), text(ids)),
            ("ViT-B/32 image", towers["clip bf16"][1](frames),
             image(frames)),
            ("EVA-CLIP-g text", towers["clip_g bf16"][0](ids),
             towers["clip_g features f32"][0](ids)),
            ("EVA-CLIP-g image", towers["clip_g bf16"][1](frames),
             towers["clip_g f32"][1](frames))):
        cos = cosine(bf16.float().cpu().numpy(), f32.float().cpu().numpy())
        print(f"[eval] {what} embeddings bf16 vs f32 on the card: min "
              f"cosine {cos.min():.6f} (>= {COS_MIN})")
        require(bool(cos.min() >= COS_MIN), f"{what} bf16 off f32")
    return {"vr_json": "VR_results/clip_f32.json", "launches": launches}


def eval_tasks(split: dict, vr_json: str, card: str) -> None:
    """`python -m hirest_tpu_torch.evaluate`'s main for the four tasks on
    the card and with --device cpu: host metrics equal; CLIPScore and
    BERTScore within 1e-5; entailment labels equal wherever the CPU's top-2
    margin exceeds the measured logit error (the shares may differ only by
    the pairs under it; the logits' error is printed, not bounded: the
    sharpened head's logits reach ~100). Then the scorers' readings on the
    card."""
    from hirest_tpu_torch.eval import cli
    from hirest_tpu_torch.models.nli import make_nli_entailment_fn

    tasks = {
        "video_retrieval": ["--pred_data", vr_json],
        "moment_retrieval": ["--pred_data", "preds/mr.json"],
        "moment_segmentation": ["--pred_data", "preds/ms.json",
                                "--preprocess_moment_bounds"],
        "step_captioning": ["--pred_data", "preds/sc.json", "--frame_dir",
                            "frames"]}
    for task, extra in tasks.items():
        argv = ["--task", task, "--data_root", "data", *extra]
        t0 = time.perf_counter()
        got = cli.main(argv + ["--device", "cuda"])
        t1 = time.perf_counter()
        want = cli.main(argv + ["--device", "cpu"])
        t2 = time.perf_counter()
        print(f"[eval] {card}: evaluate --task {task}: card {t1 - t0:.2f} "
              f"s, CPU {t2 - t1:.2f} s; card {got['all']}")
        if task != "step_captioning":
            require(got == want and bool(got["all"]),
                    f"evaluate {task}: card {got} vs CPU {want}")
            continue
        g, w = got["all"], want["all"]
        require(set(g) == set(w) and set(MODEL_SCORES + NLI_SHARES) <= set(g),
                f"step_captioning keys {sorted(g)} vs {sorted(w)}")
        for k in MODEL_SCORES:
            print(f"[eval] step_captioning {k}: card {g[k]!r}, CPU {w[k]!r}, "
                  f"|diff| {abs(g[k] - w[k])}")
            require(abs(g[k] - w[k]) <= F32_TOL * max(1.0, abs(w[k])),
                    f"step_captioning {k} beyond {F32_TOL}")
        host = [k for k in w if k not in MODEL_SCORES + NLI_SHARES]
        require({k: g[k] for k in host} == {k: w[k] for k in host},
                "step_captioning host metrics differ")

    # the entailment labels pair by pair: the evaluator's (reference,
    # candidate) pairs, lowercased, in its order
    gt, sc = split["gt"], split["sc"]
    pairs = [(c["sentence"].lower(),
              sc[v]["captions"][i]["sentence"].lower())
             for v in gt for i, c in enumerate(gt[v]["captions"])]
    nli_dir = "pretrained_weights/nli"
    card_fn = make_nli_entailment_fn(nli_dir, device="cuda")
    cpu_fn = make_nli_entailment_fn(nli_dir, device="cpu")
    lc, lp = card_fn.logits(pairs), cpu_fn.logits(pairs)
    err = float(np.abs(lc - lp).max())
    top2 = np.sort(lp, 1)
    margin = top2[:, -1] - top2[:, -2]
    clear = margin > err
    same = lc.argmax(1) == lp.argmax(1)
    print(f"[eval] NLI logits over {len(pairs)} pairs, card vs CPU: "
          f"max_abs_err={err} of max|ref|={np.abs(lp).max()}; labels "
          f"{np.bincount(lp.argmax(1), minlength=3).tolist()} (CPU), "
          f"{int(same.sum())} equal, {int((~clear).sum())} pairs with a "
          f"top-2 margin under the error")
    require(bool(np.isfinite(lc).all()) and bool(same[clear].all()),
            "NLI labels differ where the CPU's top-2 margin is clear")
    require(all(abs(g[k] - w[k]) <= 100 * int((~clear).sum()) / len(pairs)
                for k in NLI_SHARES), "entailment shares differ")

    # readings on the card
    clip_fn = cli._try_build_clipscore("frames", "pretrained_weights",
                                       device="cuda")
    steps = [(v, sc[v]["captions"][i]["sentence"].lower(), c["start"],
              c["end"]) for v in gt for i, c in enumerate(gt[v]["captions"])]
    clip_fn(*steps[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in steps:
        clip_fn(*step)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / len(steps) * 1e3
    print(f"[eval] {card}: CLIPScore {step_ms:.2f} ms a step (4 frames "
          f"decoded and preprocessed on the host, ViT-B/32 f32 on the "
          f"card), {len(steps)} steps")
    profile_call("one CLIPScore step", lambda: clip_fn(*steps[0]), card,
                 "clip", tag="eval")
    bs = cli._try_build_bertscore("pretrained_weights", device="cuda")
    cands, refs = [h for _, h in pairs], [p for p, _ in pairs]
    bs(cands, refs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bs(cands, refs)
    torch.cuda.synchronize()
    rate = len(pairs) / (time.perf_counter() - t0)
    print(f"[eval] {card}: BERTScore (bert-base width) {rate:.1f} pairs/s "
          f"over {len(pairs)} pairs")
    card_fn.batch(pairs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_fn.batch(pairs)
    torch.cuda.synchronize()
    rate = len(pairs) / (time.perf_counter() - t0)
    print(f"[eval] {card}: NLI cross-encoder (bert-base width) {rate:.1f} "
          f"pairs/s over {len(pairs)} pairs")


def phase_eval(weights: dict, card: str) -> dict:
    """The evaluation and zero-shot retrieval entry points at full width on
    seeded random weights, in a temp directory that holds what a user's
    working directory does (write_eval_workspace). Returns the launches."""
    import os
    import tempfile

    start = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        split = write_eval_workspace(root, weights)
        os.chdir(root)
        try:
            res = eval_retrieval(root, weights, split, card)
            eval_tasks(split, res["vr_json"], card)
        finally:
            os.chdir(cwd)
    print(f"[eval] {card}: phase done in {time.perf_counter() - start:.1f} s")
    return res["launches"]


SOURCES = {  # kernel -> (wrapper name, source, TPU kernel it replaces)
    "K1": ("fused_attention_qkv3",
           "hirest_tpu_torch/ops/csrc/attention_qkv3.cu",
           "hirest_tpu/ops/attention.py:471"),
    "K2": ("ln_quant", "hirest_tpu_torch/ops/csrc/ln_quant.cu",
           "hirest_tpu/ops/quant.py:145"),
    "K3": ("fused_attention_qkv3(quant_out=True)",
           "hirest_tpu_torch/ops/csrc/attention_qkv3.cu",
           "hirest_tpu/ops/attention.py:502"),
    "K4": ("fused_mlp_int8", "hirest_tpu_torch/ops/csrc/fused_mlp_int8.cu",
           "hirest_tpu/ops/quant.py:296"),
    "K6": ("fused_attention", "hirest_tpu_torch/ops/csrc/attention_qkv3.cu",
           "hirest_tpu/ops/attention.py:69"),
    "K7": ("fused_attention_packed",
           "hirest_tpu_torch/ops/csrc/attention_qkv3.cu",
           "hirest_tpu/ops/attention.py:188"),
    "K5": ("act_quant", "hirest_tpu_torch/ops/csrc/act_quant.cu",
           "hirest_tpu/ops/quant.py:176"),
    "K8": ("fused_attention_qkv",
           "hirest_tpu_torch/ops/csrc/attention_qkv3.cu",
           "hirest_tpu/ops/attention.py:551"),
    "K8q": ("fused_attention_qkv(quant_out=True)",
            "hirest_tpu_torch/ops/csrc/attention_qkv3.cu",
            "hirest_tpu/ops/attention.py:585"),
    "K9": ("fused_attention_qkv2",
           "hirest_tpu_torch/ops/csrc/attention_qkv3.cu",
           "hirest_tpu/ops/attention.py:349"),
    "K9q": ("fused_attention_qkv2(quant_out=True)",
            "hirest_tpu_torch/ops/csrc/attention_qkv3.cu",
            "hirest_tpu/ops/attention.py:378"),
    "K10": ("ln_bf16", "hirest_tpu_torch/ops/csrc/ln_quant.cu",
            "hirest_tpu/ops/quant.py:220"),
    # the f32 body, one kernel for each wrapper's f32 inputs
    "K6f32": ("fused_attention (float32)",
              "hirest_tpu_torch/ops/csrc/attention_f32.cu",
              "hirest_tpu/ops/attention.py:69"),
    "K7f32": ("fused_attention_packed (float32)",
              "hirest_tpu_torch/ops/csrc/attention_f32.cu",
              "hirest_tpu/ops/attention.py:188"),
    "K1f32": ("fused_attention_qkv3 (float32)",
              "hirest_tpu_torch/ops/csrc/attention_f32.cu",
              "hirest_tpu/ops/attention.py:471"),
    "K9f32": ("fused_attention_qkv2 (float32)",
              "hirest_tpu_torch/ops/csrc/attention_f32.cu",
              "hirest_tpu/ops/attention.py:349"),
    "K8f32": ("fused_attention_qkv (float32)",
              "hirest_tpu_torch/ops/csrc/attention_f32.cu",
              "hirest_tpu/ops/attention.py:551"),
    # the f32 int8 factory's: the int8-out forms on the f32 body, K2 on f32
    # rows, K4 with an f32 residual
    "K3f32": ("fused_attention_qkv3(quant_out=True) (float32)",
              "hirest_tpu_torch/ops/csrc/attention_f32.cu",
              "hirest_tpu/ops/attention.py:502"),
    "K9qf32": ("fused_attention_qkv2(quant_out=True) (float32)",
               "hirest_tpu_torch/ops/csrc/attention_f32.cu",
               "hirest_tpu/ops/attention.py:378"),
    "K8qf32": ("fused_attention_qkv(quant_out=True) (float32)",
               "hirest_tpu_torch/ops/csrc/attention_f32.cu",
               "hirest_tpu/ops/attention.py:585"),
    "K2f32": ("ln_quant (float32)", "hirest_tpu_torch/ops/csrc/ln_quant.cu",
              "hirest_tpu/ops/quant.py:145"),
    "K4f32": ("fused_mlp_int8 (float32 residual)",
              "hirest_tpu_torch/ops/csrc/fused_mlp_int8.cu",
              "hirest_tpu/ops/quant.py:296"),
    # the f32 ladder's: K5 in the f32 fused-quant MLP, K10 as the f32
    # fused LayerNorm
    "K5f32": ("act_quant (float32)", "hirest_tpu_torch/ops/csrc/act_quant.cu",
              "hirest_tpu/ops/quant.py:176"),
    "K10f32": ("ln_bf16 (float32)", "hirest_tpu_torch/ops/csrc/ln_quant.cu",
               "hirest_tpu/ops/quant.py:220"),
    # no Pallas kernel: the XLA fusions of the scanned block's projection
    # epilogues into their dots (also :310's qkv bias, :342's int8 dyn
    # GELU and :347's proj bias + residual); times at fc1's [M, 6144]
    # (bias, gelu_bf16_poly) and fc2's [M, 1408], library F.gelu on E1's
    # bytes and torch.add(x, y) on E2's
    "E1": ("bias_act", "hirest_tpu_torch/ops/csrc/epilogue.cu",
           "hirest_tpu/models/eva_scan.py:350"),
    "E2": ("bias_residual", "hirest_tpu_torch/ops/csrc/epilogue.cu",
           "hirest_tpu/models/eva_scan.py:351"),
    "E1f32": ("bias_act (float32)", "hirest_tpu_torch/ops/csrc/epilogue.cu",
              "hirest_tpu/models/eva_scan.py:350"),
    "E2f32": ("bias_residual (float32)",
              "hirest_tpu_torch/ops/csrc/epilogue.cu",
              "hirest_tpu/models/eva_scan.py:351"),
    # no Pallas kernel: the XLA fusions of the int8 products' dequant
    # epilogue (with the residual at :320, :334, :338, :345; also
    # hirest_tpu/ops/quant.py:52-55) and of int8_matmul's row quantization
    # (hirest_tpu/ops/quant.py:45-48, as _dyn_quant_rows :84-89); times at
    # the qkv projection [M, 4224], the unrolled tower's [M, 1408] rows (E4
    # on K5's ring body) and its patch rows (E4rows: row_quant_kernel)
    "E3": ("int8_epilogue", "hirest_tpu_torch/ops/csrc/int8_epilogue.cu",
           "hirest_tpu/models/eva_scan.py:92"),
    "E3f32": ("int8_epilogue (float32)",
              "hirest_tpu_torch/ops/csrc/int8_epilogue.cu",
              "hirest_tpu/models/eva_scan.py:92"),
    "E4": ("row_quant", "hirest_tpu_torch/ops/csrc/act_quant.cu",
           "hirest_tpu/ops/quant.py:46"),
    "E4rows": ("row_quant (patch rows)",
               "hirest_tpu_torch/ops/csrc/int8_epilogue.cu",
               "hirest_tpu/ops/quant.py:46"),
    "E4f32": ("row_quant (float32)",
              "hirest_tpu_torch/ops/csrc/int8_epilogue.cu",
              "hirest_tpu/ops/quant.py:46"),
    # no Pallas kernel: XLA's int8 dot_general with the dequant (E3's
    # arithmetic) fused into its epilogue (hirest_tpu/ops/quant.py:41-55
    # too); times at the qkv projection [32896, 1408] x [1408, 4224] with
    # its bias; library_ms null (no one PyTorch call computes it),
    # torch._int_mm's product alone and with E3 beside it
    "G1": ("int8_mm", "hirest_tpu_torch/ops/csrc/int8_gemm.cu",
           "hirest_tpu/models/eva_scan.py:92"),
    "G1f32": ("int8_mm (float32)", "hirest_tpu_torch/ops/csrc/int8_gemm.cu",
              "hirest_tpu/models/eva_scan.py:92"),
}


ATTN_FORWARDS = 3  # timed forwards of B=128 a configuration, after a warm-up


def attention_forwards(cfg, card: str) -> None:
    """The six forwards where K6, K7 and K8 run, at full width and depth on
    seeded weights: the ladder's bf16 (v1, K8), int8 dyn (K8) and int8+fq
    (K8 int8), the unrolled tower (K6), the padded unrolled tower (K7) and
    the unrolled int8 tower (K6): ms a forward and frames/s over
    ATTN_FORWARDS, and one profiled forward's groups. Through what every
    version of the port has, so that a copy of this file in an earlier
    checkout profiles that checkout's forwards."""
    from hirest_tpu_torch.models.eva_clip import build_unrolled_vision_apply
    from hirest_tpu_torch.models.eva_pad import pad_vision_head_params
    from hirest_tpu_torch.models.eva_quant import build_int8_vision_apply
    from hirest_tpu_torch.models.eva_scan import (build_scanned_vision_apply,
                                                  stage_scanned_params)
    from hirest_tpu_torch.utils.init import random_eva_vision_state_dict

    sd = random_eva_vision_state_dict(cfg, seed=0)
    frames = normalize_frames(np.random.default_rng(5).integers(
        0, 256, (BATCH, 224, 224, 3), dtype=np.uint8))

    def timed(tag: str, fn, groups: str) -> None:
        fn(frames)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(ATTN_FORWARDS):
            out = fn(frames)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        require(bool(torch.as_tensor(out).isfinite().all()),
                f"{tag}: non-finite output")
        print(f"[time-attention] {card}: {REPO.name}: {tag}: "
              f"{secs / ATTN_FORWARDS * 1e3:.2f} ms a forward of {BATCH}, "
              f"{BATCH * ATTN_FORWARDS / secs:.2f} frames/s")
        profile_call(f"one {tag} forward B={BATCH}", lambda: fn(frames),
                     card, groups, tag="time-attention")

    for int8, runs in ((False, (("ladder bf16", {}, "ladder bf16"),)),
                       (True, (("ladder int8 dyn", dict(int8=True),
                                "ladder int8 K8"),
                               ("ladder int8+fq",
                                dict(int8=True, fused_quant=True),
                                "ladder int8 K8")))):
        staged = stage_scanned_params(sd, cfg, int8=int8,
                                      dtype=torch.bfloat16, device="cuda")
        for tag, flags, groups in runs:
            timed(tag, build_scanned_vision_apply(
                None, cfg, staged=staged, dtype=torch.bfloat16,
                device="cuda", **flags), groups)
        del staged
        torch.cuda.empty_cache()
    timed("unrolled", build_unrolled_vision_apply(sd, cfg, device="cuda"),
          "unrolled")
    psd, pcfg = pad_vision_head_params(sd, cfg)
    timed("padded unrolled", build_unrolled_vision_apply(
        psd, pcfg, device="cuda"), "unrolled")
    del psd
    timed("unrolled int8", build_int8_vision_apply(sd, cfg, device="cuda"),
          "unrolled int8")


def time_attention(cfg, card: str) -> None:
    """K1 and K3 (at head widths 88 and 128), K9 (bf16 and int8 out), K6
    (also at ViT-B/32's [128, 12, 50, 64]), K7 and K8 (bf16 and int8 out)
    ms per call at B=128, beside scaled_dot_product_attention at each head
    width and each kernel's bound, through the wrappers that earlier
    versions of the port have too, so that this file copied into an
    earlier checkout times that checkout's kernels. K1 is also timed at 192
    and 384 tokens (whole 192-row query tiles: every consumer of
    attention_qkv3.cu busy), against 257, where a head's second tile has
    65 rows. Where K3 has its cluster epilogue, also its two-step epilogue
    (the same body, -DHIREST_QKV3_TWO_STEP=1) and each cluster variant
    forced; where K8 runs on attention_qkv3.cu's v1 form, the same for K8
    int8. Then the six forwards of attention_forwards."""
    import torch.nn.functional as F

    from hirest_tpu_torch.models.layers import split_heads
    from hirest_tpu_torch.ops import attention, build
    from hirest_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_packed,
                                                fused_attention_qkv,
                                                fused_attention_qkv2,
                                                fused_attention_qkv3)

    cluster = hasattr(attention, "qkv3_cluster_info")  # K3's epilogue
    v1 = hasattr(attention, "v1_route")  # K6-K8 on attention_qkv3.cu
    logs = build.build()  # every source at once, as the forwards need them
    if cluster:
        logs.update(build.build(("attention_qkv3",), attention.QKV3_TWO_STEP))
    ptxas_summary(logs.get("attention_qkv3", ""), ("attention_qkv3_kernel",))
    scale, heads = cfg.head_width ** -0.5, cfg.num_heads
    p128 = 128 ** -0.5
    qkv = attention_inputs(BATCH, seed=7)
    q, k, v = split_views(attention_inputs(BATCH, seed=11))
    qkv128 = attention_inputs(BATCH, seed=12, hd=PADDED_HD)
    pq, pk, pv = qkv128.chunk(3, -1)
    qkv8 = attention_inputs(BATCH, seed=13)
    qb, vb = biases(heads * cfg.head_width, seed=14)
    hq, hk, hv = split_views(qkv)
    sq, sk, sv = split_views(qkv128)
    w = heads * cfg.head_width
    bq, bv = (split_heads(t + bias, heads) for t, bias in
              ((qkv8[..., :w], qb), (qkv8[..., 2 * w:], vb)))
    bk = split_heads(qkv8[..., w:2 * w], heads)
    vit = split_views(attention_inputs(BATCH, seed=17, tokens=50, hd=768), 12)
    qkv192 = attention_inputs(BATCH, seed=15, tokens=192)
    qkv384 = attention_inputs(BATCH, seed=16, tokens=384)
    ms = {"K1": cuda_ms(lambda: fused_attention_qkv3(qkv, scale, heads), 50),
          "K1 S=192": cuda_ms(lambda: fused_attention_qkv3(
              qkv192, scale, heads), 50),
          "K1 S=384": cuda_ms(lambda: fused_attention_qkv3(
              qkv384, scale, heads), 50),
          "K1 d=128": cuda_ms(lambda: fused_attention_qkv3(
              qkv128, p128, heads), 50),
          "K3": cuda_ms(lambda: fused_attention_qkv3(
              qkv, scale, heads, quant_out=True), 50),
          "K3 d=128": cuda_ms(lambda: fused_attention_qkv3(
              qkv128, p128, heads, quant_out=True), 50),
          "K9": cuda_ms(lambda: fused_attention_qkv2(qkv, scale, heads), 50),
          "K9q": cuda_ms(lambda: fused_attention_qkv2(
              qkv, scale, heads, quant_out=True), 50),
          "SDPA d=88": cuda_ms(lambda: F.scaled_dot_product_attention(
              hq, hk, hv, scale=scale), 50),
          "SDPA d=128": cuda_ms(lambda: F.scaled_dot_product_attention(
              sq, sk, sv, scale=p128), 50),
          "SDPA K8's biased heads": cuda_ms(
              lambda: F.scaled_dot_product_attention(bq, bk, bv,
                                                     scale=scale), 50),
          "SDPA d=64 [128,12,50,64]": cuda_ms(
              lambda: F.scaled_dot_product_attention(*vit, scale=0.125), 50),
          "K6": cuda_ms(lambda: fused_attention(q, k, v, scale), 50),
          "K6 d=64 [128,12,50,64]": cuda_ms(
              lambda: fused_attention(*vit, 0.125), 50),
          "K7": cuda_ms(lambda: fused_attention_packed(
              pq, pk, pv, p128, heads), 50),
          "K8": cuda_ms(lambda: fused_attention_qkv(qkv8, qb, vb, scale,
                                                    heads), 50),
          "K8q": cuda_ms(lambda: fused_attention_qkv(
              qkv8, qb, vb, scale, heads, quant_out=True), 50)}
    ms["K9q d=128"] = cuda_ms(lambda: fused_attention_qkv2(
        qkv128, p128, heads, quant_out=True), 50)
    if cluster:
        # K3's epilogues on the same inputs: the two-step one (the same
        # body, -DHIREST_QKV3_TWO_STEP=1) and each cluster variant forced
        for d, x, sc in ((88, qkv, scale), (128, qkv128, p128)):
            sfx = "" if d == 88 else " d=128"
            info = attention.qkv3_cluster_info(d)
            print(f"[time-attention] {card}: K3 d={d}: "
                  f"cudaOccupancyMaxActiveClusters {info['clusters_of_16']} "
                  f"clusters of 16, {info['clusters_of_8']} of 8; the "
                  f"launch takes {K3_VARIANTS[info['heads_per_block']]}")
            ms[f"K3 two-step{sfx}"] = cuda_ms(
                lambda x=x, sc=sc: attention._launch_qkv3(
                    x, sc, heads, True, 0, two_step=True), 50)
            for h in K3_VARIANTS:
                ms[f"K3 {K3_VARIANTS[h]}{sfx}"] = cuda_ms(
                    lambda x=x, sc=sc, h=h: attention._launch_qkv3(
                        x, sc, heads, True, 0, heads_per_block=h), 50)
    if v1:
        # K8 int8's epilogues: the two-step one and each variant forced
        info = attention.qkv3_cluster_info(cfg.head_width, v1=True)
        print(f"[time-attention] {card}: K8 int8: "
              f"cudaOccupancyMaxActiveClusters {info['clusters_of_16']} "
              f"clusters of 16, {info['clusters_of_8']} of 8; the launch "
              f"takes {K3_VARIANTS[info['heads_per_block']]}")
        tq, tk, tv = split_views(qkv8)
        tb = [attention._bias_arg(t, w, qkv8.device) for t in (qb, vb)]
        ms["K8q two-step"] = cuda_ms(lambda: attention._launch_v1(
            tq, tk, tv, None, None, scale, *tb, two_step=True), 50)
        for h in K3_VARIANTS:
            ms[f"K8q {K3_VARIANTS[h]}"] = cuda_ms(
                lambda h=h: attention._launch_v1(
                    tq, tk, tv, None, None, scale, *tb, heads_per_block=h),
                50)
    print(f"[time-attention] {card}: {REPO}: " + ", ".join(
        f"{name} {t:.4f} ms" for name, t in ms.items()))
    m = BATCH * TOKENS
    for d, x in ((88, qkv), (128, qkv128)):
        hd = heads * d
        flops = 2 * 2 * BATCH * heads * TOKENS * TOKENS * d
        k1 = bound(x.numel() * 2 + m * hd * 2, flops, BF16_FLOP_PER_S)
        k3 = bound(x.numel() * 2 + m * hd + m * 4, flops, BF16_FLOP_PER_S)
        print(f"[time-attention] bounds d={d}: K1, K6, K7 and K8 "
              f"{k1['bound_ms']:.4f} ms ({k1['bound_by']}), K3, K9 int8 and "
              f"K8 int8 {k3['bound_ms']:.4f} ms ({k3['bound_by']})")
    b64 = bound(4 * vit[0].numel() * 2,
                2 * 2 * BATCH * 12 * 50 * 50 * 64, BF16_FLOP_PER_S)
    print(f"[time-attention] bounds d=64 [128,12,50,64]: K6 "
          f"{b64['bound_ms']:.4f} ms ({b64['bound_by']})")
    attention_forwards(cfg, card)


def time_f32(cfg, card: str) -> None:
    """The f32 forms ms per call at B=128 and nothing else, through the
    wrappers (see time_attention): attention_f32.cu's body as K6 at
    ViT-B/32's [128, 12, 50, 64] and EVA-g's, K7 at d = 128, K1 (n_real)
    and K8 (biased), its int8-out forms K3, K9 and K8 int8, K2, K5
    (gelu_bf16_poly at 6144) and K10 on f32 rows and K4 with an f32
    residual, beside SDPA in f32 at the body's three shapes; a form the
    checkout refuses (an earlier one, without f32 int8 or f32 row forms)
    prints as such. Also the f32 body's and the f32 row forms' registers,
    spills and wgmma serialisations from their builds, the body's HGMMA
    instructions in its SASS, the device's and the host's time a call at
    ViT-B/32's shape (the body's and SDPA's), the int8-out form K3's
    device time split into the body and the row pass (quant_rows_kernel)
    beside K1's body on the same qkv, and the body's trace (trace_f32)."""
    from hirest_tpu_torch.ops import build
    from hirest_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_packed,
                                                fused_attention_qkv,
                                                fused_attention_qkv2,
                                                fused_attention_qkv3)
    import torch.nn.functional as F

    from hirest_tpu_torch.models.layers import split_heads
    from hirest_tpu_torch.ops.quant import (act_quant, fused_mlp_int8,
                                            ln_bf16, ln_quant)

    logs = build.build(("attention_f32", "ln_quant", "fused_mlp_int8",
                        "act_quant"))
    ptxas_summary(logs.get("attention_f32", ""), ("attention_f32_kernel",))
    ptxas_summary(logs.get("act_quant", ""), ("act_quant_f32_kernel",))
    ptxas_summary(logs.get("ln_quant", ""), ("ln_f32_kernel",))
    hgmma_counts(build.library_path("attention_f32"), "attention_f32_kernel")
    scale, heads, w = cfg.head_width ** -0.5, cfg.num_heads, cfg.width
    vit = split_views(f32_inputs(BATCH, 260, 50, 12 * 64), 12)
    qkv = f32_inputs(BATCH, 261, TOKENS, w)
    qkv264 = f32_inputs(BATCH, 262, 264, w)
    q, k, v = split_views(qkv)
    pq, pk, pv = f32_inputs(BATCH, 263, TOKENS, PADDED_HD).chunk(3, -1)
    g = gen(264)
    qb, vb = (torch.randn(w, generator=g, device="cuda") * 0.5
              for _ in range(2))
    x, lw, lb = ln_inputs(BATCH * TOKENS, seed=265)
    x = x.float()
    mlp = list(mlp_inputs(BATCH * TOKENS, seed=266))
    mlp[-1] = mlp[-1].float()
    h6 = fc1_inputs(BATCH * TOKENS, seed=267, c=cfg.mlp_hidden,
                    dtype=torch.float32)
    forms = {
        "K6f32 ViT-B/32": lambda: fused_attention(*vit, 0.125),
        "K6f32 EVA-g": lambda: fused_attention(q, k, v, scale),
        "K7f32": lambda: fused_attention_packed(pq, pk, pv, 128 ** -0.5,
                                                heads),
        "K1f32 n_real": lambda: fused_attention_qkv3(qkv264, scale, heads,
                                                     n_real=TOKENS),
        "K8f32": lambda: fused_attention_qkv(qkv, qb, vb, scale, heads),
        "K3f32": lambda: fused_attention_qkv3(qkv, scale, heads,
                                              quant_out=True),
        "K9qf32": lambda: fused_attention_qkv2(qkv, scale, heads,
                                               quant_out=True),
        "K8qf32": lambda: fused_attention_qkv(qkv, qb, vb, scale, heads,
                                              quant_out=True),
        "K2f32": lambda: ln_quant(x, lw, lb, EPS),
        "K5f32": lambda: act_quant(h6, act="gelu_poly"),
        "K10f32": lambda: ln_bf16(x, lw, lb, EPS),
        "K4f32": lambda: fused_mlp_int8(*mlp),
        "SDPA f32 ViT-B/32": lambda: F.scaled_dot_product_attention(
            *vit, scale=0.125),
        "SDPA f32 EVA-g": lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale),
        "SDPA f32 d=128": lambda: F.scaled_dot_product_attention(
            *(split_heads(t, heads) for t in (pq, pk, pv)),
            scale=128 ** -0.5)}
    ms = {}
    for name, fn in forms.items():
        try:
            fn()
        except TypeError:
            ms[name] = "not in this tree"
            continue
        ms[name] = f"{cuda_ms(fn, 20):.4f} ms"
    print(f"[time-f32] {card}: {REPO}: " + ", ".join(
        f"{name} {t}" for name, t in ms.items()))
    # ViT-B/32's shape is short enough for the host's enqueue to set a
    # 20-call reading's pace: the device's own time a call beside it
    for name in ("K6f32 ViT-B/32", "SDPA f32 ViT-B/32"):
        fn = forms[name]
        print(f"[time-f32] {card}: {name}: device {device_ms(fn, 20)} ms "
              f"a call, host enqueue {host_ms(fn, 20):.4f} ms a call")
    k3 = forms["K3f32"]
    body, rows = (kernel_ms(k3, key, 5) for key in ("attention_f32_kernel",
                                                    "quant_rows_kernel"))
    k1 = kernel_ms(lambda: fused_attention_qkv3(qkv, scale, heads),
                   "attention_f32_kernel", 5)
    print(f"[time-f32] {card}: K3f32 device time: body {body} ms, row pass "
          f"{rows} ms; K1f32's body on the same qkv {k1} ms")
    trace_f32(card)


# spans of a key tile in attention_f32.cu's trace (HIREST_F32_TRACE):
# name -> (from event, to event), in clock64() cycles of block 0's SM
F32_TRACE_SPANS = {
    "K split": (3, 4), "V^T stage wait": (5, 6), "V^T split": (6, 7),
    "consumer waits": (8, 9), "turn wait": (9, 10),
    "turn (PV, then scores issued)": (10, 11), "scores wait": (11, 12),
    "softmax": (12, 13), "p split": (13, 14)}


def trace_f32(card: str) -> None:
    """attention_f32.cu built with HIREST_F32_TRACE=1 at EVA-g's
    [128, 16, 257, 88] and the padded [128, 16, 257, 128]: each span of
    F32_TRACE_SPANS averaged over block 0's key tiles 5..39 (cycles), and
    the consumer's tile period."""
    import ctypes

    from hirest_tpu_torch.ops import attention

    defines = ("-DHIREST_F32_TRACE=1",)
    try:
        lib = attention._f32_lib(defines)
    except TypeError:  # a tree whose _f32_lib takes no variants
        lib = None
    if not hasattr(lib, "hirest_attention_f32_trace"):
        print(f"[time-f32] {card}: no trace in this tree")
        return
    lib.hirest_attention_f32_trace.argtypes = [ctypes.c_void_p]
    shipped = attention._f32_lib
    attention._f32_lib = lambda d=(): shipped(defines)
    try:
        for d in (88, 128):
            q, k, v = split_views(f32_inputs(BATCH, 268 + d, TOKENS, 16 * d))
            for _ in range(3):
                attention.fused_attention(q, k, v, d ** -0.5)
            torch.cuda.synchronize()
            buf = np.zeros((64, 19), dtype=np.int64)
            err = lib.hirest_attention_f32_trace(buf.ctypes.data)
            require(err == 0, f"attention_f32 trace read: CUDA error {err}")
            r = buf[5:40].astype(np.float64)
            spans = {}
            for name, (e0, e1) in F32_TRACE_SPANS.items():
                ok = (r[:, e0] > 0) & (r[:, e1] > 0)
                spans[name] = float(np.mean(r[ok, e1] - r[ok, e0]))
            ends = r[:, 14][r[:, 14] > 0]
            # an item's edges: its last PV and output, the next one's Q
            # wait, Q split and first tile
            last = np.nonzero(buf[:, 18] > 0)[0]
            first = np.nonzero(buf[:, 16] > 0)[0]
            first = first[first > last[0]] if len(last) else first
            edge = {"last PV": (14, 17), "output": (17, 18)}
            items = {n: float(np.mean([buf[i, e1] - buf[i, e0]
                                       for i in last]))
                     for n, (e0, e1) in edge.items()}
            items["next Q wait"] = float(np.mean(
                [buf[i, 16] - buf[i, 15] for i in first]))
            items["Q split"] = float(np.mean(
                [buf[i, 8] - buf[i, 16] for i in first]))
            items["first tile"] = float(np.mean(
                [buf[i, 14] - buf[i, 8] for i in first]))
            print(f"[time-f32] {card}: attention_f32 trace d={d}, cycles a "
                  f"key tile: " + ", ".join(f"{n} {c:.0f}"
                                            for n, c in spans.items())
                  + f"; consumer tile period {np.mean(np.diff(ends)):.0f}; "
                  f"an item's edges: " + ", ".join(
                      f"{n} {c:.0f}" for n, c in items.items()))
    finally:
        attention._f32_lib = shipped


def time_mlp(card: str) -> None:
    """K4 ms per call at B=128 beside its two products as torch._int_mm,
    and nothing else, through the wrapper that earlier versions of the
    port have too (see time_attention). Where the checkout splits K4 into
    two kernels, the first is also timed alone."""
    from hirest_tpu_torch.ops import build, quant

    build.build(("fused_mlp_int8",))
    m = BATCH * TOKENS
    args = mlp_inputs(m, seed=9)
    h_q, _, w1_q, _, _, w2_q, _, _, _ = args
    hidden_q = torch.randint(-127, 128, (m, w1_q.shape[0]), dtype=torch.int8,
                             device="cuda", generator=gen(10))
    ms = {"K4": cuda_ms(lambda: quant.fused_mlp_int8(*args), 20)}
    if hasattr(quant, "_mlp_hidden_launch"):
        ms["K4a mlp_hidden"] = cuda_ms(
            lambda: quant._mlp_hidden_launch(*args[:5], "gelu_poly"), 20)
    ms["_int_mm pair"] = cuda_ms(lambda: (torch._int_mm(h_q, w1_q.t()),
                                          torch._int_mm(hidden_q, w2_q.t())),
                                 20)
    print(f"[time-mlp] {card}: {REPO}: " + ", ".join(
        f"{name} {t:.4f} ms" for name, t in ms.items()))


def forward_fc1(cfg) -> tuple:
    """What act_quant is handed in the ladder's int8+fq+v3 forward: the
    fc1 outputs of a full-width forward at B=128 cut to 2 layers (seeded
    random weights), caught at eva_scan's act_quant. Returns (the inputs,
    the activation)."""
    from dataclasses import replace

    from hirest_tpu_torch.models import eva_scan
    from hirest_tpu_torch.utils.init import random_eva_vision_state_dict

    cut = replace(cfg, layers=2)
    fn = eva_scan.build_scanned_vision_apply(
        random_eva_vision_state_dict(cut, seed=0), cut, int8=True,
        fused_quant=True, attn_v3=True, device="cuda")
    caught, acts = [], set()
    shipped = eva_scan.act_quant

    def catch(h, *, act="none"):
        caught.append(h.clone())
        acts.add(act)
        return shipped(h, act=act)

    eva_scan.act_quant = catch
    try:
        fn(normalize_frames(np.random.default_rng(5).integers(
            0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)))
    finally:
        eva_scan.act_quant = shipped
    torch.cuda.synchronize()
    require(len(acts) == 1, f"act_quant under several activations {acts}")
    return caught, acts.pop()


def sass_functions(lib: Path) -> dict:
    """Each function's opcodes in the library's SASS (cuobjdump -sass),
    predicates dropped."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    funcs: dict = {}
    name = None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]+\*/", line):
            body = line.split("*/", 1)[1].strip()
            body = re.sub(r"^@!?U?P[T0-9]+\s+", "", body)
            if body:
                funcs[name].append(body.split()[0].rstrip(";"))
    return funcs


def hgmma_counts(lib: Path, kernel: str) -> None:
    """Prints, for each instantiation of `kernel` in the library's SASS,
    its tensor-core instructions (HGMMA, and of those the ones on TF32
    operands) beside its FFMAs: the products run on the tensor cores
    where the HGMMAs are there."""
    for fname, ops in sass_functions(lib).items():
        if kernel not in fname:
            continue
        hg = [op for op in ops if op.startswith("HGMMA")]
        kinds = sorted(set(hg))
        print(f"[sass] {fname}: {len(hg)} HGMMA, "
              f"{sum('TF32' in op for op in hg)} on TF32 "
              f"({', '.join(kinds)}), "
              f"{sum(op.startswith('FFMA') for op in ops)} FFMA, "
              f"{len(ops)} instructions")


def sass_counts(lib: Path, kernel: str) -> None:
    """Prints, for each instantiation of `kernel` in the library's SASS
    (cuobjdump -sass), the values a thread holds a row (from its template
    arguments: K5's <act, G, units[, width]> units x 16, or width / G built
    in; ln_kernel's <kQuant, width> width / 32, or 64) and its f32
    multiplies, adds, FMAs, min/max, conversions to int, reciprocals and
    loads a value: one GELU evaluation a value shows as ~11 FMULs a value."""
    import re

    funcs = sass_functions(lib)
    for fname, ops in funcs.items():
        if kernel not in fname:
            continue
        args = [int(a) for a in re.findall(r"Li(\d+)E", fname)]
        if kernel == "act_quant_kernel" and len(args) >= 3:
            values = args[2] * 16
            if len(args) > 3 and args[3]:
                values = min(values, args[3] // args[1])
        elif kernel == "act_quant_kernel":
            values = 32  # the row-per-block version's <act>: 8 vectors of 4
        else:
            values = args[0] // 32 if args and args[0] else 64
        base = [op.split(".")[0] for op in ops]
        count = {k: sum(op == k for op in base)
                 for k in ("FMUL", "FADD", "FFMA", "FMNMX", "F2I", "LDS",
                           "LDG")}
        count["MUFU.RCP"] = sum(op.startswith("MUFU.RCP") for op in ops)
        print(f"[sass] {fname} {args}: {values} values a thread, {len(ops)} "
              f"instructions; " + ", ".join(
                  f"{k} {n} ({n / values:.2f} a value)"
                  for k, n in count.items()))


def clocks_during(fn) -> tuple:
    """fn() while nvidia-smi samples the SM and memory clocks every 20 ms:
    (fn's result, "SM lo-hi MHz, memory lo-hi MHz over n samples" for the
    samples from fn's start until it returned)."""
    p = subprocess.Popen(["nvidia-smi", "-i", "0",
                          "--query-gpu=clocks.sm,clocks.mem",
                          "--format=csv,noheader,nounits", "-lms", "20"],
                         stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                         text=True)
    try:
        p.stdout.readline()  # sampling has begun
        result = fn()
    finally:
        p.terminate()
        text = p.communicate(timeout=30)[0]
    rows = [[int(v) for v in line.split(",")] for line in text.splitlines()
            if line.replace(",", "").replace(" ", "").isdigit()]
    if not rows:
        return result, "clocks not sampled"
    sm, mem = zip(*rows)
    return result, (f"SM {min(sm)}-{max(sm)} MHz, memory {min(mem)}-"
                    f"{max(mem)} MHz over {len(rows)} samples")


def device_ms(fn, n: int) -> float:
    """The device time of every kernel fn() launches, per call, over n
    calls, from torch.profiler; None where it recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / n / 1e3 if total else None


def kernel_ms(fn, key: str, n: int, before=None):
    """Mean device duration of the kernels whose name holds `key` over n
    calls of fn(), each after before() where given, from torch.profiler:
    the kernel's own time, without the gaps between launches; None where
    the profiler recorded no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and key in e.key:
            total += e.self_device_time_total
            count += e.count
    return total / count / 1e3 if count else None


def host_ms(fn, n: int) -> float:
    """The host's time a call to enqueue fn(), over n calls (fewer than the
    launch queue holds, so the card never holds the host back)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return t


def row_spread(x, g, b, card: str, others: dict) -> None:
    """Where K2's standalone time spreads. K2 on five fresh copies of x
    [M, 1408] (each at its own address): over 2000 calls back to back by
    CUDA events while nvidia-smi samples the clocks; the kernel's own
    device time over 200 such calls (kernel_ms) and the host's time a call
    (host_ms); and the kernel's own time over 50 calls each just after x
    was rewritten in place (its last rows still in L2, as in a forward,
    whose residual add writes x just before K2) and 50 just after the L2
    was flushed by a 256 MB write. Then the kernel's own time and the
    host's for each of `others` (name: (fn, kernel name key))."""
    from hirest_tpu_torch.ops import quant

    def fmt(t):
        return "not found" if t is None else f"{t:.4f} ms"

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    copies = []
    for r in range(5):
        xr = x.clone()
        copies.append(xr)  # kept, so that the next copy lies elsewhere

        def run():
            return quant.ln_quant(xr, g, b, EPS)

        ms, clocks = clocks_during(lambda: cuda_ms(run, 2000, 20))
        print(f"[time-rows] {card}: K2 on copy {r} of x "
              f"({xr.data_ptr():#x}): back to back {ms:.4f} ms ({clocks}), "
              f"the kernel's own "
              f"{fmt(kernel_ms(run, 'ln_kernel', 200))}, the host's "
              f"{host_ms(run, 200):.4f} ms a call; after x written "
              f"{fmt(kernel_ms(run, 'ln_kernel', 50, lambda: xr.mul_(1)))}"
              f", after the L2 flushed "
              f"{fmt(kernel_ms(run, 'ln_kernel', 50, flush.zero_))}")
    for name, (fn, key) in others.items():
        print(f"[time-rows] {card}: {name}: the kernel's own "
              f"{fmt(kernel_ms(fn, key, 200))}, the host's "
              f"{host_ms(fn, 200):.4f} ms a call")


def time_rows(cfg, card: str) -> None:
    """K2, K5 (gelu_bf16_poly at 6144, none at 1408) and K10 ms per call at
    B=128, beside F.layer_norm for K10 and a clone of K10's bytes, E4 at
    e4_cases' shapes beside its bound and K5 none, and K5
    on the fc1 outputs of an int8+fq+v3 forward, through the wrappers that
    every version of the port has (see time_attention); the kernels'
    ptxas registers where this call built them, and row_checks'
    differing counts, first; then where K2's time spreads and each row
    kernel's own device time (row_spread), and the SASS counts of both
    sources."""
    import torch.nn.functional as F

    from hirest_tpu_torch.ops import build, quant

    logs = build.build(("ln_quant", "act_quant"))
    ptxas_summary(logs.get("act_quant", ""), ("act_quant_kernel",))
    ptxas_summary(logs.get("ln_quant", ""), ("ln_kernel",))
    row_checks("time-rows")
    m, w, hid = BATCH * TOKENS, cfg.width, cfg.mlp_hidden
    x, g, b = ln_inputs(m, seed=8)
    x10, g10, b10 = ln_inputs(m, seed=17)
    h6, h1 = fc1_inputs(m, seed=15, c=hid), fc1_inputs(m, seed=16, c=w)
    # the short memory-bound calls first, 200 a time after 20 to warm up,
    # the GELU's heavy arithmetic last
    ms = {"K2": cuda_ms(lambda: quant.ln_quant(x, g, b, EPS), 200, 20),
          "K5 none": cuda_ms(lambda: quant.act_quant(h1), 200, 20),
          "K10": cuda_ms(lambda: quant.ln_bf16(x10, g10, b10, EPS), 200,
                         20),
          "F.layer_norm": cuda_ms(lambda: F.layer_norm(
              x10, (w,), g10.bfloat16(), b10.bfloat16(), EPS), 200, 20),
          # what the card's memory gives one PyTorch pass with K10's
          # traffic (bf16 in and out)
          "copy K10 bytes": cuda_ms(lambda: x10.clone(), 50),
          "K5 gelu_poly": cuda_ms(
              lambda: quant.act_quant(h6, act="gelu_poly"), 50, 5)}
    fc1, act = forward_fc1(cfg)
    for i, h in enumerate(fc1):
        ms[f"K5 {act} on layer {i}'s fc1"] = cuda_ms(
            lambda: quant.act_quant(h, act=act), 50)
    print(f"[time-rows] {card}: {REPO}: " + ", ".join(
        f"{name} {t:.4f} ms" for name, t in ms.items()))
    for name, r in e4_times(m, w, hid).items():
        print(f"[time-rows] {card}: E4 row_quant {name}: {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{r['bound_ms'] / r['ms']:.3f} of it), a clone of its rows "
              f"{r['reference_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; "
              f"K5 none at [M,{w}] {ms['K5 none']:.4f} ms")
    for what, h in [*((f"layer {i}'s fc1", h) for i, h in enumerate(fc1)),
                    ("the synthetic fc1", h6)]:
        y = quant._act(act, quant.QUANT_ACTS)(h.float())
        print(f"[time-rows] {what} {tuple(h.shape)}: |x| mean "
              f"{h.float().abs().mean().item():.4f}, max "
              f"{h.float().abs().max().item():.4f}; {act} gives y == 0 on "
              f"{(y == 0).float().mean().item():.6f} of it, |y| < 1e-3 on "
              f"{(y.abs() < 1e-3).float().mean().item():.6f}")
    row_spread(x, g, b, card, {
        "K10": (lambda: quant.ln_bf16(x10, g10, b10, EPS), "ln_kernel"),
        "K5 none": (lambda: quant.act_quant(h1), "act_quant_kernel"),
        "K5 gelu_poly": (lambda: quant.act_quant(h6, act="gelu_poly"),
                         "act_quant_kernel")})
    for name, kernel in (("act_quant", "act_quant_kernel"),
                         ("ln_quant", "ln_kernel")):
        sass_counts(build.library_path(name), kernel)


EPI_FORWARDS = 3  # timed forwards of B=128 a configuration, after a warm-up
# the forwards --time-epilogue times: staged tower (int8, dtype, padded
# heads) -> (tag, flags of build_scanned_vision_apply, KERNEL_GROUPS set)
EPI_TOWERS = (
    ((False, torch.bfloat16, False), (
        ("production bf16", dict(attn_v3=True), "bf16"),
        ("ladder bf16", {}, "ladder bf16"))),
    ((True, torch.bfloat16, False), (
        ("production int8", dict(int8=True, attn_v3=True, fused_quant=True,
                                 fused_mlp=True), "int8"),
        ("ladder int8 dyn", dict(int8=True), "ladder int8 K8"))),
    ((False, torch.bfloat16, True), (
        ("padded scanned", dict(attn_v3=True), "bf16"),)),
    ((False, torch.float32, False), (
        ("ladder bf16+v3+lnk in f32", dict(attn_v3=True, fused_ln=True),
         "ladder f32"),)),
)


def time_epilogue(cfg, card: str) -> None:
    """E1 and E2 at B=128 beside their plain chains, F.gelu on the same
    bytes and their bounds (epilogue_times), then each EPI_TOWERS forward
    at full width and depth on seeded weights: ms a forward and frames/s
    over EPI_FORWARDS, and one profiled forward's groups. Through what
    every version of the port has (build_scanned_vision_apply with the
    production flags is what make_eva_encoder and the factory build), so
    a checkout without ops/epilogue.py times its plain chains and its
    forwards, the kernels printed as missing."""
    from hirest_tpu_torch.models.eva_pad import pad_vision_head_params
    from hirest_tpu_torch.models.eva_scan import (build_scanned_vision_apply,
                                                  stage_scanned_params)
    from hirest_tpu_torch.ops import build
    from hirest_tpu_torch.utils.init import random_eva_vision_state_dict

    kernels = "epilogue" in build.SOURCES
    logs = build.build()  # every source at once, as the forwards need them
    if kernels:
        ptxas_summary(logs.get("epilogue", ""), ("bias_act_kernel",
                                                 "bias_residual_kernel"))
    else:
        print(f"[time-epilogue] {REPO}: E1 and E2 (ops/epilogue.py) are not "
              f"in this checkout: their plain chains alone")
    m = BATCH * TOKENS
    for name, r in epilogue_times(m, cfg.width, cfg.mlp_hidden,
                                  kernels).items():
        kernel = ("missing" if r["ms"] is None else
                  f"{r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.3f} of bound)")
        print(f"[time-epilogue] {card}: {REPO}: {name} B={BATCH}: kernel "
              f"{kernel}, plain chain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    t0 = time.perf_counter()
    sd = random_eva_vision_state_dict(cfg, seed=0)
    print(f"[time-epilogue] seeded weights drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    frames = normalize_frames(np.random.default_rng(5).integers(
        0, 256, (BATCH, 224, 224, 3), dtype=np.uint8))
    for (int8, dtype, padded), runs in EPI_TOWERS:
        psd, pcfg = pad_vision_head_params(sd, cfg) if padded else (sd, cfg)
        staged = stage_scanned_params(psd, pcfg, int8=int8, dtype=dtype,
                                      device="cuda")
        for tag, flags, groups in runs:
            fn = build_scanned_vision_apply(None, pcfg, staged=staged,
                                            dtype=dtype, device="cuda",
                                            **flags)
            fn(frames)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(EPI_FORWARDS):
                out = fn(frames)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            require(bool(out.isfinite().all()), f"{tag}: non-finite output")
            print(f"[time-epilogue] {card}: {REPO}: {tag}: "
                  f"{secs / EPI_FORWARDS * 1e3:.2f} ms a forward of {BATCH}, "
                  f"{BATCH * EPI_FORWARDS / secs:.2f} frames/s")
            profile_call(f"one {tag} forward B={BATCH}", lambda: fn(frames),
                         card, groups, tag="time-epilogue")
        del staged, fn, out
        torch.cuda.empty_cache()


def ptxas_summary(log: str, kernels) -> None:
    """Each named kernel's registers and spills from nvcc's ptxas -v log,
    and why ptxas serialized its wgmma instructions, where it did."""
    lines = log.splitlines()
    for name in kernels:
        at = [i for i, line in enumerate(lines)
              if "Compiling entry function" in line and name in line]
        for i in at:
            props = " ".join(line.split("info    :")[-1].strip()
                             for line in lines[i + 1:i + 4]
                             if "bytes stack" in line or "Used" in line)
            entry = lines[i].split("'")[1] if "'" in lines[i] else name
            serial = {line.split("serialized ")[-1].split(" for the")[0]
                      for line in lines
                      if "wgmma.mma_async instructions are serialized" in line
                      and entry in line}
            if serial:
                props += f"; wgmma serialized {', '.join(sorted(serial))}"
            print(f"[build] ptxas {entry}: {props}")


def main() -> int:
    if sys.argv[1:2] == ["--parallel-worker"]:
        parallel_worker(json.loads(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU only",
              file=sys.stderr)
        return 1
    from hirest_tpu_torch.config import EvaTextConfig, EvaVisionConfig
    from hirest_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    count_int_mm()
    card = gpu_name_and_power()
    cfg, text_cfg = EvaVisionConfig(), EvaTextConfig()
    pretrained = REPO / "pretrained_weights"

    timers = {"--time-attention": lambda: time_attention(cfg, card),
              "--time-mlp": lambda: time_mlp(card),
              "--time-rows": lambda: time_rows(cfg, card),
              "--time-f32": lambda: time_f32(cfg, card),
              "--time-epilogue": lambda: time_epilogue(cfg, card),
              "--time-int8-gemm": lambda: time_int8_gemm(cfg, card)}
    asked = [flag for flag in timers if flag in sys.argv[1:]]
    for flag in asked:
        timers[flag]()
    if asked:
        return 0
    from concurrent.futures import ThreadPoolExecutor

    from hirest_tpu_torch.ops.attention import QKV3_TWO_STEP

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        # K3's two-step epilogue, the cluster epilogue's yardstick
        two_step = pool.submit(build.build, ("attention_qkv3",), QKV3_TWO_STEP)
        logs = build.build()
        two_step.result()
    print(f"[build] {len(logs)} CUDA sources and the two-step attention_qkv3 "
          f"compiled in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"[build] {name}:\n{log.strip()}")
    from hirest_tpu_torch.ops.quant import mlp_int8_smem_bytes

    ptxas_summary(logs.get("fused_mlp_int8", ""),
                  ("fused_mlp_int8_hidden_kernel",
                   "fused_mlp_int8_out_kernel"))
    ptxas_summary(logs.get("attention_qkv3", ""), ("attention_qkv3_kernel",))
    ptxas_summary(logs.get("attention_f32", ""), ("attention_f32_kernel",))
    ptxas_summary(logs.get("act_quant", ""), ("act_quant_kernel",
                                              "act_quant_f32_kernel"))
    ptxas_summary(logs.get("ln_quant", ""), ("ln_kernel", "ln_f32_kernel"))
    ptxas_summary(logs.get("epilogue", ""), ("bias_act_kernel",
                                             "bias_residual_kernel"))
    ptxas_summary(logs.get("int8_epilogue", ""), ("dequant_kernel",
                                                  "row_quant_kernel"))
    ptxas_summary(logs.get("int8_gemm", ""), G1_KERNELS)
    print(f"[build] K4 dynamic shared memory a block: "
          f"{mlp_int8_smem_bytes()}")
    print_int8_gemm_info("build")

    if "--parallel-only" in sys.argv[1:]:
        phase_parallel(card)
        print(f"chip_smoke: parallel phase passed on {card}")
        return 0
    errs = phase_kernels(cfg)
    if "--kernels-only" in sys.argv[1:]:
        print(f"chip_smoke: build and kernels phases passed on {card}")
        return 0
    main_res = phase_main(cfg, pretrained)
    weights = factory_weights(cfg, text_cfg, pretrained)
    factory = phase_factory(cfg, text_cfg, weights)
    ladder = phase_ladder(cfg, weights)
    frames = phase_depth(cfg, pretrained)
    cpu_refs = phase_factory_depth(cfg, text_cfg, weights, frames)
    f32_launches = phase_f32_depth(cfg, text_cfg, weights, frames, cpu_refs)
    f32_ladder_cut = phase_f32_ladder_depth(cfg, weights, frames, cpu_refs)
    phase_ladder_depth(cfg, frames)
    f32_ladder = phase_f32_ladder(cfg, weights, card)
    int8_tower = phase_int8_tower(cfg, weights, factory)
    int8_tower_f32 = phase_int8_tower_depth(cfg, weights, frames)
    phase_int8_plain(main_res, ladder, int8_tower)
    timing, fps = phase_timing(cfg, main_res, factory, ladder, card)
    time_int8_tower(int8_tower, card)
    phase_profile(cfg, main_res, factory, ladder, card)
    phase_serving(main_res, card)
    phase_asr(main_res, card)
    phase_training(card)
    eval_launches = phase_eval(weights, card)
    phase_parallel(card)
    launches = {**ladder["launches"], **factory["launches"],
                **main_res["launches"]}
    for part in (int8_tower["launches"], int8_tower_f32, f32_launches,
                 f32_ladder_cut, f32_ladder, eval_launches):
        for k, n in part.items():
            launches[k] = launches.get(k, 0) + n
    # the bench's processes need the card's memory: free the towers
    del main_res, factory, ladder, int8_tower
    phase_bench(fps, card)

    print(card)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches.get(k, 0), "max_abs_err": errs[k],
        **{key: timing[k][key] for key in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms",
                                           "int_mm_ms", "int_mm_e3_ms")
           if key in timing[k]}}
        for k, (name, src, replaces) in SOURCES.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
